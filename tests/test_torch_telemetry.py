"""The port's observed serving path on the CPU: rotation-quality probes,
request tracing and the metric schema, against the JAX package.

Inputs are made with numpy from a seed, or weights are drawn by the JAX
package and carried across. The JAX side runs as its own tests run it here:
the dense-cache `QuantizedDenseLM` with interpret-mode kernels, compiled as
the serving path compiles it. The port runs on `device="cpu"`, i.e. every
kernel entry takes its plain version. Each tolerance is stated beside its
assertion.
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core.synthetic import inject_outlier_channels as jax_inject
from repro.models.transformer import build_model
from repro.serve import quantized as jq
from repro.serve.telemetry import quality as jquality
from repro.serve.telemetry import schema as jschema
from repro.serve.telemetry import trace as jtrace
from repro_torch import interop
from repro_torch.configs.registry import get_config
from repro_torch.core.synthetic import inject_outlier_channels
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve as cli
from repro_torch.models.transformer import build_model as torch_model
from repro_torch.models.layers import layer_view
from repro_torch.serve import quantized as tq
from repro_torch.serve.engine import (EngineRequest, IntegerModelAdapter,
                                      SamplingParams, ServeEngine,
                                      as_servable)
from repro_torch.serve.telemetry import (PID_ENGINE, PID_REQUESTS,
                                         PROBE_STATS, SCHEMA_VERSION,
                                         QualityProbes, Tracer,
                                         activation_probe_stats, check,
                                         validate_snapshot, validate_trace)
from repro_torch.serve.telemetry import quality as tquality
from repro_torch.serve.telemetry import schema as tschema
from repro_torch.serve.telemetry.trace import profiler_session

PROMPTS = [[3, 14, 15, 92, 6], [53, 58, 9], [7, 9, 3, 23, 84, 62]]
MAX_NEW = 3


def N(t):
    return t.detach().to(torch.float32).cpu().numpy()


def both_validate_snapshot(snap):
    """The port's validator and the reference's accept the snapshot."""
    validate_snapshot(snap)
    jschema.validate_snapshot(snap)


def both_validate_trace(obj):
    n = validate_trace(obj)
    assert jtrace.validate_trace(obj) == n
    return n


# ----------------------------------------------------------------------
# the taxonomy and the trace format are the reference's
# ----------------------------------------------------------------------

def test_schema_and_trace_constants_are_the_reference_ones():
    assert SCHEMA_VERSION == jschema.SCHEMA_VERSION
    assert tschema.REQUIRED_COUNTERS == jschema.REQUIRED_COUNTERS
    assert tschema.REQUIRED_GAUGES == jschema.REQUIRED_GAUGES
    assert tschema.REQUIRED_HISTOGRAMS == jschema.REQUIRED_HISTOGRAMS
    assert [p.pattern for p in tschema.OPTIONAL_PATTERNS] \
        == [p.pattern for p in jschema.OPTIONAL_PATTERNS]
    assert PROBE_STATS == jquality.PROBE_STATS
    assert (PID_ENGINE, PID_REQUESTS) == (jtrace.PID_ENGINE,
                                          jtrace.PID_REQUESTS)


def test_tracer_emits_valid_chrome_trace(tmp_path):
    tr = Tracer()
    tr.begin("request", pid=2, tid=1)
    tr.begin("queued", pid=2, tid=1)
    tr.end("queued", pid=2, tid=1)
    tr.instant("alloc_pages", pid=2, tid=1, args={"pages": 2})
    tr.complete("dispatch.decode", tr.ts(), 12.5)
    with tr.span("decode", pid=2, tid=1):
        pass
    tr.end("request", pid=2, tid=1)
    n = both_validate_trace(tr.to_dict())
    assert n == len(tr.events)
    path = tmp_path / "t.json"
    tr.save(str(path))
    with open(path) as f:
        obj = json.load(f)                    # round-trips as plain JSON
    assert both_validate_trace(obj) == n
    evs = [e for e in obj["traceEvents"] if e["ph"] in "BE"]
    assert evs[0]["ts"] <= evs[-1]["ts"]


@pytest.mark.parametrize("events,msg", [
    ([{"name": "a", "ph": "E", "ts": 1.0, "pid": 1, "tid": 0}],
     "without an open"),
    ([{"name": "a", "ph": "B", "ts": 1.0, "pid": 1, "tid": 0},
      {"name": "b", "ph": "E", "ts": 2.0, "pid": 1, "tid": 0}],
     "must nest"),
    ([{"name": "a", "ph": "B", "ts": 1.0, "pid": 1, "tid": 0}],
     "unclosed"),
    ([{"name": "a", "ph": "X", "ts": 1.0, "dur": -5, "pid": 1, "tid": 0}],
     "invalid dur"),
    ([{"name": "a", "ph": "B", "ts": -1.0, "pid": 1, "tid": 0}],
     "invalid ts"),
    ([{"ph": "B", "ts": 1.0, "pid": 1, "tid": 0}], "missing 'name'"),
])
def test_validate_trace_rejects_malformed(events, msg):
    with pytest.raises(ValueError, match=msg):
        validate_trace({"traceEvents": events})


# ----------------------------------------------------------------------
# probe arithmetic
# ----------------------------------------------------------------------

def _probe_inputs(rng, shape, block_size):
    pre = (rng.standard_normal(shape) * 2).astype(np.float32)
    pre[..., ::7] *= 15.0                      # outlier channels
    post = (rng.standard_normal(shape) * 2).astype(np.float32)
    codes = rng.integers(0, 16, shape).astype(np.int8)
    codes[..., ::5] = 15                       # enough saturation to count
    return pre, post, codes


@pytest.mark.parametrize("shape,block_size", [((2, 3, 256), 16),
                                              ((4, 1, 384), 12),
                                              ((5, 128), 128)])
def test_activation_probe_stats_match_jax(shape, block_size):
    """The same numpy (pre, post, codes) through both functions. sat_rate is
    a count of integers over the element count: equal. The other four are
    f32 reductions summed in other orders: 1e-5 relative."""
    pre, post, codes = _probe_inputs(np.random.default_rng(len(shape)),
                                     shape, block_size)
    want = jax.jit(lambda a, b, c: jquality.activation_probe_stats(
        a, b, c, bits=4, block_size=block_size))(pre, post, codes)
    got = activation_probe_stats(torch.from_numpy(pre),
                                 torch.from_numpy(post),
                                 torch.from_numpy(codes), bits=4,
                                 block_size=block_size)
    assert set(got) == set(PROBE_STATS)
    assert float(got["sat_rate"]) == float(want["sat_rate"])
    for name in PROBE_STATS:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5)
        assert got[name].dtype == torch.float32 and got[name].dim() == 0
    assert float(got["l1_imbalance_pre"]) >= 1.0


def test_poisoned_activation_gives_poisoned_stats():
    """A NaN in the activation poisons the stats it enters, as in the
    reference, and raises nothing."""
    pre, post, codes = _probe_inputs(np.random.default_rng(9), (3, 64), 16)
    pre[1, 5] = np.nan
    got = activation_probe_stats(torch.from_numpy(pre),
                                 torch.from_numpy(post),
                                 torch.from_numpy(codes), bits=4,
                                 block_size=16)
    want = jquality.activation_probe_stats(pre, post, codes, bits=4,
                                           block_size=16)
    for name in PROBE_STATS:
        assert np.isnan(float(got[name])) == np.isnan(float(want[name]))
    assert np.isnan(float(got["kurtosis_pre"]))
    assert np.isfinite(float(got["kurtosis_post"]))


def test_quality_probes_sampling_and_record():
    with pytest.raises(ValueError):
        QualityProbes(every_k=0)
    probes = QualityProbes(every_k=3)
    assert [probes.should_probe() for _ in range(7)] == \
        [True, False, False, True, False, False, True]
    probes.reset()
    assert probes.should_probe()
    with pytest.raises(RuntimeError, match="bind"):
        probes.record({"sat_rate": torch.zeros(2)})
    from repro_torch.serve.telemetry import MetricsRegistry
    reg = MetricsRegistry()
    probes.bind(reg)
    probes.record({name: torch.tensor([1.5, 2.0]) for name in PROBE_STATS})
    snap = reg.snapshot()
    assert snap["counters"]["quality.probe_dispatches"] == 1
    for name in PROBE_STATS:
        assert snap["histograms"][f"quality.{name}"]["count"] == 2
        assert snap["gauges"][f"quality.layer01.{name}"] == 2.0


# ----------------------------------------------------------------------
# the probe site in the model, against the reference
# ----------------------------------------------------------------------

_REF = {}


def reference():
    """(jax cfg, packed params, the port's cfg and params) of the reduced
    llama3-1b, weights drawn by the JAX package."""
    if not _REF:
        cfg = jax_get_config("llama3-1b").reduced()
        params = jax_inject(build_model(cfg).init(jax.random.PRNGKey(0)))
        packed = jq.pack_dense_params(params, cfg)
        tp = interop.params_from_jax(jax.tree.map(np.asarray, packed), "cpu")
        _REF.update(cfg=cfg, packed=packed,
                    tcfg=get_config("llama3-1b").reduced(), tp=tp)
    return _REF


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("kv_bits", [None, 4])
def test_block_probe_stats_layer_by_layer(kv_bits):
    """Each layer's `_block(probe=True)` fed the reference's own input and
    cache (a 6-token prefill chunk, then a per-slot decode step): the block
    output keeps its bound of the plain forward, the four float stats agree
    within 1e-4 relative, and sat_rate within one code in the layer's
    element count - a code on a rounding tie may land on the grid's end on
    one side only."""
    r = reference()
    cfg, packed, tp = r["cfg"], r["packed"], r["tp"]
    jm = jq.QuantizedDenseLM(cfg, block_size=16, kv_bits=kv_bits)
    tm = tq.QuantizedDenseLM(r["tcfg"], block_size=16, kv_bits=kv_bits)
    jblock = jax.jit(lambda x, blk, cache, index:
                     jm._block(x, blk, cache, index, probe=True))
    b, s = 2, 6
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (b, s + 1))
    jcache = jm.init_cache(b, 16)
    phases = [(jnp.take(packed["embed"], jnp.asarray(tokens[:, :s]), axis=0),
               jnp.asarray(0, jnp.int32), 0),
              (jnp.take(packed["embed"], jnp.asarray(tokens[:, s:]), axis=0),
               jnp.asarray([s, s], jnp.int32),
               torch.tensor([s, s], dtype=torch.int32))]
    for x, jindex, tindex in phases:
        new_layers = []
        for l in range(cfg.n_layers):
            cache_l = jax.tree.map(lambda a: a[l], jcache)
            want_x, want_cache, want = jblock(
                x, jax.tree.map(lambda a: a[l], packed["layers"]), cache_l,
                jindex)
            got_x, _, got = tm._block(
                torch.from_numpy(np.array(x)), layer_view(tp["layers"], l),
                interop.cache_from_jax(jax.tree.map(np.asarray, cache_l),
                                       "cpu"), tindex, probe=True)
            w = np.asarray(want_x)
            assert np.abs(N(got_x) - w).max() <= 5e-3 * np.abs(w).max()
            numel = x.shape[0] * x.shape[1] * cfg.d_ff
            assert abs(float(got["sat_rate"]) - float(want["sat_rate"])) \
                <= 1.0 / numel + 1e-7
            for name in ("l1_imbalance_pre", "l1_imbalance_post",
                         "kurtosis_pre", "kurtosis_post"):
                assert _rel(float(got[name]), float(want[name])) <= 1e-4, name
            new_layers.append(want_cache)
        jcache = jax.tree.map(lambda *xs: jnp.stack(xs), *new_layers)


def test_forward_probe_stats_match_jax_whole_model():
    """Whole model, `forward_chunk(probe=True)` on an 8-token prefill of two
    rows: every layer's stats. The model is chaotic (an activation code on a
    rounding tie in an early layer changes everything after it), so the
    bound is looser than layer by layer: 1e-3 relative for the float
    stats, and sat_rate within 2 % of the element count."""
    r = reference()
    cfg, packed, tp = r["cfg"], r["packed"], r["tp"]
    jm = jq.QuantizedDenseLM(cfg, block_size=16, kv_bits=4)
    tm = tq.QuantizedDenseLM(r["tcfg"], block_size=16, kv_bits=4)
    toks = np.asarray([[3, 14, 15, 92, 6, 53, 58, 97],
                       [9, 323, 84, 62, 7, 9, 3, 23]]) % cfg.vocab
    jlogits, _, want = jm.forward_chunk(packed, jnp.asarray(toks, jnp.int32),
                                        jm.init_cache(2, 16), 0, probe=True)
    tlogits, _, got = tm.forward_chunk(tp, torch.from_numpy(toks),
                                       tm.init_cache(2, 16, device="cpu"), 0,
                                       probe=True)
    assert set(got) == set(PROBE_STATS)
    for name in PROBE_STATS:
        g, w = N(got[name]), np.asarray(want[name])
        assert g.shape == w.shape == (cfg.n_layers,)
        if name == "sat_rate":
            assert np.abs(g - w).max() <= 0.02
        else:
            assert (np.abs(g - w) <= 1e-3 * np.abs(w)).all(), (name, g, w)
    assert (N(got["l1_imbalance_post"]) >= 1.0).all()


@pytest.mark.parametrize("kv_bits", [None, 4])
def test_forward_probe_is_bit_path_neutral(kv_bits):
    """From the same cache (and the same page pool), `probe=True` gives
    logits and cache contents equal bit for bit to `probe=False`."""
    r = reference()
    tm = tq.QuantizedDenseLM(r["tcfg"], block_size=16, kv_bits=kv_bits)
    tp = r["tp"]
    toks = torch.tensor([[3, 14, 15, 92, 6, 53], [58, 97, 9, 32, 84, 62]])
    for paged in (False, True):
        if paged:
            cache = tm.init_cache(9, 4, device="cpu")
            bt = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0]], dtype=torch.int32)
            lens = torch.tensor([6, 6], dtype=torch.int32)
            rest = (bt, lens)
        else:
            cache = tm.init_cache(2, 16, device="cpu")
            rest = ()
        twin = {k: v.clone() for k, v in cache.items()}
        plain, cache = tm.forward_chunk(tp, toks, cache, 0, *rest)
        probed, twin, stats = tm.forward_chunk(tp, toks, twin, 0, *rest,
                                               probe=True)
        assert torch.equal(plain, probed)
        for k in cache:
            assert torch.equal(cache[k], twin[k])
        assert all(v.shape == (r["tcfg"].n_layers,) for v in stats.values())


# ----------------------------------------------------------------------
# the engine: schema, trace, neutrality
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    cfg = get_config("llama3-1b").reduced()
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    packed = tq.pack_dense_params(
        inject_outlier_channels(torch_model(cfg).init(gen)), cfg)
    return cfg, packed


def _engine(served, max_new=MAX_NEW, **kw):
    """An engine over the reduced model with PROMPTS submitted."""
    cfg, packed = served
    qlm = tq.QuantizedDenseLM(cfg, block_size=16, kv_bits=kw.pop("kv_bits", 4))
    kw.setdefault("n_pages", 33)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_seqs", 2)
    kw.setdefault("prefill_chunk", 4)
    eng = ServeEngine(as_servable(qlm, packed), record_logits=True, **kw)
    for rid, p in enumerate(PROMPTS):
        eng.submit(EngineRequest(rid=rid, prompt=list(p),
                                 sampling=SamplingParams(max_new=max_new)))
    return eng


def _run(served, **kw):
    eng = _engine(served, **kw)
    done = {r.rid: r for r in eng.run()}
    assert len(done) == len(PROMPTS)
    eng.check_books()
    return eng, done


def test_engine_snapshot_passes_the_reference_validator(served):
    """The port's snapshot carries the reference's whole taxonomy - before
    any traffic and after a run - and its kernel tallies under the
    reference's path tags: both validators accept it."""
    cfg, packed = served
    fresh = ServeEngine(as_servable(tq.QuantizedDenseLM(cfg, block_size=16),
                                    packed), n_pages=9, page_size=8)
    both_validate_snapshot(fresh.metrics_snapshot())
    kops.reset_dispatch_counts()
    eng, _ = _run(served)
    snap = eng.metrics_snapshot()
    both_validate_snapshot(snap)
    tallies = [k for k in snap["counters"] if k.startswith("kernels.")]
    # the kernel entries ran their plain versions on the CPU; the page
    # scrub carries the reference's path tag, kernels_enabled()
    kernel = [k for k in tallies if ".scrub_state." not in k]
    assert kernel and all(k.endswith(".ref") for k in kernel)
    assert snap["counters"]["kernels.dispatch.scrub_state.kernels"] > 0
    assert snap["counters"]["kernels.dispatch.int4_matmul.ref"] > 0
    for name in ("engine.preemptions", "engine.prefix.hits",
                 "engine.swap.out", "engine.requests.cancelled"):
        assert snap["counters"][name] == 0          # not ported: stays 0
    assert snap["gauges"]["engine.swap.host_budget_bytes"] == 0
    assert snap["gauges"]["engine.pages.shared"] == 0


def test_snapshot_schema_rejects_unknown_and_missing(served):
    eng, _ = _run(served)
    snap = eng.metrics_snapshot()
    for mutate, msg in (
            (lambda s: s["counters"].update({"engine.typo_metric": 1}),
             "unknown counter"),
            (lambda s: s["counters"].update(
                {"kernels.dispatch.int4_matmul.plain": 1}), "unknown counter"),
            (lambda s: s["histograms"].pop("engine.step.wall_s"),
             "missing histogram"),
            (lambda s: s["gauges"].pop("engine.pages.shared"),
             "missing gauge"),
            (lambda s: s.update(schema_version=SCHEMA_VERSION + 1),
             "schema_version")):
        bad = json.loads(json.dumps(snap))
        mutate(bad)
        with pytest.raises(ValueError, match=msg):
            validate_snapshot(bad)
    bad = json.loads(json.dumps(snap))
    bad["histograms"]["engine.step.wall_s"]["count"] += 1
    with pytest.raises(ValueError, match="inconsistent"):
        validate_snapshot(bad)


def test_engine_snapshot_and_trace_valid(served):
    cfg, _ = served
    tr = Tracer()
    probes = QualityProbes(every_k=2)
    eng, done = _run(served, tracer=tr, quality_probes=probes)
    snap = eng.metrics_snapshot()
    both_validate_snapshot(snap)
    both_validate_trace(tr.to_dict())
    c = snap["counters"]
    assert c["engine.requests.submitted"] == c["engine.requests.finished"] \
        == len(PROMPTS)
    assert c["engine.generated_tokens"] == len(PROMPTS) * MAX_NEW
    assert c["engine.prefill_tokens"] == sum(len(p) for p in PROMPTS)
    assert eng.n_steps == c["engine.steps"] > 0
    h = snap["histograms"]
    assert h["engine.step.wall_s"]["count"] == c["engine.steps"]
    assert all(r.t_first is not None for r in done.values())
    assert h["engine.decode.token_latency_s"]["count"] \
        == c["engine.generated_tokens"] - len(PROMPTS)
    evs = tr.to_dict()["traceEvents"]
    decodes = [e for e in evs if e["name"] == "dispatch.decode"]
    prefills = [e for e in evs if e["name"] == "dispatch.prefill"]
    assert decodes and prefills and all(e["ph"] == "X" for e in decodes)
    assert len(prefills) == h["engine.prefill.chunk_tokens"]["count"]
    assert len(decodes) == h["engine.decode.batch_occupancy"]["count"]
    # the first of every two decode dispatches ran the probe variant
    assert [e["args"]["probe"] for e in decodes] \
        == [i % 2 == 0 for i in range(len(decodes))]
    n_probed = c["quality.probe_dispatches"]
    assert n_probed == (len(decodes) + 1) // 2
    for stat in PROBE_STATS:
        assert h[f"quality.{stat}"]["count"] == n_probed * cfg.n_layers
        for layer in range(cfg.n_layers):
            assert f"quality.layer{layer:02d}.{stat}" in snap["gauges"]
    assert h["quality.l1_imbalance_post"]["min"] >= 1.0
    assert 0.0 <= h["quality.sat_rate"]["max"] <= 1.0
    # one lifecycle per request, each phase in order on its own track
    for rid, p in enumerate(PROMPTS):
        names = [(e["ph"], e["name"]) for e in evs
                 if e["pid"] == PID_REQUESTS and e["tid"] == rid]
        spans = [n for n in names if n[0] in "BE"]
        assert spans == [("B", "request"), ("B", "queued"), ("E", "queued"),
                         ("B", "prefill"), ("E", "prefill"), ("B", "decode"),
                         ("E", "decode"), ("E", "request")]
        assert ("i", "alloc_pages") in names


@pytest.mark.parametrize("kv_bits,session", [
    pytest.param(None, False, id="None"), pytest.param(4, False, id="4"),
    pytest.param(None, True, id="None-session"),
    pytest.param(4, True, id="4-session")])
def test_tracing_and_probes_are_bit_path_neutral(served, kv_bits, session):
    """Same tokens AND bit-identical recorded logits with probes every
    second decode dispatch and a tracer, or no tracer under a recording
    `torch.profiler` session, as with neither."""
    _, plain = _run(served, kv_bits=kv_bits)
    probes = QualityProbes(every_k=2)
    if session:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            eng, probed = _run(served, kv_bits=kv_bits,
                               quality_probes=probes)
        assert any(e["name"] == "dispatch.decode"
                   for e in profiler_session().events)
    else:
        eng, probed = _run(served, kv_bits=kv_bits, tracer=Tracer(),
                           quality_probes=probes)
    assert eng.metrics.counter("quality.probe_dispatches").value > 0
    for rid in plain:
        assert probed[rid].generated == plain[rid].generated
        assert len(probed[rid].step_logits) == MAX_NEW
        for a, b in zip(probed[rid].step_logits, plain[rid].step_logits):
            assert np.array_equal(a, b)


PHASES = ("engine.admit", "engine.grow", "engine.decode.inputs",
          "engine.decode.copy", "dispatch.decode", "engine.decode.wait",
          "engine.decode.commit",
          "engine.prefill.inputs", "dispatch.prefill", "engine.prefill.wait",
          "engine.prefill.commit", "engine.account", "engine.flush")


class FakeTimingEvent:
    """`torch.cuda.Event(enable_timing=True)` on the host clock, so the
    card's timing path runs on the CPU."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeTimingEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _refuse(*args, **kwargs):
    raise AssertionError("the device was synchronised or timed")


def test_phase_spans_nest_in_their_step(served, monkeypatch):
    """A traced run: both validators accept the trace; every engine-track
    span carries its step, lies inside that step's `engine.step` span, and
    the phases of a step sum to no more than the step. With timing events
    (here on the host clock) each decode dispatch carries
    `device_wall_ms`, and nothing synchronises."""
    monkeypatch.setattr(torch.cuda, "Event", FakeTimingEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    FakeTimingEvent.made = 0
    tr = Tracer()
    eng = _engine(served, tracer=tr)
    eng._device_events = True            # as on a card
    done = {r.rid: r for r in eng.run()}
    obj = tr.to_dict()
    both_validate_trace(obj)
    assert obj["otherData"]["unix_ns_at_zero"] == tr.unix_ns_at_zero
    assert abs(tr.unix_ns_at_zero - time.time_ns()) < 60e9
    spans = [e for e in obj["traceEvents"]
             if e["pid"] == PID_ENGINE and e["ph"] == "X"]
    steps = {e["args"]["step"]: e for e in spans if e["name"] == "engine.step"}
    assert sorted(steps) == list(range(eng.n_steps))
    children = [e for e in spans if e["name"] != "engine.step"]
    assert {e["name"] for e in children} == set(PHASES)
    total = dict.fromkeys(steps, 0.0)
    for e in children:
        st = steps[e["args"]["step"]]
        assert st["ts"] <= e["ts"] + 1e-6
        assert e["ts"] + e["dur"] <= st["ts"] + st["dur"] + 1e-6
        total[e["args"]["step"]] += e["dur"]
    for k, st in steps.items():
        assert total[k] <= st["dur"] + 1e-6
        names = [e["name"] for e in children if e["args"]["step"] == k]
        for once in ("engine.admit", "engine.account", "engine.flush"):
            assert names.count(once) == 1
        assert names.count("dispatch.prefill") == st["args"]["chunks"]
        assert names.count("dispatch.decode") == (st["args"]["decode_rows"]
                                                  > 0)
    decodes = [e for e in children if e["name"] == "dispatch.decode"]
    assert decodes and all(e["args"]["device_wall_ms"] >= 0 for e in decodes)
    assert not [e for e in children if e["name"] == "dispatch.prefill"
                and "device_wall_ms" in e["args"]]
    assert FakeTimingEvent.made == 2      # one pair, made once
    prefills = [e for e in children if e["name"] == "dispatch.prefill"]
    assert sum(e["args"]["tokens"] for e in prefills) \
        == sum(st["args"]["prefill_tokens"] for st in steps.values()) \
        == sum(len(p) for p in PROMPTS)
    assert sum(e["args"]["tokens"] for e in children
               if e["name"] == "engine.flush") == len(PROMPTS) * MAX_NEW
    # a first token a request, stamped at delivery
    for rid, req in done.items():
        firsts = [e for e in obj["traceEvents"] if e["pid"] == PID_REQUESTS
                  and e["tid"] == rid and e["name"] == "first_token"]
        assert len(firsts) == 1
        assert req.t_submit < req.t_first <= req.t_delivered


def test_session_spans_sit_on_the_profilers_clock(served):
    """Under a CPU `torch.profiler` session an engine without a tracer
    records its steps into the session's tracer; each `engine.step`,
    placed by `unix_ns_at_zero`, covers the caller's `record_function`
    range around the step within 1 ms at both ends. Request lifecycles
    stay out of a session; outside one nothing is recorded, and the next
    session starts a tracer of its own."""
    from torch.profiler import ProfilerActivity, profile, record_function
    eng = _engine(served, max_new=8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a session's first range pays the profiler's start-up (~1 ms on
        # the CPU) between its stamp and its body
        with record_function("warm-up"):
            pass
        for i in range(3):
            with record_function(f"pb.step.{i}"):
                eng.step()
    tr = profiler_session()
    marks = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("pb.step.")}
    steps = sorted((e for e in tr.events if e["name"] == "engine.step"),
                   key=lambda e: e["ts"])
    assert len(steps) == len(marks) == 3
    for i, e in enumerate(steps):
        a, b = marks[f"pb.step.{i}"]
        s0 = tr.unix_ns_at_zero + e["ts"] * 1e3
        s1 = s0 + e["dur"] * 1e3
        assert abs(s0 - a) < 1e6 and abs(s1 - b) < 1e6, (i, s0 - a, s1 - b)
    both_validate_trace(tr.to_dict())
    assert not [e for e in tr.events
                if e["pid"] == PID_REQUESTS and e["ph"] != "M"]
    n = len(tr.events)
    eng.step()
    assert profiler_session() is tr and len(tr.events) == n
    with profile(activities=[ProfilerActivity.CPU]):
        eng.step()
    second = profiler_session()
    assert second is not tr
    assert [e["args"]["step"] for e in second.events
            if e["name"] == "engine.step"] == [4]
    assert eng.queue or eng.active


def test_untraced_steps_record_and_synchronise_nothing(served, monkeypatch):
    """With no tracer and no profiler session a step makes no timing
    event, calls no synchronise and records no span, even where the
    engine would time its dispatches on a card."""
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    before = profiler_session()
    n = len(before.events) if before is not None else 0
    eng = _engine(served)
    eng._device_events = True
    assert len(eng.run()) == len(PROMPTS)
    assert profiler_session() is before
    assert before is None or len(before.events) == n


def test_probes_rejected_without_the_capability(served):
    cfg, packed = served

    class NoProbes(IntegerModelAdapter):
        supports_quality_probes = False

    adapter = NoProbes(tq.QuantizedDenseLM(cfg, block_size=16), packed)
    with pytest.raises(ValueError, match="quality probes"):
        ServeEngine(adapter, n_pages=9, page_size=8,
                    quality_probes=QualityProbes())
    ServeEngine(adapter, n_pages=9, page_size=8, tracer=Tracer())


def test_reset_metrics_gives_fresh_window(served):
    """A second run on the same engine does not accumulate counters across
    runs once reset_metrics() marks the window boundary; the zero window is
    schema-complete and the probe phase restarts."""
    probes = QualityProbes(every_k=2)
    eng, _ = _run(served, quality_probes=probes)
    first = eng.metrics_snapshot()["counters"]
    eng.reset_metrics()
    zero = eng.metrics_snapshot()
    both_validate_snapshot(zero)
    assert zero["counters"]["engine.steps"] == 0
    assert zero["counters"]["quality.probe_dispatches"] == 0
    assert zero["gauges"]["engine.pages.peak_in_use"] == 0
    assert zero["gauges"]["engine.pages.scrubbed"] == 0
    assert not kops.dispatch_counts()
    for rid, p in enumerate(PROMPTS):
        eng.submit(EngineRequest(rid=100 + rid, prompt=list(p),
                                 sampling=SamplingParams(max_new=MAX_NEW)))
    eng.run()
    second = eng.metrics_snapshot()["counters"]
    for name in ("engine.steps", "engine.prefill_tokens",
                 "engine.decode_tokens", "engine.generated_tokens",
                 "engine.pages_walked", "engine.requests.finished",
                 "quality.probe_dispatches"):
        assert second[name] == first[name], name


# ----------------------------------------------------------------------
# the launcher and the check CLI
# ----------------------------------------------------------------------

LAUNCH = ["--arch", "llama3-1b", "--reduced", "--integer-path",
          "--preset", "rtn_only", "--device", "cpu", "--block-size", "16",
          "--kv-bits", "4", "--requests", "4",
          "--max-new", "4", "--slots", "2", "--prompt-len", "5-20",
          "--prefill-chunk", "8", "--page-size", "8"]


def test_launcher_probes_and_traces(tmp_path, capsys):
    """`--probe-every 2 --trace t --metrics-json m` serves, prints the
    quality line, writes artifacts both check CLIs accept, and generates the
    tokens of the same run without the flags."""
    t, m = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    observed = cli.main(LAUNCH + ["--probe-every", "2", "--trace", t,
                                  "--metrics-json", m])
    out = capsys.readouterr().out
    assert "quality: post-rotation l1 imbalance p50" in out
    assert "probed dispatches)" in out and f"trace (" in out
    assert "| TTFT p50 " in out and "TTFT p50 n/a" not in out
    plain = cli.main(LAUNCH)
    capsys.readouterr()
    assert [r.generated for r in observed["done"]] \
        == [r.generated for r in plain["done"]]
    assert check.main([m, "--trace", t]) == 0
    from repro.serve.telemetry import check as jcheck
    assert jcheck.main([m, "--trace", t]) == 0
    assert "ok" in capsys.readouterr().out
    with open(m) as f:
        snap = json.load(f)
    assert snap["counters"]["quality.probe_dispatches"] > 0


def test_check_cli_fails_on_bad_artifacts(tmp_path, capsys):
    eng, _ = _run(served_cpu())
    snap = eng.metrics_snapshot()
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    good.write_text(json.dumps(snap))
    del snap["counters"]["engine.swap.out"]
    bad.write_text(json.dumps(snap))
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"name": "a", "ph": "B", "ts": 1.0, "pid": 1, "tid": 0}]}))
    assert check.main([str(good)]) == 0
    assert check.main([str(bad)]) == 1
    assert check.main([str(good), "--trace", str(trace)]) == 1
    err = capsys.readouterr().err
    assert "missing counter 'engine.swap.out'" in err and "unclosed" in err


def served_cpu():
    cfg = get_config("llama3-1b").reduced(n_layers=1)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    return cfg, tq.pack_dense_params(torch_model(cfg).init(gen), cfg)


def test_launcher_probe_every_needs_the_integer_path():
    with pytest.raises(SystemExit, match="needs --integer-path"):
        cli.main(["--arch", "llama3-1b", "--reduced", "--device", "cpu",
                  "--probe-every", "2"])
    with pytest.raises(ValueError, match="every_k"):
        cli.main(LAUNCH + ["--probe-every", "-1"])
