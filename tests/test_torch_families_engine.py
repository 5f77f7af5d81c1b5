"""The paged engine serving the MoE, SSM and hybrid families on the CPU
(every kernel entry runs its plain version): reduced mamba2-1.3b,
zamba2-1.2b and deepseek-moe-16b (f32) with the JAX parameters carried
across.

- The engine's greedy tokens and per-step logits against the reference's
  dense-cache `forward_chunk` (the reference's paged engine cannot run on
  this JAX for the families with attention: its Pallas kernel needs a TPU
  compiler parameter), teacher-forced on the engine's tokens: within
  1e-4 of max|logit|, correlation >= 0.999, the same greedy token. MoE
  runs the evaluate-every-expert oracle on both sides here (capacity
  drops depend on the chunk length).
- Chunked prefill equals prefill one token at a time (atol 1e-4 of
  max|logit|, the same tokens).
- Register slots: one per admitted sequence, scrubbed and returned at
  release (also through cancel and through preemption and replay, whose
  tokens equal a reserve run's); every non-scratch slot zero at the end.
- The MoE capacity dispatch serves end to end; the prefix cache and the
  host swap tier refuse register state with the reference's words; the
  launcher serves the three families (reduced, CPU).
- `RegisterAllocator` under random operation streams (hypothesis): the
  slots the reference's allocator hands out, and a failed operation
  leaves it unchanged.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.registry import get_config as jax_get_config
from repro.core.synthetic import inject_outlier_channels as jax_inject
from repro.models.transformer import build_model as jax_build
from repro.serve.engine import RegisterAllocator as JaxRegisterAllocator
from repro_torch import interop
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as cli
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import (SCRATCH_SLOT, EngineRequest,
                                      RegisterAllocator, SamplingParams,
                                      ServeEngine, as_servable)
from repro_torch.serve.step import BatchScheduler

FAMILIES = ["mamba2-1.3b", "zamba2-1.2b", "deepseek-moe-16b"]
FRAC = 1e-4
NEW = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module; the worker's
    own setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def carried(name):
    jcfg = jax_get_config(name).reduced()
    oracle = jcfg.uses_moe
    jm = jax_build(jcfg, moe_dense_oracle=oracle)
    p = jax_inject(jm.init(jax.random.PRNGKey(0)))
    tp = interop.tree_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    tm = build_model(get_config(name).reduced(), moe_dense_oracle=oracle)
    return jcfg, jm, p, tm, tp


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return carried(request.param)


def prompts(vocab, n, lo=5, hi=14, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def engine_for(tm, tp, **kw):
    args = dict(n_pages=4 * 3 + 1, page_size=8, max_seqs=2, prefill_chunk=4,
                record_logits=True)
    args.update(kw)
    return ServeEngine(as_servable(tm, tp, name="bf16"), **args)


def run_checked(engine):
    done = []
    while engine.queue or engine.active:
        done.extend(engine.step())
        engine.check_books()
    return {r.rid: r for r in done}


def serve(engine, ps, max_new=NEW):
    for rid, p in enumerate(ps):
        engine.submit(EngineRequest(rid=rid, prompt=p,
                                    sampling=SamplingParams(max_new=max_new)))
    return run_checked(engine)


def assert_slots_clean(engine):
    regs = engine.kv.registers
    assert regs is not None and regs.in_use == 0 and not engine.kv.slots
    for leaf in engine.kv._reg_leaves:
        assert float(leaf[:, SCRATCH_SLOT + 1:].abs().max()) == 0.0


def reference_logits(jm, p, prompt, generated):
    """The reference's dense-cache path over `prompt`, then decode steps fed
    the engine's tokens: the logits every sampled token came from."""
    cache = jm.init_cache(1, 32, dtype=jnp.float32)
    step = jax.jit(jm.forward_chunk)
    lg, cache = step(p, jnp.asarray([prompt], jnp.int32), cache,
                     jnp.asarray(0, jnp.int32))
    out = [np.asarray(lg[0, -1])]
    for i, tok in enumerate(generated[:-1]):
        lg, cache = step(p, jnp.asarray([[tok]], jnp.int32), cache,
                         jnp.asarray([len(prompt) + i], jnp.int32))
        out.append(np.asarray(lg[0, 0]))
    return out


def test_engine_matches_the_reference_dense_cache(family):
    jcfg, jm, p, tm, tp = family
    ps = prompts(jcfg.vocab, 3)
    engine = engine_for(tm, tp)
    done = serve(engine, ps)
    assert sorted(done) == [0, 1, 2]
    for rid, prompt in enumerate(ps):
        r = done[rid]
        assert r.outcome == "length" and len(r.step_logits) == NEW
        for tok, got, want in zip(r.generated, r.step_logits,
                                  reference_logits(jm, p, prompt,
                                                   r.generated)):
            assert np.abs(got - want).max() <= FRAC * np.abs(want).max()
            assert np.corrcoef(got, want)[0, 1] >= 0.999
            assert tok == int(np.argmax(want))
    if engine.spec.register:
        assert_slots_clean(engine)
        assert engine.kv.slots_scrubbed == 3


def test_chunked_prefill_equals_stepwise(family):
    jcfg, _, _, tm, tp = family
    ps = prompts(jcfg.vocab, 2, lo=9, hi=14, seed=2)
    chunked = serve(engine_for(tm, tp, prefill_chunk=8), ps)
    stepwise = serve(engine_for(tm, tp, prefill_chunk=1), ps)
    for rid in chunked:
        a, b = chunked[rid], stepwise[rid]
        assert a.generated == b.generated
        for x, y in zip(a.step_logits, b.step_logits):
            assert np.abs(x - y).max() <= FRAC * np.abs(y).max()


def test_register_slots_survive_cancel_and_replay():
    """zamba2 (register slots and kv pages): optimistic admission on a
    short pool preempts; the victim's slot is scrubbed with its pages and
    the replay re-prefills into a fresh slot - the tokens equal a reserve
    run's. A cancelled request's slot is scrubbed too."""
    jcfg, _, _, tm, tp = carried("zamba2-1.2b")
    ps = prompts(jcfg.vocab, 4, lo=9, hi=14, seed=3)
    base = serve(engine_for(tm, tp, n_pages=4 * 3 + 1, admission="reserve"),
                 ps, max_new=10)
    short = engine_for(tm, tp, n_pages=5, admission="optimistic",
                       headroom_pages=0)
    got = serve(short, ps, max_new=10)
    assert short.metrics.counter("engine.preemptions").value >= 1
    assert {r: got[r].generated for r in got} == \
        {r: base[r].generated for r in base}
    assert short.kv.slots_scrubbed >= len(ps) + 1
    assert_slots_clean(short)
    engine = engine_for(tm, tp)
    for rid, p in enumerate(ps[:2]):
        engine.submit(EngineRequest(rid=rid, prompt=p,
                                    sampling=SamplingParams(max_new=8)))
    engine.step()
    engine.step()
    assert len(engine.kv.slots) == 2
    assert engine.cancel(0).outcome == "cancelled"
    engine.check_books()
    assert len(engine.kv.slots) == 1 and engine.kv.slots_scrubbed == 1
    run_checked(engine)
    assert_slots_clean(engine)
    snap = engine.metrics_snapshot()
    assert snap["gauges"]["engine.register_slots.capacity"] == 2
    assert snap["gauges"]["engine.register_slots.in_use"] == 0
    assert snap["gauges"]["engine.register_slots.peak_in_use"] == 2


def test_moe_capacity_path_serves():
    """deepseek-moe with the capacity-bounded dispatch (the served default):
    every request ends `length`, the logits are finite, the books balance,
    and two engines give the same tokens (the combine is deterministic)."""
    cfg = get_config("deepseek-moe-16b").reduced()
    tp = carried("deepseek-moe-16b")[4]
    tm = build_model(cfg)
    ps = prompts(cfg.vocab, 3)
    a = serve(engine_for(tm, tp), ps)
    b = serve(engine_for(tm, tp), ps)
    for rid in a:
        assert a[rid].outcome == "length"
        assert all(np.isfinite(x).all() for x in a[rid].step_logits)
        assert a[rid].generated == b[rid].generated


@pytest.mark.parametrize("name", ["mamba2-1.3b", "zamba2-1.2b"])
def test_register_specs_refuse_prefix_cache_and_swap(name):
    _, _, _, tm, tp = carried(name)
    with pytest.raises(ValueError, match="SSM state is position-dependent"):
        engine_for(tm, tp, prefix_cache=True)
    with pytest.raises(ValueError, match="host swap tier cannot serve"):
        engine_for(tm, tp, swap_host_mb=1.0)
    with pytest.raises(ValueError, match="requires attention caches"):
        BatchScheduler(tm, tp, slots=2, max_len=32)
    engine = engine_for(tm, tp)
    # register-only state never grows: no implied context window
    cap = engine.kv.allocator.capacity * engine.kv.page_size
    assert engine.max_context == (None if name == "mamba2-1.3b" else cap)
    assert engine.kv.registers.capacity == engine.max_seqs


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_serves_the_families(arch, capsys):
    out = cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--requests", "3", "--max-new", "3"])
    done, engine = out["done"], out["engine"]
    assert len(done) == 3 and all(r.outcome == "length" for r in done)
    assert engine.adapter.name == "fake-quant"
    engine.check_books()
    text = capsys.readouterr().out
    assert "quantized" in text and "served 3 requests" in text


OPS = st.lists(st.tuples(st.integers(0, 5), st.integers(0, 4)),
               max_size=120)


@settings(max_examples=60, deadline=None)
@given(OPS)
def test_register_allocator_random_interleavings(ops):
    """Alloc / free / double-free / scratch-free streams on the port's and
    the reference's allocator side by side: the same slots, the invariants
    after every operation, and a failed operation changes nothing."""
    n_slots = 5
    alloc, ref = RegisterAllocator(n_slots), JaxRegisterAllocator(n_slots)
    held: dict[int, int] = {}
    next_rid = 0
    for kind, pick in ops:
        before = (list(alloc._free), alloc.peak_in_use)
        if kind in (0, 1):
            try:
                slot = alloc.alloc()
            except MemoryError:
                with pytest.raises(MemoryError):
                    ref.alloc()
                assert alloc.n_free == 0
                assert (list(alloc._free), alloc.peak_in_use) == before
            else:
                assert ref.alloc() == slot
                held[next_rid] = slot
                next_rid += 1
        elif kind in (2, 3) and held:
            rid = sorted(held)[pick % len(held)]
            slot = held.pop(rid)
            alloc.free(slot)
            ref.free(slot)
        elif kind == 4 and alloc.n_free:
            with pytest.raises(ValueError, match="double/invalid"):
                alloc.free(alloc._free[pick % alloc.n_free])
            assert (list(alloc._free), alloc.peak_in_use) == before
        elif kind == 5:
            with pytest.raises(ValueError, match="double/invalid"):
                alloc.free(SCRATCH_SLOT if pick % 2 else n_slots)
            assert (list(alloc._free), alloc.peak_in_use) == before
        assert alloc.n_free + alloc.in_use == alloc.capacity == n_slots - 1
        assert len(alloc._free) == len(set(alloc._free))
        assert SCRATCH_SLOT not in alloc._free
        assert not (set(held.values()) & set(alloc._free))
        assert alloc.peak_in_use == ref.peak_in_use >= alloc.in_use
    for rid in list(held):
        alloc.free(held.pop(rid))
    assert alloc.n_free == alloc.capacity


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_families_quantize_and_serve(name):
    """The families in bf16, as served at full size: the PTQ result casts
    every leaf to bf16 (the router too, which `_route` lifts back to f32,
    as the reference's type promotion does), and the fake-quant model
    prefills and decodes through the engine to finite logits."""
    from repro_torch.core import pipeline as TP
    cfg = get_config(name).reduced(param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 32)))
    res = TP.quantize_model(model, params, [{"tokens": tokens}],
                            TP.preset("perq_star"))
    if cfg.uses_moe:
        assert res.params["layers"]["moe"]["router"].dtype == torch.bfloat16
    engine = ServeEngine(as_servable(TP.build_quantized_model(model, res),
                                     res.params, name="fake-quant"),
                         n_pages=13, page_size=8, max_seqs=2, prefill_chunk=4,
                         record_logits=True)
    done = serve(engine, prompts(cfg.vocab, 2))
    assert all(r.outcome == "length" for r in done.values())
    assert all(np.isfinite(x).all() for r in done.values()
               for x in r.step_logits)
