"""The port's paged engine on the CPU: allocator and page-table invariants,
and `ServeEngine` end to end on a reduced llama3-1b with the port's own
seeded weights (`device="cpu"`, so every kernel entry runs its plain
version)."""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.synthetic import inject_outlier_channels
from repro_torch.kernels import ops as kops
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import (SCRATCH_PAGE, SCRATCH_SLOT,
                                      DenseModelAdapter,
                                      EngineRequest,
                                      FaultPlan, IntegerModelAdapter,
                                      PageAllocator, PagedKVCache,
                                      RadixCache, SamplingParams,
                                      ServeEngine, as_servable,
                                      derive_state_spec, pages_for)
from repro_torch.serve.engine import scheduler as sched
from repro_torch.serve.quantized import QuantizedDenseLM, pack_dense_params
from repro_torch.serve.telemetry import QualityProbes

# logits bound of the model tests: 5e-3 of max|logit| (rounding ties of the
# activation quantiser between two summation orders)
FRAC = 5e-3


# -------------------- allocator / page tables --------------------

def test_allocator_refcounts_and_validation():
    a = PageAllocator(6)
    assert (a.capacity, a.n_free, a.in_use) == (5, 5, 0)
    p = a.alloc(3)
    assert SCRATCH_PAGE not in p and len(set(p)) == 3
    assert all(a.refcount(x) == 1 for x in p) and a.peak_in_use == 3
    a.incref(p[:1])
    assert a.refcount(p[0]) == 2 and a.n_shared == 1
    assert a.free(p) == p[1:]              # the shared page stays allocated
    assert a.refcount(p[0]) == 1 and a.in_use == 1
    with pytest.raises(MemoryError):
        a.alloc(5)
    assert a.n_free == 4                   # a refused alloc mutates nothing
    with pytest.raises(ValueError):
        a.free([p[1]])                     # double free
    with pytest.raises(ValueError):
        a.free([p[0], p[0]])               # duplicate inside one batch
    assert a.refcount(p[0]) == 1
    with pytest.raises(ValueError):
        a.free([SCRATCH_PAGE])
    with pytest.raises(ValueError):
        a.incref([p[1]])                   # not allocated
    assert a.free([p[0]]) == [p[0]]
    assert a.n_free + a.in_use == a.capacity == a.n_free
    a.reset_peak()
    assert a.peak_in_use == 0
    with pytest.raises(ValueError):
        PageAllocator(1)


def test_allocator_random_churn_keeps_books():
    rng = np.random.default_rng(0)
    a = PageAllocator(33)
    held = []
    for _ in range(400):
        if held and rng.random() < 0.45:
            grp = held.pop(int(rng.integers(len(held))))
            assert sorted(a.free(grp)) == sorted(grp)
        else:
            n = int(rng.integers(1, 6))
            if n <= a.n_free:
                held.append(a.alloc(n))
            else:
                with pytest.raises(MemoryError):
                    a.alloc(n)
        flat = [p for g in held for p in g]
        assert len(flat) == len(set(flat)) == a.in_use
        assert a.n_free + a.in_use == a.capacity


def _pool(n_pages=6, page=4):
    return {"k": torch.ones(2, n_pages, page, 1, 2),
            "v": torch.ones(2, n_pages, page, 1, 2)}


def test_paged_kv_cache_tables_and_scrub():
    kv = PagedKVCache(_pool(), 6, 4)
    assert kv.page_bytes == 2 * 2 * 4 * 2 * 4
    kv.open(7)
    with pytest.raises(ValueError):
        kv.open(7)
    kv.ensure(7, 5)
    assert len(kv.tables[7]) == pages_for(5, 4) == 2
    kv.ensure(7, 8)                                  # already covered
    assert len(kv.tables[7]) == 2
    assert kv.page_of(7, 6) == (kv.tables[7][1], 2)
    kv.open(9)
    kv.ensure(9, 1)
    bt = kv.block_table_array([7, None, 9], 4)
    assert bt.dtype == torch.int32 and tuple(bt.shape) == (3, 4)
    assert bt[0].tolist() == kv.tables[7] + [SCRATCH_PAGE] * 2
    assert bt[1].tolist() == [SCRATCH_PAGE] * 4
    assert bt[2].tolist() == kv.tables[9] + [SCRATCH_PAGE] * 3
    with pytest.raises(ValueError, match="only 1 columns"):
        kv.block_table_array([7], 1)                 # too narrow: never truncated
    pages = list(kv.tables[7])
    kv.release(7)
    assert 7 not in kv.tables and kv.pages_scrubbed == 2
    for leaf in kv.pool.values():
        assert float(leaf[:, pages].abs().sum()) == 0.0      # scrubbed
        assert float(leaf[:, kv.tables[9]].min()) == 1.0     # neighbours intact
    kv.tables[9].append(object())                    # a non-device entry
    with pytest.raises(ValueError, match="host-resident"):
        kv.block_table_array([9], 4)
    with pytest.raises(MemoryError):
        kv.open(1)
        kv.ensure(1, 4 * 6)
    # register state: a slot pool beside the pages, one slot per open
    # sequence (slot 0 is scratch), scrubbed with the sequence's pages
    reg = {"conv": torch.ones(2, 3, 5)}
    both = PagedKVCache({"kv": _pool(), "register": reg}, 6, 4, n_slots=3)
    both.open(1)
    both.ensure(1, 4)
    assert both.slots[1] != SCRATCH_SLOT and both.slot_bytes == 2 * 5 * 4
    assert both.register_index_array([None, 1]).tolist() == \
        [SCRATCH_SLOT, both.slots[1]]
    slot = both.slots[1]
    both.release(1)
    assert float(reg["conv"][:, slot].abs().sum()) == 0.0
    assert float(reg["conv"][:, SCRATCH_SLOT].min()) == 1.0
    assert both.slots_scrubbed == 1 and both.registers.in_use == 0


def test_state_spec_and_unported_paths_raise():
    assert derive_state_spec(get_config("llama3-1b")).prefix_shareable
    assert derive_state_spec(get_config("mamba2-1.3b")).register
    with pytest.raises(ValueError):
        derive_state_spec(get_config("hubert-xlarge"))
    cfg = get_config("llama3-1b").reduced()
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    model = build_model(cfg)
    adapter = as_servable(model, model.init(gen), name="bf16")
    assert isinstance(adapter, DenseModelAdapter)
    assert adapter.cache_dtype == torch.float32
    assert adapter.init_state(5, 4)["kv"]["k"].shape == (2, 5, 4, 2, 32)
    with pytest.raises(TypeError):
        as_servable(object(), {})
    # every decode-capable family builds now; the integer path stays dense
    moe = build_model(get_config("deepseek-moe-16b").reduced())
    assert "moe" in moe.init(gen)["layers"]
    with pytest.raises(ValueError):
        QuantizedDenseLM(get_config("mamba2-1.3b").reduced())


# -------------------- engine --------------------

@pytest.fixture(scope="module")
def served():
    cfg = get_config("llama3-1b").reduced()
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    packed = pack_dense_params(
        inject_outlier_channels(build_model(cfg).init(gen)), cfg)
    return cfg, packed


def make_engine(served, kv_bits=4, **kw):
    cfg, packed = served
    qlm = QuantizedDenseLM(cfg, block_size=16, kv_bits=kv_bits)
    adapter = as_servable(qlm, packed)
    assert isinstance(adapter, IntegerModelAdapter)
    args = dict(n_pages=3 * 4 + 1, page_size=8, max_seqs=3, prefill_chunk=4)
    args.update(kw)
    return qlm, ServeEngine(adapter, **args)


def prompts(cfg, n, lo=3, hi=14, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def run_checked(engine):
    done = []
    while engine.queue or engine.active:
        done.extend(engine.step())
        engine.check_books()
    return {r.rid: r for r in done}


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_engine_serves_and_matches_dense_stepwise_decode(served, kv_bits):
    """6 requests over 3 slots with chunked prefill. Every request ends
    `length`, the books balance at every step, the pool ends empty, and the
    engine's per-token logits agree with the port's own dense-cache stepwise
    decode teacher-forced on the same tokens; greedy tokens are equal
    wherever the dense path's top-2 gap exceeds the bound."""
    cfg, packed = served
    qlm, engine = make_engine(served, kv_bits, record_logits=True)
    ps = prompts(cfg, 6)
    kops.reset_dispatch_counts()
    for rid, p in enumerate(ps):
        engine.submit(EngineRequest(rid=rid, prompt=p,
                                    sampling=SamplingParams(max_new=5)))
    done = run_checked(engine)
    assert sorted(done) == list(range(6))
    alloc = engine.kv.allocator
    assert alloc.in_use == 0 and alloc.n_free == alloc.capacity
    assert not engine.kv.tables and engine._committed_total == 0
    assert engine.n_prefill_tokens == sum(len(p) for p in ps)
    assert engine.n_decode_tokens == 6 * 4
    snap = engine.metrics_snapshot()
    assert snap["counters"]["engine.requests.finished"] == 6
    assert snap["counters"]["kernels.dispatch.paged_attention.ref"] > 0
    assert snap["gauges"]["engine.pages.in_use"] == 0
    assert engine.pages_walked <= engine.pages_walked_dense
    for rid, p in enumerate(ps):
        r = done[rid]
        assert r.outcome == "length" and len(r.generated) == 5
        assert len(r.step_logits) == 5
        cache = qlm.init_cache(1, 32, device="cpu")
        logits, cache = qlm.prefill(packed, torch.tensor([p]), cache)
        want = [logits[0, -1]]
        for i, tok in enumerate(r.generated[:-1]):   # teacher-forced
            lg, cache = qlm.decode_step(packed, torch.tensor([[tok]]), cache,
                                        len(p) + i)
            want.append(lg[0])
        for tok, got, w in zip(r.generated, r.step_logits, want):
            w = w.float().numpy()
            bound = FRAC * np.abs(w).max()
            assert np.abs(got - w).max() <= bound
            top2 = np.sort(w)[-2:]
            if top2[1] - top2[0] > 2 * bound:
                assert tok == int(np.argmax(w))


def test_stop_sequences_end_generation(served):
    cfg, _ = served
    p = prompts(cfg, 1)[0]
    _, engine = make_engine(served)
    engine.submit(EngineRequest(rid=0, prompt=p,
                                sampling=SamplingParams(max_new=6)))
    full = run_checked(engine)[0].generated
    _, engine = make_engine(served)
    stop = tuple(full[1:3])
    engine.submit(EngineRequest(
        rid=0, prompt=p, sampling=SamplingParams(max_new=6, stop=(stop,))))
    r = run_checked(engine)[0]
    assert r.outcome == "stop" and r.stop_hit
    assert tuple(r.generated[-2:]) == stop and len(r.generated) <= 3
    assert engine.metrics.counter("engine.requests.stop_hits").value == 1
    assert engine.kv.allocator.in_use == 0


def test_submit_validation_and_unported_options(served):
    cfg, _ = served
    _, engine = make_engine(served, max_context=24)
    ok = SamplingParams(max_new=4)
    with pytest.raises(ValueError, match="empty prompt"):
        engine.submit(EngineRequest(rid=0, prompt=[]))
    with pytest.raises(ValueError, match="context window"):
        engine.submit(EngineRequest(rid=0, prompt=[1] * 30, sampling=ok))
    with pytest.raises(ValueError, match="top_p"):
        engine.submit(EngineRequest(rid=0, prompt=[1],
                                    sampling=SamplingParams(top_p=0.0)))
    with pytest.raises(ValueError, match="stop sequences"):
        engine.submit(EngineRequest(rid=0, prompt=[1],
                                    sampling=SamplingParams(stop=((),))))
    engine.submit(EngineRequest(rid=0, prompt=[1, 2], sampling=ok))
    with pytest.raises(ValueError, match="already queued"):
        engine.submit(EngineRequest(rid=0, prompt=[1, 2], sampling=ok))
    _, small = make_engine(served, n_pages=3, max_context=64)
    with pytest.raises(ValueError, match="pool capacity"):
        small.submit(EngineRequest(rid=1, prompt=[1] * 20, sampling=ok))
    # the options that were refused before the robustness slice: the
    # reference's defaults and lifecycle API
    assert engine.admission == "optimistic"      # the reference's default
    _, tight = make_engine(served, n_pages=3, headroom_pages=1)
    with pytest.raises(ValueError, match="headroom"):
        tight.submit(EngineRequest(rid=2, prompt=[1] * 9, sampling=ok))
    _, opts = make_engine(served, prefix_cache=True, prefix_cache_pages=3,
                          swap_host_mb=1.0, faults=FaultPlan(seed=1),
                          deadline_s=60.0)
    assert isinstance(opts.prefix_cache, RadixCache)
    assert opts.prefix_cache.max_pages == 3
    assert opts.kv.host_pool.capacity == 2 ** 20 // opts.kv.page_bytes
    assert opts.swap_policy == "cost"
    assert opts.kv.host_pool.in_use == 0
    _, never = make_engine(served, swap_host_mb=1.0, swap_policy="never")
    assert never.kv.host_pool is None and never.swap_policy == "never"
    for kw in (dict(admission="greedy"), dict(swap_policy="sometimes")):
        with pytest.raises(ValueError):
            make_engine(served, **kw)
    streamed = []
    opts.submit(EngineRequest(rid=5, prompt=[3, 4, 5], sampling=ok),
                on_token=lambda rid, tok: streamed.append((rid, tok)))
    assert opts.queue[0].deadline_s == 60.0      # the engine's default TTL
    assert engine.cancel(0).outcome == "cancelled"
    with pytest.raises(ValueError, match="not queued or active"):
        engine.cancel(0)
    done = opts.drain()
    assert [r.outcome for r in done] == ["cancelled"]    # never admitted
    assert not streamed
    with pytest.raises(RuntimeError, match="draining"):
        opts.submit(EngineRequest(rid=6, prompt=[1], sampling=ok))


def test_reserve_admission_blocks_until_pages_free(served):
    """Worst-case reservation: with room for two sequences' worst case only,
    the third waits in the queue although a slot is free, and is served
    after a release."""
    cfg, _ = served
    _, engine = make_engine(served, n_pages=2 * 2 + 1,    # 4 pages of 8 rows
                            admission="reserve")
    for rid in range(3):
        engine.submit(EngineRequest(rid=rid, prompt=[5 + rid] * 9,
                                    sampling=SamplingParams(max_new=4)))
    engine.step()
    engine.check_books()
    assert len(engine.active) == 2 and len(engine.queue) == 1
    assert engine._committed_total == 4
    assert engine.metrics.counter("engine.admission.blocked").value >= 1
    done = run_checked(engine)
    assert sorted(done) == [0, 1, 2]
    assert all(r.outcome == "length" for r in done.values())


def test_row_seed_and_sampler_are_row_local():
    u1 = sched._row_uniforms(3, [5, 9, 5], [7, 7, 8])
    u2 = sched._row_uniforms(3, [9, 5], [7, 7])
    assert u1[0] == u2[1] and u1[1] == u2[0] and u1[0] != u1[2]
    assert sched._row_uniforms(4, [5], [7])[0] != u1[0]
    assert 0.0 <= float(u1.min()) and float(u1.max()) < 1.0
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    temps = torch.tensor([0.0, 0.7, 1.3])
    ks = torch.tensor([0, 5, 0])
    ps = torch.tensor([1.0, 1.0, 0.5])
    u = torch.tensor([0.3, 0.6, 0.9], dtype=torch.float64)
    toks = sched._sample_tokens(u, logits, temps, ks, ps)
    assert int(toks[0]) == int(logits[0].argmax())
    assert int(toks[1]) in logits[1].topk(5).indices.tolist()
    # nucleus: the token lies in the smallest set reaching mass 0.5
    pr = torch.softmax(logits[2] / 1.3, -1)
    order = pr.argsort(descending=True)
    n_keep = int((pr[order].cumsum(0) - pr[order] < 0.5).sum())
    assert int(toks[2]) in order[:n_keep].tolist()
    # a row's token depends on its own logits and uniform only
    perm = [2, 0, 1]
    toks_p = sched._sample_tokens(u[perm], logits[perm], temps[perm],
                                  ks[perm], ps[perm])
    assert toks_p.tolist() == toks[perm].tolist()
    # the empirical distribution follows the softmax
    lg = torch.tensor([[0.0, 1.0, 2.0]]).repeat(4000, 1)
    uu = torch.from_numpy(rng.random(4000))
    draws = sched._sample_tokens(uu, lg, torch.ones(4000),
                                 torch.zeros(4000, dtype=torch.int64),
                                 torch.ones(4000), filtered=False)
    freq = np.bincount(draws.numpy(), minlength=3) / 4000
    np.testing.assert_allclose(freq, torch.softmax(lg[0], -1).numpy(), atol=0.03)


def test_sampled_tokens_do_not_depend_on_batching(served):
    """Sampling draws come from (seed, rid, position) only: the same
    requests give the same tokens served one at a time and three at a time,
    and another engine seed gives other tokens."""
    cfg, _ = served
    ps = prompts(cfg, 4, seed=3)

    def serve(slots, seed):
        _, engine = make_engine(served, max_seqs=slots, seed=seed)
        for rid, p in enumerate(ps):
            engine.submit(EngineRequest(
                rid=rid, prompt=p,
                sampling=SamplingParams(temperature=0.9, top_k=40, top_p=0.95,
                                        max_new=5)))
        done = run_checked(engine)
        return [done[r].generated for r in range(len(ps))]

    one, three = serve(1, 11), serve(3, 11)
    assert one == three
    assert serve(3, 12) != three


def test_nan_poisoned_row_fails_alone(served):
    cfg, packed = served
    ps = prompts(cfg, 3, seed=5)

    class Poisoned(IntegerModelAdapter):
        engine = None
        calls = 0

        def forward_chunk(self, params, tokens, cache, index, *a, **k):
            logits, cache = super().forward_chunk(params, tokens, cache,
                                                  index, *a, **k)
            rids = [r.rid for r in self.engine.decoding]
            if tokens.shape[1] == 1 and 1 in rids:
                self.calls += 1
                if self.calls == 2:     # rid 1's second decode step
                    logits[rids.index(1), 0, 7] = float("nan")
            return logits, cache

    def serve(adapter_cls):
        qlm = QuantizedDenseLM(cfg, block_size=16, kv_bits=4)
        adapter = adapter_cls(qlm, packed)
        engine = ServeEngine(adapter, n_pages=13, page_size=8, max_seqs=3,
                             prefill_chunk=16)
        adapter.engine = engine
        for rid, p in enumerate(ps):
            engine.submit(EngineRequest(rid=rid, prompt=p,
                                        sampling=SamplingParams(max_new=6)))
        return engine, run_checked(engine)

    _, clean = serve(IntegerModelAdapter)
    engine, done = serve(Poisoned)
    assert done[1].outcome == "failed" and "non-finite" in done[1].failed
    assert len(done[1].generated) < 6
    for rid in (0, 2):
        assert done[rid].outcome == "length"
        assert done[rid].generated == clean[rid].generated
    assert engine.metrics.counter("engine.requests.poisoned").value == 1
    assert engine.kv.allocator.in_use == 0 and not engine.kv.tables


# -------------------- the fused decode dispatch --------------------

def _serve_mixed(served, kv_bits, eager):
    """5 requests over 3 slots with pages of 4 rows, so occupancy changes
    and decode tables widen 1 -> 2 -> 4 columns; two rows sample (one
    filtered by top-k, one not) and every third decode dispatch is probed.
    Returns (engine, requests by rid, both tallies after the run)."""
    cfg, _ = served
    _, engine = make_engine(served, kv_bits, page_size=4, n_pages=3 * 5 + 1,
                            record_logits=True, seed=7, eager=eager,
                            quality_probes=QualityProbes(every_k=3))
    samplings = [SamplingParams(max_new=9),
                 SamplingParams(max_new=6, temperature=0.8, top_k=20),
                 SamplingParams(max_new=9),
                 SamplingParams(max_new=4, temperature=1.1),
                 SamplingParams(max_new=7)]
    kops.reset_dispatch_counts()
    kops.reset_kernel_launch_counts()
    rng = np.random.default_rng(4)
    for rid, (n, s) in enumerate(zip((2, 7, 3, 5, 8), samplings)):
        engine.submit(EngineRequest(
            rid=rid, prompt=rng.integers(0, cfg.vocab, n).tolist(),
            sampling=s))
    done = run_checked(engine)
    return engine, done, kops.count_snapshot()


@pytest.mark.parametrize("kv_bits", [None, 4])
def test_fused_decode_matches_the_direct_path(served, kv_bits):
    """The same engine, requests and seed dispatched through `_fused`'s
    static buffers and directly (`eager=True`): tokens, every step's
    logits and the probe stats equal bit for bit, and the kernel tallies
    equal, over changing occupancy, table widths, probed and sampled
    steps."""
    direct, want, want_counts = _serve_mixed(served, kv_bits, eager=True)
    fused, got, got_counts = _serve_mixed(served, kv_bits, eager=False)
    assert sorted(got) == sorted(want) == list(range(5))
    for rid in want:
        assert got[rid].generated == want[rid].generated
        assert len(got[rid].step_logits) == len(want[rid].step_logits)
        for g, w in zip(got[rid].step_logits, want[rid].step_logits):
            assert np.array_equal(g, w)
    assert got_counts == want_counts
    snap_d, snap_f = direct.metrics_snapshot(), fused.metrics_snapshot()
    for kind in ("histograms", "gauges"):
        quality = {k: v for k, v in snap_d[kind].items()
                   if k.startswith("quality.")}
        assert quality and quality == {k: snap_f[kind][k] for k in quality}
    assert snap_f["counters"]["quality.probe_dispatches"] > 1
    # one static-buffer call per variant met, none in the direct engine
    variants = {key[2] for key in fused._graphs}
    assert {v[0] for v in variants} == {1, 2, 4}            # n_cols
    assert {v[1] for v in variants} == {True, False}        # probe
    assert {v[2] for v in variants} == {True, False}        # samples
    assert {v[3] for v in variants} == {True, False}        # filtered
    assert all(key[:2] == ("decode", True) for key in fused._graphs)
    assert not direct._graphs
    assert fused.graph_stats() == {"graphs": 0, "capture_s": 0,
                                   "pool_bytes": 0}     # nothing captured


@pytest.mark.parametrize("change", ["n_cols", "probe", "samples", "filtered",
                                    "kernels_enabled"])
def test_fused_variant_cache(served, change):
    """`_fused` keeps one call per (phase, kernels_enabled(), variant): the
    same object for the same key, a new one when any part changes."""
    _, engine = make_engine(served)
    example = {"x": torch.zeros(2)}
    base = (1, False, False, False)       # (n_cols, probe, samples, filtered)
    call = engine._fused("decode", torch.neg, base, example)
    assert engine._fused("decode", torch.neg, base, example) is call
    if change == "kernels_enabled":
        with kops.use_kernels(False):
            other = engine._fused("decode", torch.neg, base, example)
            assert engine._fused("decode", torch.neg, base, example) is other
    else:
        i = ("n_cols", "probe", "samples", "filtered").index(change)
        variant = base[:i] + ((2 if i == 0 else True),) + base[i + 1:]
        other = engine._fused("decode", torch.neg, variant, example)
    assert other is not call
    assert engine._fused("decode", torch.neg, base, example) is call
    assert call.pool is None and other.pool is None     # the CPU: no capture
    assert len(engine._graphs) == 2


def test_sampler_reads_nothing_on_the_host():
    """The sampler runs on meta tensors, which refuse every read of a
    value on the host, so nothing in it stops a CUDA-graph capture; with
    no sampling row it gives the argmax, as the early exit it lost did."""
    rng = np.random.default_rng(2)
    lg = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    temps = torch.tensor([0.0, 0.7, 1.3])
    ks, ps = torch.tensor([0, 5, 0]), torch.tensor([1.0, 1.0, 0.5])
    u = torch.tensor([0.3, 0.6, 0.9], dtype=torch.float64)
    meta = [t.to("meta") for t in (lg, temps, ks, ps, u)]
    for filtered in (True, False):
        picked = sched._pick_tokens(*meta, samples=True, filtered=filtered)
        assert picked.shape == (2, 3) and picked.dtype == torch.float64
    toks = sched._sample_tokens(u, lg, torch.zeros(3), ks, ps)
    assert toks.tolist() == lg.argmax(-1).tolist()
    picked = sched._pick_tokens(lg, samples=False, filtered=False)
    assert picked[0].tolist() == lg.argmax(-1).double().tolist()
    assert torch.equal(picked[1], lg.amax(-1).double())
