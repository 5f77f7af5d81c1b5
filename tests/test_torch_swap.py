"""The port's host swap tier and its pool maintenance, on the CPU.

Cache level, mirroring `tests/test_swap.py`: page-granular round trips
through the host tier, byte for byte; residency transitions (device ->
host -> device); exclusivity (shared pages never move); failure atomicity;
the scrub/COW guards. Against the JAX package: `HostSwapPool`'s capacity
and page bytes for the same pools carried across the bridge, and the
dispatch tallies of scrub, COW and the swap transfers (`scrub_state`,
`cow_page_copy`, `swap_out`, `swap_in`, under the reference's path tag).

Engine level, on the port's integer path: a pool too small for the load
completes every request with tokens bit-identical to an unpressured
baseline, whichever recovery the pressure picks (swap, replay, or the cost
rule's mix); injected `SwapFault`s drive retry with backoff, then the
fallback to replay, then terminal failure; `drain()` finishes swapped
residents; the books (device pages, host slots, commitments) balance after
every step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.serve import quantized as jq
from repro.serve.engine.pages import PagedKVCache as JaxPagedKVCache
from repro_torch import interop
from repro_torch.configs.registry import get_config
from repro_torch.core.synthetic import inject_outlier_channels
from repro_torch.kernels import ops as kops
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import (EngineRequest, FaultPlan, HostSwapPool,
                                      PagedKVCache, SamplingParams,
                                      ServeEngine, as_servable)
from repro_torch.serve.quantized import QuantizedDenseLM, pack_dense_params
from repro_torch.serve.telemetry import validate_snapshot

MAX_NEW = 5
PROMPTS = [[3, 14, 15, 92, 6], [53, 58, 9], [7, 9, 3, 23, 84, 62, 43],
           [41, 5, 27, 18, 2, 88, 31, 7, 64]]
GEOM = dict(n_pages=33, page_size=4, max_seqs=2, prefill_chunk=4)
# genuinely undersized: 4 usable pages < two concurrent worst cases
PRESSURE = dict(n_pages=5, page_size=4, max_seqs=2, prefill_chunk=4,
                max_preemptions=10)


# ----------------------------------------------------------------------
# cache level
# ----------------------------------------------------------------------

def _pool(n_pages=8, page_size=4, nl=2, kh=2, dh=4):
    rng = np.random.default_rng(0)
    shape = (nl, n_pages, page_size, kh, dh)
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def make_cache(n_pages=8, page_size=4, **kw):
    pool = {k: torch.from_numpy(v)
            for k, v in _pool(n_pages, page_size, **kw).items()}
    return PagedKVCache(pool, n_pages, page_size)


def test_host_pool_capacity_and_freelist():
    cache = make_cache()
    assert cache.page_bytes == 2 * 2 * 4 * 2 * 4 * 4
    pool = HostSwapPool(cache.state["kv"], 5 * cache.page_bytes)
    assert pool.capacity == 5 and pool.n_free == 5 and pool.in_use == 0
    assert not pool.buf["k"].is_pinned()        # a CPU pool: plain memory
    assert tuple(pool.buf["k"].shape) == (5, 2, 4, 2, 4)   # slot-major
    slots = pool.take(3)
    assert len(set(slots)) == 3 and pool.in_use == 3
    with pytest.raises(MemoryError, match="host swap tier exhausted"):
        pool.take(3)
    assert pool.n_free == 2           # a refused take mutated nothing
    pool.release(slots[:2])
    assert pool.in_use == 1
    with pytest.raises(ValueError, match="double/invalid release"):
        pool.release([slots[0]])
    with pytest.raises(ValueError, match="double/invalid release"):
        pool.release([slots[2], slots[2]])
    assert pool.in_use == 1           # a refused release mutated nothing
    assert HostSwapPool(cache.state["kv"], 3).capacity == 0


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_host_pool_sizes_match_the_reference(kv_bits):
    """The same page pool - the JAX integer model's, carried across the
    bridge - gives the same page bytes and host capacity in both
    packages, for every page format and a few budgets."""
    jcfg = jax_get_config("llama3-1b").reduced()
    jpool = jq.QuantizedDenseLM(jcfg, block_size=16,
                                kv_bits=kv_bits).init_cache(9, 8)
    tpool = interop.cache_from_jax(jax.tree.map(np.asarray, jpool), "cpu")
    tcache = PagedKVCache(tpool, 9, 8)
    jcache = JaxPagedKVCache(jpool, 9, 8)
    assert tcache.page_bytes == jcache.page_bytes > 0
    for mb in (0.01, 0.5, 3.3):
        got = tcache.attach_host_pool(mb)
        want = jcache.attach_host_pool(mb)
        assert (got.page_bytes, got.capacity) == \
            (want.page_bytes, want.capacity)
        assert got.capacity == int(mb * 2 ** 20) // tcache.page_bytes


def _drive(cache, record):
    """One open/ensure/release/COW/swap sequence; returns the tallies."""
    record.reset_dispatch_counts()
    cache.attach_host_pool(1)
    cache.open(0)
    cache.ensure(0, 12)
    cache.open(1)
    cache.ensure(1, 5)
    cache.cow_copy(cache.tables[0][0], cache.tables[1][1])
    cache.swap_out(0)
    cache.release(1)
    cache.swap_in(0)
    cache.open(2)
    cache.ensure(2, 3)
    cache.release(0)
    cache.release(2)
    return record.dispatch_counts()


def test_dispatch_tallies_match_the_reference():
    """Scrub, COW and the swap transfers are tallied as the reference's
    `PagedKVCache` tallies them, under its path tag (`kernels_enabled()`),
    over the same sequence of operations - with the kernels enabled and
    inside `use_kernels(False)`."""
    for enabled in (True, False):
        with kops.use_kernels(enabled), jops.use_kernels(enabled):
            got = _drive(make_cache(), kops)
            want = _drive(JaxPagedKVCache(
                {k: jnp.asarray(v) for k, v in _pool().items()}, 8, 4), jops)
        assert got == want
        tag = "kernels" if enabled else "ref"
        assert got == {("scrub_state", tag): 4, ("cow_page_copy", tag): 1,
                       ("swap_out", tag): 1, ("swap_in", tag): 1}


def test_swap_roundtrip_bit_identical():
    cache = make_cache()
    cache.attach_host_pool(64)
    cache.open(0)
    cache.ensure(0, 12)               # 3 pages at page_size 4
    pages = list(cache.tables[0])
    before = {k: leaf[:, pages].clone() for k, leaf in cache.pool.items()}

    n, nbytes = cache.swap_out(0)
    assert (n, nbytes) == (3, 3 * cache.page_bytes)
    assert cache.residency(0) == ["host"] * 3
    assert cache.allocator.in_use == 0          # device copies freed
    assert cache.host_pool.in_use == 3
    assert cache.pages_swapped_out == 3
    assert not cache._inflight
    for leaf in cache.pool.values():
        assert float(leaf[:, pages].abs().sum()) == 0.0    # scrubbed
    with pytest.raises(ValueError, match="host-resident"):
        cache.block_table_array([0], 4)
    assert cache.swap_out(0) == (0, 0)          # nothing left to move

    cache.open(1)                               # reuses the freed pages
    cache.ensure(1, 12)
    for leaf in cache.pool.values():
        leaf[:, cache.tables[1]] = 7.0
    n, nbytes = cache.swap_in(0)
    assert (n, nbytes) == (3, 3 * cache.page_bytes)
    assert cache.residency(0) == ["device"] * 3
    assert cache.host_pool.in_use == 0 and not cache._inflight
    new_pages = list(cache.tables[0])
    for k, leaf in cache.pool.items():
        assert torch.equal(leaf[:, new_pages], before[k])
        assert float(leaf[:, cache.tables[1]].min()) == 7.0
    assert cache.swap_in(0) == (0, 0)
    cache.release(0)
    cache.release(1)
    assert cache.allocator.in_use == 0


def test_shared_pages_stay_device_resident():
    cache = make_cache()
    cache.attach_host_pool(64)
    cache.open(0)
    cache.ensure(0, 12)
    shared = cache.tables[0][0]
    cache.allocator.incref([shared])  # a radix-tree (or sibling) holder
    assert cache.swap_eligible_pages(0) == cache.tables[0][1:]
    n, _ = cache.swap_out(0)
    assert n == 2
    assert cache.residency(0) == ["device", "host", "host"]
    assert cache.tables[0][0] == shared
    cache.swap_in(0)
    assert cache.residency(0) == ["device"] * 3
    cache.deref([shared])
    cache.release(0)
    assert cache.allocator.in_use == 0 and cache.host_pool.in_use == 0


def test_swap_in_alloc_failure_mutates_nothing():
    cache = make_cache(n_pages=5)     # 4 usable pages
    cache.attach_host_pool(64)
    cache.open(0)
    cache.ensure(0, 12)               # 3 pages
    cache.swap_out(0)
    cache.open(1)
    cache.ensure(1, 16)               # the other sequence takes all 4
    with pytest.raises(MemoryError):
        cache.swap_in(0)
    assert cache.residency(0) == ["host"] * 3   # table untouched
    assert cache.host_pool.in_use == 3          # host slots retained
    assert cache.allocator.in_use == 4
    cache.release(1)
    cache.swap_in(0)                  # recovers once pages free up
    assert cache.residency(0) == ["device"] * 3
    cache.release(0)
    assert cache.host_pool.in_use == 0


def test_release_returns_host_slots():
    cache = make_cache()
    cache.attach_host_pool(64)
    cache.open(0)
    cache.ensure(0, 12)
    cache.swap_out(0)
    assert cache.host_pool.in_use == 3
    cache.release(0)
    assert 0 not in cache.tables
    assert cache.host_pool.in_use == 0 and cache.allocator.in_use == 0


def test_scrub_and_cow_guards():
    cache = make_cache()
    cache.attach_host_pool(64)
    cache.open(0)
    cache.ensure(0, 12)
    page = cache.tables[0][0]
    with pytest.raises(AssertionError, match="still-referenced"):
        cache.scrub([page])
    cache._inflight.add(page)
    try:
        with pytest.raises(AssertionError, match="in-flight"):
            cache.cow_copy(page, cache.tables[0][1])
    finally:
        cache._inflight.discard(page)
    cache.swap_out(0)
    with pytest.raises(AssertionError, match="unallocated"):
        cache.cow_copy(page, 7)


def test_cow_copy_copies_every_leaf_in_place():
    cache = make_cache()
    cache.open(0)
    cache.ensure(0, 8)
    src, dst = cache.tables[0]
    pool = {k: v.clone() for k, v in cache.pool.items()}
    cache.cow_copy(src, dst)
    for k, leaf in cache.pool.items():
        assert torch.equal(leaf[:, dst], pool[k][:, src])
        assert torch.equal(leaf[:, src], pool[k][:, src])
    cache.release(0)


# ----------------------------------------------------------------------
# engine
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    cfg = get_config("llama3-1b").reduced()
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    packed = pack_dense_params(
        inject_outlier_channels(build_model(cfg).init(gen)), cfg)
    return cfg, packed


def engine(served, **kw):
    cfg, packed = served
    qlm = QuantizedDenseLM(cfg, block_size=16, kv_bits=4)
    return ServeEngine(as_servable(qlm, packed), **kw)


def _submit_all(eng):
    for rid, p in enumerate(PROMPTS):
        eng.submit(EngineRequest(rid=rid, prompt=list(p),
                                 sampling=SamplingParams(max_new=MAX_NEW)))


def _run_checked(eng):
    done = []
    while eng.queue or eng.active:
        done.extend(eng.step())
        eng.check_books()
    return {r.rid: r for r in done}


def _assert_drained(eng):
    alloc = eng.kv.allocator
    assert alloc.in_use == 0 and alloc.n_free == alloc.capacity
    assert not eng.kv.tables
    assert not eng._committed and eng._committed_total == 0
    hp = eng.kv.host_pool
    assert hp is None or hp.in_use == 0
    eng.check_books()


def _counter(eng, name):
    return eng.metrics.counter(name).value


@pytest.fixture(scope="module")
def baseline(served):
    eng = engine(served, **GEOM)
    _submit_all(eng)
    done = _run_checked(eng)
    _assert_drained(eng)
    assert all(done[r].outcome == "length" for r in done)
    return {r: done[r].generated for r in done}


def test_swap_under_pressure_bit_identical(served, baseline):
    """Policy `always` on an undersized pool: victims swap out and back
    with zero replayed tokens, every request completes, and the tokens
    match the unpressured baseline bit for bit."""
    eng = engine(served, **PRESSURE, swap_host_mb=8, swap_policy="always")
    _submit_all(eng)
    done = _run_checked(eng)
    _assert_drained(eng)
    assert _counter(eng, "engine.swap.out") >= 1
    assert _counter(eng, "engine.swap.in") >= 1
    assert _counter(eng, "engine.swap.bytes") > 0
    assert _counter(eng, "engine.swap.fallbacks") == 0
    assert _counter(eng, "engine.replayed_prefill_tokens") == 0
    for rid, toks in baseline.items():
        assert done[rid].outcome == "length"
        assert done[rid].generated == toks, rid


def test_swap_policy_never_only_preempts(served, baseline):
    eng = engine(served, **PRESSURE, swap_host_mb=8, swap_policy="never")
    assert eng.kv.host_pool is None
    _submit_all(eng)
    done = _run_checked(eng)
    _assert_drained(eng)
    assert _counter(eng, "engine.preemptions") >= 1
    assert _counter(eng, "engine.swap.out") == 0
    assert _counter(eng, "engine.swap.in") == 0
    for rid, toks in baseline.items():
        assert done[rid].generated == toks, rid


@pytest.mark.parametrize("break_even,expect_swap", [
    (0.0, False),      # swap never pays: every eviction recomputes
    (1e9, True),       # swap always pays: every eviction offloads
])
def test_cost_policy_follows_break_even(served, baseline, break_even,
                                        expect_swap):
    eng = engine(served, **PRESSURE, swap_host_mb=8, swap_policy="cost",
                 swap_break_even_bytes_per_token=break_even)
    _submit_all(eng)
    done = _run_checked(eng)
    _assert_drained(eng)
    if expect_swap:
        assert _counter(eng, "engine.swap.out") >= 1
        assert _counter(eng, "engine.preemptions") == 0
    else:
        assert _counter(eng, "engine.swap.out") == 0
        assert _counter(eng, "engine.preemptions") >= 1
    for rid, toks in baseline.items():
        assert done[rid].generated == toks, rid


def _drive_until_swapped_out(eng):
    """Step until the first swap-out lands."""
    _submit_all(eng)
    done = []
    while _counter(eng, "engine.swap.out") == 0:
        assert eng.queue or eng.active, "run ended without any swap-out"
        done.extend(eng.step())
        eng.check_books()
    return done


def test_swap_in_faults_retry_with_backoff(served, baseline):
    eng = engine(served, **PRESSURE, swap_host_mb=8, swap_policy="always")
    done = _drive_until_swapped_out(eng)
    s = eng._step_index
    eng.faults = FaultPlan(swap_fail_steps=(s, s + 1))
    while eng.queue or eng.active:
        done.extend(eng.step())
        eng.check_books()
    done = {r.rid: r for r in done}
    _assert_drained(eng)
    assert _counter(eng, "engine.swap.retries") >= 1
    assert _counter(eng, "engine.swap.in") >= 1
    assert _counter(eng, "engine.swap.fallbacks") == 0
    assert _counter(eng, "engine.replayed_prefill_tokens") == 0
    for rid, toks in baseline.items():
        assert done[rid].generated == toks, rid


def test_swap_out_fault_degrades_to_preempt(served, baseline):
    eng = engine(served, **PRESSURE, swap_host_mb=8, swap_policy="always",
                 faults=FaultPlan(swap_fail_rate=1.0))
    _submit_all(eng)
    done = _run_checked(eng)
    _assert_drained(eng)
    assert _counter(eng, "engine.swap.fallbacks") >= 1
    assert _counter(eng, "engine.preemptions") >= 1
    for rid, toks in baseline.items():
        assert done[rid].generated == toks, rid


def test_swap_in_abandoned_fails_terminally(served, baseline):
    eng = engine(served, n_pages=5, page_size=4, max_seqs=2,
                 prefill_chunk=4, max_preemptions=0, swap_host_mb=8,
                 swap_policy="always", swap_max_retries=0)
    done = _drive_until_swapped_out(eng)
    s = eng._step_index
    eng.faults = FaultPlan(swap_fail_steps=tuple(range(s, s + 64)))
    while eng.queue or eng.active:
        done.extend(eng.step())
        eng.check_books()
    done = {r.rid: r for r in done}
    _assert_drained(eng)
    failed = [r for r in done.values() if r.outcome == "failed"]
    assert len(failed) == 1
    assert "swap-in abandoned" in failed[0].failed
    assert _counter(eng, "engine.swap.fallbacks") >= 1
    for rid, req in done.items():
        if req.outcome == "length":
            assert req.generated == baseline[rid], rid


def test_drain_with_swapped_resident(served, baseline):
    """drain() honours a swapped-out resident: it swaps back in and
    completes, never-admitted queue entries cancel, and both tiers come
    back empty."""
    eng = engine(served, **PRESSURE, swap_host_mb=8, swap_policy="always")
    done = _drive_until_swapped_out(eng)
    assert any(r.swapped for r in eng.queue)
    done.extend(eng.drain())
    done = {r.rid: r for r in done}
    _assert_drained(eng)
    assert len(done) == len(PROMPTS)
    for rid, req in done.items():
        if req.outcome == "length":
            assert req.generated == baseline[rid], rid
        else:
            assert req.outcome == "cancelled" and not req.generated
    with pytest.raises(RuntimeError, match="draining"):
        eng.submit(EngineRequest(rid=99, prompt=[1, 2],
                                 sampling=SamplingParams(max_new=1)))


def test_swap_with_prefix_cache(served):
    """Swap composes with the radix cache: shared (tree-held) pages stay
    on the device across a victim's swap, books balance every step, and
    the greedy tokens match a pressure-free prefix run."""
    system = list(range(40, 52))      # 3 full pages at page_size 4
    prompts = [system + p for p in PROMPTS]

    def run(**kw):
        eng = engine(served, page_size=4, max_seqs=2, prefill_chunk=4,
                     prefix_cache=True, headroom_pages=0,
                     max_preemptions=10, **kw)
        for rid, p in enumerate(prompts):
            eng.submit(EngineRequest(rid=rid, prompt=list(p),
                                     sampling=SamplingParams(max_new=12)))
        done = _run_checked(eng)
        return eng, {r: done[r].generated for r in done}

    _, base = run(n_pages=65)
    eng, got = run(n_pages=11, swap_host_mb=8, swap_policy="always")
    assert _counter(eng, "engine.swap.out") >= 1
    assert got == base
    eng.prefix_cache.clear()
    _assert_drained(eng)


@pytest.mark.chaos
@pytest.mark.parametrize("seed", range(5))
def test_chaos_with_swap_faults(served, baseline, seed):
    """Exhaustion + swap faults + lifecycle chaos: the books balance every
    step, both tiers drain empty, every request reaches exactly one
    terminal state, and completed survivors are bit-identical."""
    plan = FaultPlan(seed=seed, exhaust_rate=0.3, swap_fail_rate=0.3,
                     cancel_rate=0.2, dispatch_fail_rate=0.1)
    eng = engine(served, **GEOM, max_preemptions=10, swap_host_mb=8,
                 swap_policy="always", faults=plan)
    _submit_all(eng)
    done = _run_checked(eng)
    _assert_drained(eng)
    assert len(done) == len(PROMPTS)
    outcomes = {rid: done[rid].outcome for rid in done}
    assert all(o in ("length", "cancelled", "expired", "failed")
               for o in outcomes.values()), (seed, outcomes)
    assert sum(_counter(eng, f"engine.requests.{k}") for k in
               ("finished", "cancelled", "expired", "failed")) == len(PROMPTS)
    assert _counter(eng, "engine.swap.in") <= _counter(eng, "engine.swap.out")
    for rid, req in done.items():
        if req.outcome == "length":
            assert req.generated == baseline[rid], (seed, rid)


def test_swap_metrics_in_snapshot(served):
    """Swap counters and host-tier gauges are in the snapshot (and
    schema-valid) with and without a host pool."""
    eng = engine(served, **GEOM)
    _submit_all(eng)
    _run_checked(eng)
    snap = eng.metrics_snapshot()
    validate_snapshot(snap)
    assert snap["gauges"]["engine.swap.host_pages_capacity"] == 0

    eng = engine(served, **PRESSURE, swap_host_mb=8, swap_policy="always")
    _submit_all(eng)
    _run_checked(eng)
    snap = eng.metrics_snapshot()
    validate_snapshot(snap)
    c, g = snap["counters"], snap["gauges"]
    assert c["engine.swap.out"] >= 1 and c["engine.swap.in"] >= 1
    assert c["engine.swap.bytes"] > 0
    assert c["engine.swap.bytes"] % eng.kv.page_bytes == 0
    assert g["engine.swap.host_pages_capacity"] > 0
    assert g["engine.swap.host_budget_bytes"] == \
        g["engine.swap.host_pages_capacity"] * eng.kv.page_bytes
    assert g["engine.swap.host_pages"] == 0      # drained
