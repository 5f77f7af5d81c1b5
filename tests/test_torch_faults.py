"""Chaos tests of the port's engine: its robustness invariants under
injected faults, on the CPU.

`FaultPlan` is held against the JAX package's (the same arguments give the
same decision at every step). The engine tests mirror
`tests/test_faults.py` one for one, on the port's integer path (the
reduced llama3-1b with seeded weights and int4 KV pages), and assert the
same invariants:

  * no page leaks after any interleaving - the free list covers the
    capacity again once every request reaches a terminal state;
  * the allocator and commitment books balance after every step
    (`ServeEngine.check_books`);
  * survivors are bit-identical to an undisturbed run - preemption,
    replays, cancels, expiries and dispatch faults of other requests never
    change a request's tokens (sampling draws from `(seed, rid,
    position)`, decode rows are independent and padded to `max_seqs`);
  * a preempted-and-replayed request reproduces the continuation it would
    have produced without the preemption.

The baseline and the faulted runs share the engine geometry, so every
dispatch has the same shapes.
"""
import numpy as np
import pytest
import torch

from repro.serve.engine.faults import FaultPlan as JaxFaultPlan
from repro_torch.configs.registry import get_config
from repro_torch.core.synthetic import inject_outlier_channels
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import (DispatchFault, EngineRequest,
                                      EngineStalledError, FaultPlan,
                                      HostPageRef, SamplingParams,
                                      ServeEngine, SwapFault, as_servable)
from repro_torch.serve.quantized import QuantizedDenseLM, pack_dense_params

pytestmark = pytest.mark.chaos

MAX_NEW = 5
PROMPTS = [[3, 14, 15, 92, 6], [53, 58, 9], [7, 9, 3, 23, 84, 62, 43],
           [41, 5, 27, 18, 2, 88, 31, 7, 64]]
GEOM = dict(n_pages=33, page_size=4, max_seqs=2, prefill_chunk=4)


# ----------------------------------------------------------------------
# FaultPlan against the JAX package
# ----------------------------------------------------------------------

PLANS = [
    dict(seed=3, exhaust_rate=0.4, cancel_rate=0.2),
    dict(seed=0, exhaust_rate=0.3, cancel_rate=0.25, expire_rate=0.15,
         dispatch_fail_rate=0.1, swap_fail_rate=0.3),
    dict(seed=11, exhaust_steps=(2, 5), dispatch_fail_steps=(1, 4),
         dispatch_delay_steps=(2, 4, 6), dispatch_delay_s=0.001,
         swap_fail_steps=(3,), cancel_at={1: (0, 2)}, expire_at={3: (1,)}),
    dict(seed=7, swap_fail_rate=0.5, expire_rate=0.5, cancel_rate=0.5),
]


@pytest.mark.parametrize("kw", PLANS)
def test_faultplan_decides_as_the_reference(kw):
    """Every query at every step, asked twice (the at-most-once latches),
    against a live set that shrinks: the same answers from both plans."""
    got, want = FaultPlan(**kw), JaxFaultPlan(**kw)
    live = [0, 1, 2, 3, 5, 8]
    for step in range(64):
        for _ in range(2):
            for name in ("take_exhaustion", "take_dispatch_fault",
                         "take_swap_fault"):
                assert getattr(got, name)(step) == \
                    getattr(want, name)(step), (name, step)
        for name in ("cancels_due", "expiries_due"):
            a = getattr(got, name)(step, list(live))
            assert a == getattr(want, name)(step, list(live)), (name, step)
            if a and step % 3 == 0:
                live.remove(a[0])


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


def _submit_all(eng, *, temperature=0.0):
    for rid, p in enumerate(PROMPTS):
        eng.submit(EngineRequest(
            rid=rid, prompt=list(p),
            sampling=SamplingParams(temperature=temperature,
                                    max_new=MAX_NEW)))


def _run_checked(eng):
    """run() with the book-balance invariant asserted after every step."""
    done = []
    while eng.queue or eng.active:
        done.extend(eng.step())
        eng.check_books()
    return {r.rid: r for r in done}


def _assert_drained(eng):
    """Terminal quiescence: no leaks of pages or bookkeeping."""
    alloc = eng.kv.allocator
    assert alloc.in_use == 0 and alloc.n_free == alloc.capacity
    assert not eng.kv.tables
    assert not eng._committed and eng._committed_total == 0
    eng.check_books()


@pytest.fixture(scope="module")
def baseline(served):
    """Fault-free greedy run in the shared geometry: rid -> tokens."""
    eng = engine(served, **GEOM)
    _submit_all(eng)
    done = _run_checked(eng)
    _assert_drained(eng)
    assert all(done[r].outcome == "length" for r in done)
    return {r: done[r].generated for r in done}


def _counter(eng, name):
    return eng.metrics.counter(name).value


def test_genuine_exhaustion_preempts_and_replays(served, baseline):
    """A pool too small for the concurrent demand forces real preemption;
    every request completes, and each preempted-and-replayed request
    reproduces its undisturbed greedy continuation."""
    eng = engine(served, n_pages=5, page_size=4, max_seqs=2,
                 prefill_chunk=4, max_preemptions=10)
    _submit_all(eng)
    done = _run_checked(eng)
    _assert_drained(eng)
    assert _counter(eng, "engine.preemptions") >= 1
    assert _counter(eng, "engine.replayed_prefill_tokens") > 0
    assert len(done) == len(PROMPTS)
    for rid, toks in baseline.items():
        assert done[rid].outcome == "length"
        assert done[rid].generated == toks, rid


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_injected_exhaustion_bit_identical(served, baseline, temperature):
    """Injected exhaustion (ample pool, same geometry) drives the
    preemption path; every request - the preempted one too - is
    bit-identical to the undisturbed run, greedy and sampled."""
    if temperature > 0:
        base_eng = engine(served, **GEOM)
        _submit_all(base_eng, temperature=temperature)
        base = {r: req.generated
                for r, req in _run_checked(base_eng).items()}
    else:
        base = baseline
    eng = engine(served, **GEOM, faults=FaultPlan(exhaust_steps=(2, 5)))
    _submit_all(eng, temperature=temperature)
    done = _run_checked(eng)
    _assert_drained(eng)
    assert _counter(eng, "engine.preemptions") >= 1
    for rid, toks in base.items():
        assert done[rid].generated == toks, rid


def test_cancel_queued_and_midflight(served, baseline):
    """cancel(rid) takes a request out of any phase with its pages
    scrubbed and accounted; the others are undisturbed."""
    eng = engine(served, **GEOM)
    _submit_all(eng)
    q = eng.cancel(3)               # still queued (max_seqs=2)
    assert q.cancelled and q.outcome == "cancelled"
    eng.step()
    m = eng.cancel(0)               # mid-flight by now
    assert m.cancelled and 0 not in eng.kv.tables
    eng.check_books()
    done = _run_checked(eng)
    done.update({0: m, 3: q})
    _assert_drained(eng)
    assert _counter(eng, "engine.requests.cancelled") == 2
    for rid in (1, 2):
        assert done[rid].generated == baseline[rid], rid
    assert _counter(eng, "engine.requests.finished") == 2
    with pytest.raises(ValueError, match="not queued or active"):
        eng.cancel(0)


def test_deadline_expiry(served, baseline):
    """An elapsed deadline_s expires the request at the next step
    boundary, returning its pages."""
    eng = engine(served, **GEOM)
    for rid, p in enumerate(PROMPTS):
        eng.submit(EngineRequest(
            rid=rid, prompt=list(p), deadline_s=None if rid != 2 else -1.0,
            sampling=SamplingParams(max_new=MAX_NEW)))
    done = _run_checked(eng)
    _assert_drained(eng)
    assert done[2].expired and done[2].outcome == "expired"
    assert not done[2].generated
    assert _counter(eng, "engine.requests.expired") == 1
    for rid in (0, 1, 3):
        assert done[rid].generated == baseline[rid], rid


def test_engine_default_deadline_applies(served):
    """An engine-level deadline_s is inherited by requests that don't set
    their own; everything expires, nothing leaks."""
    eng = engine(served, **GEOM, deadline_s=-1.0)
    _submit_all(eng)
    done = _run_checked(eng)
    _assert_drained(eng)
    assert all(done[r].expired for r in done)
    assert _counter(eng, "engine.requests.expired") == len(PROMPTS)


def test_dispatch_faults_do_not_perturb(served, baseline):
    """Injected dispatch failures and delays cost steps, never tokens."""
    eng = engine(served, **GEOM,
                 faults=FaultPlan(dispatch_fail_steps=(1, 4),
                                  dispatch_delay_steps=(2,),
                                  dispatch_delay_s=0.001))
    _submit_all(eng)
    done = _run_checked(eng)
    _assert_drained(eng)
    assert _counter(eng, "engine.dispatch.faults") == 3
    for rid, toks in baseline.items():
        assert done[rid].generated == toks, rid


@pytest.mark.parametrize("seed", range(5))
def test_random_chaos_interleavings(served, baseline, seed):
    """Seeded chaos - exhaustions, cancels, expiries, dispatch failures at
    once: the books balance every step, nothing leaks, every request
    reaches exactly one terminal state, and survivors stay
    bit-identical."""
    plan = FaultPlan(seed=seed, exhaust_rate=0.3, cancel_rate=0.25,
                     expire_rate=0.15, dispatch_fail_rate=0.1)
    eng = engine(served, **GEOM, max_preemptions=10, faults=plan)
    _submit_all(eng)
    done = _run_checked(eng)
    _assert_drained(eng)
    assert len(done) == len(PROMPTS)
    outcomes = {rid: done[rid].outcome for rid in done}
    assert all(o in ("length", "cancelled", "expired", "failed")
               for o in outcomes.values()), outcomes
    assert sum(_counter(eng, f"engine.requests.{k}") for k in
               ("finished", "cancelled", "expired", "failed")) == len(PROMPTS)
    for rid, req in done.items():
        if req.outcome == "length":
            assert req.generated == baseline[rid], (seed, rid)


# every path that rewrites a block table: (engine arguments, prompts, the
# counters that show the path ran)
SYS = [11, 23, 5, 81, 42, 17, 3, 64, 29, 90, 7, 55]     # 3 pages of 4
MIRROR_CASES = {
    "injected_exhaustion": (
        dict(GEOM, max_preemptions=10,
             faults=FaultPlan(seed=0, exhaust_rate=0.4)),
        PROMPTS, ("engine.preemptions",)),
    "genuine_exhaustion": (
        dict(GEOM, n_pages=5, max_preemptions=10), PROMPTS,
        ("engine.preemptions", "engine.replayed_prefill_tokens")),
    "cancel_and_deadlines": (
        dict(GEOM, faults=FaultPlan(seed=0, cancel_rate=0.25,
                                    expire_rate=0.15)),
        PROMPTS, ("engine.requests.cancelled", "engine.requests.expired")),
    "chaos": (
        dict(GEOM, max_preemptions=10,
             faults=FaultPlan(seed=4, exhaust_rate=0.3, cancel_rate=0.25,
                              expire_rate=0.15, dispatch_fail_rate=0.1)),
        PROMPTS, ("engine.preemptions", "engine.dispatch.faults",
                  "engine.requests.cancelled", "engine.requests.expired")),
    "swap": (
        dict(GEOM, n_pages=5, max_preemptions=10, swap_host_mb=8,
             swap_policy="always"),
        PROMPTS, ("engine.swap.out", "engine.swap.in")),
    "swap_faults": (
        dict(GEOM, max_preemptions=10, swap_host_mb=8, swap_policy="always",
             faults=FaultPlan(seed=4, exhaust_rate=0.3, swap_fail_rate=0.3,
                              cancel_rate=0.2)),
        PROMPTS, ("engine.swap.out", "engine.swap.in",
                  "engine.swap.fallbacks")),
    "prefix_cow": (
        dict(GEOM, n_pages=40, prefix_cache=True),
        [SYS + [101, 7, 33], SYS + [88, 12, 60, 4], SYS + [19, 2], SYS[:8]],
        ("engine.prefix.hits", "engine.prefix.cow_copies")),
}


@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_decode_tables_match_block_table_array(served, case):
    """The table mirror against its oracle through every path that
    rewrites a table - preemption and replay, cancels, deadlines, swap-out
    and swap-in, radix adoption and copy-on-write: at every decode step
    the gathered table equals `block_table_array` for the same rows and
    width, and after every step each open sequence's mirror row does (a
    swapped-out one is refused by both)."""
    kw, prompts, counters = MIRROR_CASES[case]
    eng = engine(served, **kw)
    kv = eng.kv
    gather = kv.table_rows
    dispatched = []

    def checked(rids, n_cols, out=None):
        got = gather(rids, n_cols, out)
        assert np.array_equal(got, kv.block_table_array(rids, n_cols))
        dispatched.append(n_cols)
        return got

    kv.table_rows = checked
    for rid, p in enumerate(prompts):
        eng.submit(EngineRequest(rid=rid, prompt=list(p),
                                 sampling=SamplingParams(max_new=MAX_NEW)))
    while eng.queue or eng.active:
        eng.step()
        eng.check_books()
        for rid, table in kv.tables.items():
            n_cols = 1 << max(len(table) - 1, 0).bit_length()
            if any(isinstance(e, HostPageRef) for e in table):
                for build in (gather, kv.block_table_array):
                    with pytest.raises(ValueError, match="host-resident"):
                        build([rid], n_cols)
            else:
                assert np.array_equal(gather([rid], n_cols),
                                      kv.block_table_array([rid], n_cols))
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear()
    _assert_drained(eng)
    assert dispatched
    for name in counters:
        assert _counter(eng, name) >= 1, name


def test_identical_plans_replay_identical_faults(served):
    """Same seed, same trace: the same faults fire and the run is
    step-for-step identical."""
    runs = []
    for _ in range(2):
        plan = FaultPlan(seed=3, exhaust_rate=0.4, cancel_rate=0.2)
        eng = engine(served, **GEOM, max_preemptions=10, faults=plan)
        _submit_all(eng)
        done = _run_checked(eng)
        runs.append({
            "outcomes": {r: done[r].outcome for r in done},
            "tokens": {r: done[r].generated for r in done},
            "preempt": _counter(eng, "engine.preemptions"),
            "cancel": _counter(eng, "engine.requests.cancelled"),
            "steps": eng.n_steps,
        })
    assert runs[0] == runs[1]
    assert runs[0]["preempt"] >= 1 and runs[0]["cancel"] >= 1


def test_preemption_limit_fails_terminally(served):
    """max_preemptions bounds the replay loop: a request preempted past the
    limit fails with a diagnosable reason instead of livelocking."""
    eng = engine(served, **GEOM, max_preemptions=0,
                 faults=FaultPlan(exhaust_steps=(3,)))
    _submit_all(eng)
    done = _run_checked(eng)
    _assert_drained(eng)
    failed = [r for r in done.values() if r.failed is not None]
    assert len(failed) == 1
    assert "preempted" in failed[0].failed
    assert failed[0].outcome == "failed"
    assert _counter(eng, "engine.requests.failed") == 1


def test_stall_detector_diagnoses(served):
    """A head-of-line demand that can never be satisfied raises a
    diagnosable EngineStalledError instead of spinning. submit() refuses
    such requests, so the stall is staged by planting one on the queue."""
    eng = engine(served, n_pages=5, page_size=4, max_seqs=2)
    big = EngineRequest(rid=9, prompt=list(range(40)),
                        sampling=SamplingParams(max_new=4))
    eng.queue.append(big)    # bypasses submit's capacity validation
    with pytest.raises(EngineStalledError, match=r"rid 9 needs \d+ pages"):
        eng.step()


def test_on_token_streams_and_drops_a_raising_callback(served, baseline):
    """Tokens stream at step boundaries, once each, in order - also across
    a preemption and its replay; a raising callback is counted and
    dropped, and the other streams and the tokens are untouched."""
    eng = engine(served, **GEOM, faults=FaultPlan(exhaust_steps=(2, 5)))
    seen = {rid: [] for rid in range(len(PROMPTS))}

    def broken(rid, tok):
        seen[rid].append(tok)
        raise RuntimeError("consumer gone")

    for rid, p in enumerate(PROMPTS):
        eng.submit(EngineRequest(rid=rid, prompt=list(p),
                                 sampling=SamplingParams(max_new=MAX_NEW)),
                   on_token=broken if rid == 1 else
                   (lambda r, t: seen[r].append(t)))
    done = _run_checked(eng)
    _assert_drained(eng)
    assert _counter(eng, "engine.preemptions") >= 1
    assert _counter(eng, "engine.stream.callback_errors") == 1
    assert seen[1] == baseline[1][:1]
    for rid in (0, 2, 3):
        assert seen[rid] == done[rid].generated == baseline[rid]
    assert not eng._callbacks


def test_faultplan_validation():
    with pytest.raises(ValueError, match="cancel_rate"):
        FaultPlan(cancel_rate=1.5)
    with pytest.raises(ValueError, match="swap_fail_rate"):
        FaultPlan(swap_fail_rate=-0.1)
    with pytest.raises(ValueError, match="dispatch_delay_s"):
        FaultPlan(dispatch_delay_s=-0.5)
    with pytest.raises(ValueError, match="exhaust_steps.*negative"):
        FaultPlan(exhaust_steps=(2, -1))
    with pytest.raises(ValueError, match="swap_fail_steps.*negative"):
        FaultPlan(swap_fail_steps=(-3,))
    with pytest.raises(ValueError, match="cancel_at.*negative"):
        FaultPlan(cancel_at={-2: (0,)})
    with pytest.raises(ValueError, match="expire_at.*negative"):
        FaultPlan(expire_at={-1: (1,)})
    plan = FaultPlan(exhaust_steps=(3,))
    assert plan.take_exhaustion(3) is True
    assert plan.take_exhaustion(3) is False     # at most once per step
    assert plan.take_exhaustion(4) is False
    assert plan.take_dispatch_fault(0) is None
    assert isinstance(DispatchFault("x"), RuntimeError)


def test_swap_fault_latch_shared_across_directions():
    plan = FaultPlan(swap_fail_steps=(2,))
    assert plan.take_swap_fault(1) is False
    assert plan.take_swap_fault(2) is True
    assert plan.take_swap_fault(2) is False     # latched for the step
    assert plan.take_swap_fault(3) is False
    assert isinstance(SwapFault("x"), RuntimeError)
    a = [FaultPlan(seed=7, swap_fail_rate=0.5).take_swap_fault(s)
         for s in range(20)]
    b = [FaultPlan(seed=7, swap_fail_rate=0.5).take_swap_fault(s)
         for s in range(20)]
    assert a == b and any(a) and not all(a)
