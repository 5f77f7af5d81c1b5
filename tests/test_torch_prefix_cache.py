"""The port's radix prefix cache: tree semantics, COW, eviction,
accounting - on the CPU.

The tree unit tests drive `RadixCache` over a `PagedKVCache` with an empty
kv tree (scrub and COW are then bookkeeping only), mirror
`tests/test_prefix_cache.py`, and hold one scripted sequence of inserts,
matches, splits, evictions under a budget and `clear` against the JAX
package's `RadixCache` over its own `PagedKVCache`: the same match results,
eviction counts and page refcounts. The engine tests serve shared-prefix
traffic through the port's `ServeEngine(prefix_cache=True)` on the integer
path and assert the reference's promises: cached prefixes skip prefill,
tokens stay bit-identical to the cache-off run, a partial-page hit goes
through exactly one COW copy, the tree honours its page budget, replays
charge only recomputed tokens, and under chaos a page is scrubbed only at
refcount 0.
"""
import numpy as np
import pytest
import torch

from repro.serve.engine.pages import PagedKVCache as JaxPagedKVCache
from repro.serve.engine.radix import RadixCache as JaxRadixCache
from repro_torch.configs.registry import get_config
from repro_torch.core.synthetic import inject_outlier_channels
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import (EngineRequest, FaultPlan, PagedKVCache,
                                      RadixCache, SamplingParams,
                                      ServeEngine, as_servable)
from repro_torch.serve.quantized import QuantizedDenseLM, pack_dense_params

PS = 4          # page size for the unit tests
N_PAGES = 16


def _tree(max_pages=None, cache=PagedKVCache, tree=RadixCache):
    kvc = cache({}, N_PAGES, PS)
    return tree(kvc, max_pages), kvc.allocator, kvc


# ----------------------------------------------------------------------
# radix tree
# ----------------------------------------------------------------------

def test_empty_tree_matches_nothing():
    tree, _, _ = _tree()
    assert tree.match([1, 2, 3]) == ([], None)
    assert tree.n_pages == 0 and tree.n_nodes == 0
    assert tree.held_pages() == set()


def test_insert_match_roundtrip():
    tree, alloc, _ = _tree()
    toks = list(range(100, 112))            # 3 pages of 4
    pages = alloc.alloc(3)
    assert tree.insert(toks, pages) == 3
    assert tree.n_pages == 3 and tree.inserted_pages == 3
    assert tree.held_pages() == set(pages)
    assert alloc.in_use == 3                # ownership moved, not copied
    assert tree.match(toks + [7, 8]) == (pages, None)
    assert tree.match(list(toks)) == (pages, None)
    got, cow = tree.match(toks[:6] + [999] * 6)
    assert got == pages[:1] and cow == (pages[1], 2)
    assert tree.match([999] + toks) == ([], None)


def test_duplicate_insert_consumes_and_frees_the_copy():
    tree, alloc, _ = _tree()
    toks = list(range(12))
    first = alloc.alloc(3)
    tree.insert(toks, first)
    dup = alloc.alloc(3)
    assert tree.insert(toks, dup) == 0      # already cached: adopt nothing
    assert alloc.in_use == 3                # dup refs consumed -> freed
    assert tree.n_pages == 3
    assert tree.match(list(toks)) == (first, None)


def test_page_boundary_split_branches_the_tree():
    tree, alloc, _ = _tree()
    a = list(range(12))
    b = a[:8] + [50, 51, 52, 53]            # shares exactly 2 pages
    pa, pb = alloc.alloc(3), alloc.alloc(3)
    tree.insert(a, pa)
    assert tree.insert(b, pb) == 1          # only the divergent page
    assert alloc.in_use == 4
    assert tree.n_pages == 4 and tree.n_nodes == 3
    assert tree.match(list(a)) == (pa, None)
    assert tree.match(list(b)) == (pa[:2] + [pb[2]], None)


def test_mid_page_divergence_keeps_only_the_aligned_prefix():
    tree, alloc, _ = _tree()
    a = list(range(12))
    pa = alloc.alloc(3)
    tree.insert(a, pa)
    b = a[:6] + [70] * 6
    pb = alloc.alloc(3)
    assert tree.insert(b, pb) == 0
    assert alloc.in_use == 3 and tree.n_pages == 3
    got, cow = tree.match(list(b))
    assert got == pa[:1] and cow == (pa[1], 2)


def test_misaligned_insert_raises():
    tree, alloc, _ = _tree()
    pages = alloc.alloc(2)
    with pytest.raises(ValueError, match="page-aligned"):
        tree.insert(list(range(7)), pages)
    alloc.free(pages)


def test_lru_eviction_respects_budget():
    tree, alloc, _ = _tree(max_pages=4)
    a, b = list(range(12)), list(range(20, 32))
    tree.insert(a, alloc.alloc(3))
    pb = alloc.alloc(3)
    tree.insert(b, pb)                      # over budget -> evict LRU (a)
    assert tree.n_pages <= 4
    assert tree.evicted_pages == 2
    assert tree.match(list(b)) == (pb, None)
    assert len(tree.match(list(a))[0]) <= 1
    assert alloc.in_use == tree.n_pages


def test_evict_skips_pages_pinned_by_live_holders():
    tree, alloc, kvc = _tree()
    toks = list(range(12))
    pages = alloc.alloc(3)
    tree.insert(toks, pages)
    alloc.incref([pages[1]])                # a live sequence shares page 1
    assert tree.evict(3) == 1               # only the free tail goes
    assert tree.n_pages == 2
    assert tree.held_pages() == set(pages[:2])
    assert alloc.refcount(pages[1]) == 2
    assert tree.evict(3) == 0               # the pinned page blocks the rest
    kvc.deref([pages[1]])
    assert tree.evict(3) == 2
    assert tree.n_pages == 0 and alloc.in_use == 0


def test_clear_releases_every_page():
    tree, alloc, _ = _tree()
    tree.insert(list(range(12)), alloc.alloc(3))
    tree.insert(list(range(12))[:8] + [9, 9, 9, 9], alloc.alloc(3))
    held = tree.n_pages
    assert tree.clear() == held
    assert tree.n_pages == 0 and tree.n_nodes == 0
    assert alloc.in_use == 0
    assert tree.match(list(range(12))) == ([], None)


def _script(tree, alloc, kvc):
    """A fixed sequence of tree operations; returns everything observable
    after each one."""
    rng = np.random.default_rng(5)
    streams = [list(range(12)), list(range(8)) + [50, 51, 52, 53],
               list(range(6)) + [70] * 6, list(range(20, 36)),
               list(range(12)) + [9] * 4, [1, 2, 3, 4] * 3]
    log, pinned = [], []
    for i in range(40):
        op = int(rng.integers(5))
        s = streams[int(rng.integers(len(streams)))]
        if op <= 1 and alloc.n_free >= len(s) // PS:
            out = tree.insert(list(s), alloc.alloc(len(s) // PS))
        elif op == 2:
            out = tree.match(list(s) + [int(rng.integers(100))])
            if out[0] and rng.random() < 0.5:
                alloc.incref(out[0][:1])      # a live holder pins a page
                pinned.append(out[0][0])
        elif op == 3:
            out = tree.evict(int(rng.integers(1, 4)))
        elif pinned:
            kvc.deref([pinned.pop()])
            out = None
        else:
            out = tree.clear()
        log.append((op, out, tree.n_pages, tree.n_nodes, tree.evicted_pages,
                    tree.inserted_pages, sorted(tree.held_pages()),
                    [alloc.refcount(p) for p in range(1, N_PAGES)]))
    return log


def test_tree_script_matches_the_reference():
    """The same scripted inserts, matches, splits, evictions under a budget,
    pins and clears: equal results, counts and refcounts at every op."""
    got = _script(*_tree(max_pages=9))
    want = _script(*_tree(max_pages=9, cache=JaxPagedKVCache,
                          tree=JaxRadixCache))
    assert got == want
    assert any(entry[4] for entry in got)          # evictions happened


# ----------------------------------------------------------------------
# engine
# ----------------------------------------------------------------------

MAX_NEW = 4
SYS = [11, 23, 5, 81, 42, 17, 3, 64, 29, 90, 7, 55]     # 3 pages of 4
SUFFIXES = [[101, 7, 33], [88, 12, 60, 4], [19, 2], [73, 41, 6, 5, 28]]
GEOM = dict(n_pages=40, page_size=4, max_seqs=2, prefill_chunk=4)


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


def _submit(eng, prompts):
    for rid, p in enumerate(prompts):
        eng.submit(EngineRequest(rid=rid, prompt=list(p),
                                 sampling=SamplingParams(max_new=MAX_NEW)))


def _run_checked(eng):
    done = []
    while eng.queue or eng.active:
        done.extend(eng.step())
        eng.check_books()
    return {r.rid: r for r in done}


def _counter(eng, name):
    return eng.metrics.counter(name).value


def _assert_drained_but_tree(eng):
    """Quiescent engine: the only live references are the tree's."""
    alloc = eng.kv.allocator
    tree = eng.prefix_cache
    assert not eng.kv.tables and not eng._committed
    assert alloc.in_use == (tree.n_pages if tree else 0)
    eng.check_books()
    if tree:
        tree.clear()
    assert alloc.in_use == 0 and alloc.n_free == alloc.capacity


@pytest.fixture(scope="module")
def baseline(served):
    """Cache-off greedy tokens and prefill cost of the shared workload."""
    eng = engine(served, **GEOM)
    _submit(eng, [SYS + s for s in SUFFIXES])
    done = _run_checked(eng)
    return ({r: done[r].generated for r in done},
            _counter(eng, "engine.prefill_tokens"))


def test_prefix_hits_skip_prefill_bit_identically(served, baseline):
    """Later requests sharing the system prefix prefill only their
    divergent tail, generate the cache-off tokens, and the saving shows in
    the counters."""
    base_toks, base_prefill = baseline
    eng = engine(served, **GEOM, prefix_cache=True)
    _submit(eng, [SYS + s for s in SUFFIXES])
    done = _run_checked(eng)
    for rid, toks in base_toks.items():
        assert done[rid].generated == toks, rid
    assert _counter(eng, "engine.prefix.hits") > 0
    assert _counter(eng, "engine.prefix.hit_tokens") > 0
    assert _counter(eng, "engine.prefill_tokens") < base_prefill
    assert eng.prefix_cache.n_pages > 0
    _assert_drained_but_tree(eng)


def test_partial_page_hit_goes_through_one_cow_copy(served):
    """A prompt that equals a cached stream's page-aligned prefix clamps to
    len - 1 (the last position must produce logits), landing mid-page:
    exactly one COW copy, and the continuation matches a cold run."""
    eng = engine(served, **GEOM, prefix_cache=True)
    _submit(eng, [SYS + SUFFIXES[0]])
    _run_checked(eng)
    assert eng.prefix_cache.n_pages >= 2    # donated at finish
    probe = list(SYS[:8])                   # 2 cached pages exactly
    cold = engine(served, **GEOM)
    cold.submit(EngineRequest(rid=0, prompt=list(probe),
                              sampling=SamplingParams(max_new=MAX_NEW)))
    want = _run_checked(cold)[0].generated
    eng.submit(EngineRequest(rid=9, prompt=list(probe),
                             sampling=SamplingParams(max_new=MAX_NEW)))
    done = _run_checked(eng)
    assert done[9].generated == want
    assert _counter(eng, "engine.prefix.cow_copies") == 1
    assert _counter(eng, "engine.prefix.hit_tokens") == 7
    _assert_drained_but_tree(eng)


def test_tree_honours_its_page_budget(served):
    eng = engine(served, **GEOM, prefix_cache=True, prefix_cache_pages=2)
    _submit(eng, [SYS + s for s in SUFFIXES])
    _run_checked(eng)
    assert eng.prefix_cache.n_pages <= 2
    assert _counter(eng, "engine.prefix.evicted_pages") > 0
    _assert_drained_but_tree(eng)


@pytest.mark.chaos
@pytest.mark.parametrize("cache_on", [False, True])
def test_replay_charges_only_recomputed_tokens(served, cache_on):
    """`engine.replayed_prefill_tokens` counts the rows a replay actually
    recomputes: fault-free runs charge zero; a victim preempted mid-decode
    replays its whole stream with the cache off, and with a warm tree only
    what the tree cannot return - continuing exactly either way."""
    prompt = SYS + SUFFIXES[0]
    eng = engine(served, **GEOM, prefix_cache=cache_on)
    eng.submit(EngineRequest(rid=0, prompt=list(prompt),
                             sampling=SamplingParams(max_new=MAX_NEW)))
    warm = _run_checked(eng)[0].generated
    assert _counter(eng, "engine.replayed_prefill_tokens") == 0
    donated = (eng.prefix_cache.n_pages if cache_on else 0) \
        * GEOM["page_size"]
    b = EngineRequest(rid=1, prompt=list(prompt),
                      sampling=SamplingParams(max_new=MAX_NEW))
    eng.submit(b)
    while len(b.generated) < 2:             # decode to a known point
        eng.step()
        eng.check_books()
    eng._preempt(b)
    eng.check_books()
    done = _run_checked(eng)
    assert done[1].generated == warm        # the replay continued exactly
    stream = len(prompt) + 2                # prompt + generated at preempt
    expect = stream - min(donated, stream - 1)
    assert _counter(eng, "engine.preemptions") == 1
    assert _counter(eng, "engine.replayed_prefill_tokens") == expect
    if cache_on:
        assert 0 < expect < stream
    else:
        assert expect == stream             # the whole stream recomputed
    _assert_drained_but_tree(eng)


@pytest.mark.chaos
@pytest.mark.parametrize("seed", (1, 2, 3))
def test_chaos_sharing_never_scrubs_a_referenced_page(served, baseline,
                                                      seed):
    """Preemption + eviction under sharing: every page handed to the
    scrub has refcount 0 at that moment, and the chaos run's tokens stay
    bit-identical to the undisturbed baseline."""
    base_toks, _ = baseline
    scrubbed = []
    eng = engine(served, n_pages=14, page_size=4, max_seqs=2,
                 prefill_chunk=4, prefix_cache=True, max_preemptions=10,
                 faults=FaultPlan(seed=seed, exhaust_rate=0.3))
    orig = eng.kv.scrub

    def guard(pages):
        for p in pages:
            assert eng.kv.allocator.refcount(p) == 0, \
                f"scrub of live page {p}"
        scrubbed.extend(pages)
        return orig(pages)

    eng.kv.scrub = guard
    _submit(eng, [SYS + s for s in SUFFIXES])
    done = _run_checked(eng)
    for rid, toks in base_toks.items():
        assert done[rid].generated == toks, (seed, rid)
    assert _counter(eng, "engine.preemptions") >= 1
    _assert_drained_but_tree(eng)
    assert scrubbed        # the guard saw traffic
