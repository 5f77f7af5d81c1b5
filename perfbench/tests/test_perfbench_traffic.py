"""The traffic generator is deterministic in the seed, and every seed
serves the same sizes in the same order."""
from collections import Counter

from perfbench.harness import spec
from perfbench.harness.traffic import ClosedLoop

SEEDS = (7, 2**31 + 11, 2**33 + 5)


def _sizes(loop, rounds=3):
    return [loop.sizes(r, c) for r in range(rounds)
            for c in range(loop.t.clients)]


def test_deterministic_in_seed():
    t = spec.traffic("longctx")
    a, b = ClosedLoop(t, 1000, SEEDS[1]), ClosedLoop(t, 1000, SEEDS[1])
    assert _sizes(a) == _sizes(b)
    for c in (0, 5, 63):
        assert a.request(2, c) == b.request(2, c)
    other = ClosedLoop(t, 1000, SEEDS[0])
    assert [r.prompt for r in a.first_wave()] \
        != [r.prompt for r in other.first_wave()]


def test_every_seed_serves_the_same_sizes():
    for name in ("longctx", "prefill"):
        t = spec.traffic(name)
        want = None
        for seed in SEEDS:
            loop = ClosedLoop(t, 1000, seed)
            got = _sizes(loop)
            want = want or got
            assert got == want
            assert len(Counter(got)) > t.clients // 2
            for r in loop.first_wave():
                total = len(r.prompt) + r.max_new
                assert r.max_new >= 1 and total <= t.max_total
                lo, hi = t.prompt_tokens
                assert lo <= len(r.prompt)


def test_lengths_cover_the_ranges():
    t = spec.traffic("prefill")
    loop = ClosedLoop(t, 1000, 3)
    p = [loop.sizes(1, c)[0] for c in range(t.clients)]
    o = [loop.sizes(1, c)[1] for c in range(t.clients)]
    assert min(p) >= 512 and max(p) <= 2048 and max(p) - min(p) > 1200
    assert min(o) >= 8 and max(o) <= 24
