"""Process-local metrics: counters, gauges, exponential-bucket histograms.

Stdlib-only by design — the registry must be importable from the
scheduler's hot loop, from the benches, and (eventually) from a per-host
telemetry shard without dragging a tensor library into the accounting path. All state
is plain Python numbers; nothing here ever touches a device buffer.

Three instrument kinds (see the package docstring for the taxonomy):

* `Counter` — monotonically increasing total (tokens served, pages
  walked). `inc(n)` only; a benchmark that needs a fresh window calls
  `MetricsRegistry.reset()` (or `ServeEngine.reset_metrics()`), never
  decrements.
* `Gauge` — last-observed level (pages in use, queue depth). `set(v)`.
* `Histogram` — exponential buckets `[0, base), [base, base·g), …` with
  the final bucket open-ended. Quantiles (p50/p95/p99) are estimated by
  linear interpolation inside the bucket holding the target rank and
  clamped to the observed min/max, so the estimate is always within one
  bucket-growth factor of the nearest-rank sample statistic — and two
  histograms with the same bucket config can be `merge()`d exactly
  (bucket counts add), which is what the future multi-host case needs:
  per-host registries merge into one fleet view without re-observing.

`snapshot()` emits a plain-dict view stamped with `SCHEMA_VERSION`; the
schema module validates metric names against the engine taxonomy and the
serve bench refuses to append a history row whose schema version
regressed.
"""
from __future__ import annotations

import math

# v2: robustness taxonomy — preemption/cancel/expiry/failure counters,
# replayed prefill tokens, dispatch-fault tally, live/peak utilization
# v3: prefix-sharing taxonomy — radix-cache hit/miss/hit-token/COW/
# insert/evict counters, tree-size and shared-page gauges
# v4: tiered-paging taxonomy — host-swap traffic counters
# (out/in/bytes/retries/fallbacks) + host-tier occupancy gauges, plus
# the poisoned-request and stream-callback-error degradation counters
SCHEMA_VERSION = 4


class Counter:
    """Monotonic total. `value` is plain attribute access so callers that
    mirror an externally-maintained monotonic count (e.g. the kernel
    dispatch tallies) can assign it directly at snapshot time."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1):
        if n < 0:
            raise ValueError("counters only increase; use reset() for a "
                             "fresh measurement window")
        self.value += n


class Gauge:
    """Last-observed level."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = v


class Histogram:
    """Exponential-bucket histogram over non-negative samples.

    Bucket 0 holds `[0, base)`, bucket i holds
    `[base·growth^(i-1), base·growth^i)`, and the last bucket is
    open-ended. The defaults (1 µs base, ×2 growth, 40 buckets) cover
    sub-microsecond dispatch overheads through multi-hour walls, which
    is every latency this engine records; dimensionless ratios
    (occupancy, utilization) ride the same buckets — only relative
    resolution matters for a quantile estimate.
    """

    __slots__ = ("base", "growth", "n_buckets", "counts", "count", "sum",
                 "min", "max")

    def __init__(self, base: float = 1e-6, growth: float = 2.0,
                 n_buckets: int = 40):
        if base <= 0 or growth <= 1 or n_buckets < 2:
            raise ValueError("need base > 0, growth > 1, n_buckets >= 2")
        self.base = base
        self.growth = growth
        self.n_buckets = n_buckets
        self.counts = [0] * n_buckets
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- bucket geometry ------------------------------------------------

    def bucket_index(self, v: float) -> int:
        if v < self.base:
            return 0
        i = 1 + int(math.floor(math.log(v / self.base) / math.log(self.growth)))
        # float log can land a boundary value one bucket low/high; nudge
        # so boundaries classify exactly: bucket i starts at lower(i)
        while i < self.n_buckets - 1 and v >= self.lower(i + 1):
            i += 1
        while i > 1 and v < self.lower(i):
            i -= 1
        return min(i, self.n_buckets - 1)

    def lower(self, i: int) -> float:
        """Inclusive lower bound of bucket `i` (0 for bucket 0)."""
        return 0.0 if i == 0 else self.base * self.growth ** (i - 1)

    def upper(self, i: int) -> float:
        """Exclusive upper bound (inf for the open-ended last bucket)."""
        return math.inf if i >= self.n_buckets - 1 \
            else self.base * self.growth ** i

    # -- recording ------------------------------------------------------

    def observe(self, v: float):
        if v < 0:
            raise ValueError(f"histogram samples must be >= 0, got {v}")
        self.counts[self.bucket_index(v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def merge(self, other: "Histogram"):
        """Accumulate `other` into self (exact: bucket counts add). Both
        sides must share the bucket config — the mergeability contract
        for combining per-host registries."""
        if (self.base, self.growth, self.n_buckets) != \
                (other.base, other.growth, other.n_buckets):
            raise ValueError("cannot merge histograms with different "
                             "bucket configs")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    # -- quantiles ------------------------------------------------------

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile estimated from bucket counts: linear
        interpolation inside the bucket holding rank ceil(q·count),
        clamped to the observed min/max. Within one growth factor of the
        exact sample statistic by construction."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return math.nan
        target = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= target:
                lo = self.lower(i)
                hi = self.max if math.isinf(self.upper(i)) else self.upper(i)
                frac = (target - cum) / c
                est = lo + frac * (hi - lo)
                return min(max(est, self.min), self.max)
            cum += c
        return self.max      # unreachable unless counts were mutated

    def to_dict(self) -> dict:
        return {
            "base": self.base,
            "growth": self.growth,
            "n_buckets": self.n_buckets,
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
            "min": None if math.isinf(self.min) else self.min,
            "max": None if math.isinf(self.max) else self.max,
            "p50": None if self.count == 0 else self.quantile(0.50),
            "p95": None if self.count == 0 else self.quantile(0.95),
            "p99": None if self.count == 0 else self.quantile(0.99),
        }


class MetricsRegistry:
    """Process-local, name-keyed instrument store.

    Instruments are created on first access (`counter(name)` etc.) and
    keep their identity for the registry's lifetime, so hot-loop callers
    can hold the instrument object instead of re-resolving the name.
    `snapshot()` is the only export surface; `merge()` combines two
    registries (counters add, gauges keep the other's latest, histograms
    add bucket counts) for the multi-host roll-up.
    """

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str, **kw) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(**kw)
        return h

    def reset(self):
        """Zero every registered instrument in place (names survive, so
        held instrument references stay valid) — the measurement-window
        boundary the benches and `ServeEngine.reset_metrics()` use."""
        for c in self.counters.values():
            c.value = 0
        for g in self.gauges.values():
            g.value = 0.0
        for h in self.histograms.values():
            h.counts = [0] * h.n_buckets
            h.count = 0
            h.sum = 0.0
            h.min = math.inf
            h.max = -math.inf

    def merge(self, other: "MetricsRegistry"):
        """Fold `other` into self: counters add, histograms add bucket
        counts, gauges take `other`'s value (the merge direction is
        "newer shard wins" for levels)."""
        for name, c in other.counters.items():
            self.counter(name).value += c.value
        for name, g in other.gauges.items():
            self.gauge(name).value = g.value
        for name, h in other.histograms.items():
            mine = self.histograms.get(name)
            if mine is None:
                mine = self.histograms[name] = Histogram(
                    base=h.base, growth=h.growth, n_buckets=h.n_buckets)
            mine.merge(h)

    def snapshot(self) -> dict:
        """Versioned plain-dict view (json-serializable)."""
        return {
            "schema_version": SCHEMA_VERSION,
            "counters": {k: v.value for k, v in sorted(self.counters.items())},
            "gauges": {k: v.value for k, v in sorted(self.gauges.items())},
            "histograms": {k: v.to_dict()
                           for k, v in sorted(self.histograms.items())},
        }
