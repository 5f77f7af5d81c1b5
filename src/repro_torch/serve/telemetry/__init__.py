"""Serve-time telemetry: metrics, request tracing, and rotation-quality
probes for the paged serving engine.

Dependency-free by construction — `metrics` and `trace` are stdlib-only
(importable from the scheduler hot loop, the benches, or a bare
telemetry shard); `quality` uses torch only for the probe math that runs
inside the served forward. Nothing here changes what the engine
computes: tracing and probes are off by default, and turning them on is
bit-path-neutral (no dispatch-shape or sampling effects — enforced by
the engine parity tests).

Metric taxonomy (schema version {ver}; canonical list + validation in
`schema.py`, exported snapshots are stamped and checked against it — the
same names as the JAX package's, so either package's validator accepts
either package's snapshot):

* ``engine.*`` — scheduler/engine signals.
  Counters: ``engine.steps``, ``engine.prefill_tokens``,
  ``engine.decode_tokens``, ``engine.generated_tokens`` (decode tokens
  plus each request's prefill-sampled first token),
  ``engine.pages_walked`` / ``engine.pages_walked_dense`` (ragged
  early-exit vs padded full-table walk, per attention dispatch),
  ``engine.requests.{{submitted,admitted,finished,stop_hits}}``,
  ``engine.admission.blocked`` (head-of-line blocked on pages).
  Gauges: ``engine.pages.{{capacity,in_use,peak_in_use,reserved,
  scrubbed}}`` (allocator levels + high-water mark + scrub total),
  ``engine.register_slots.*`` (same, SSM/hybrid specs only),
  ``engine.queue.depth``, ``engine.batch.{{decoding,prefilling}}``.
  Histograms: ``engine.step.wall_s``,
  ``engine.step.budget_utilization`` (tokens spent / token budget),
  ``engine.decode.batch_occupancy`` (decode rows / max_seqs, observed
  per decode dispatch), ``engine.decode.token_latency_s`` (each
  delivered token after a request's first: the gap since the same
  request's previous delivery; the first is stamped as the request's
  ``t_first``),
  ``engine.admission.wait_s`` (submit → admission),
  ``engine.request.e2e_s`` (submit → finish),
  ``engine.prefill.chunk_tokens`` (real tokens per prefill dispatch).
* ``kernels.dispatch.<entry>.<kernels|ref>`` — per-entry-point dispatch
  tallies mirrored from `repro_torch.kernels.ops` at snapshot time: one
  per call, tagged with the path it took (the CUDA kernel, or the plain
  PyTorch version). The time of the serving dispatches lives in the
  trace spans: the host's launch as a span's duration, and the decode
  dispatch's launch and run on the device's clock, between two CUDA
  events, as its ``device_wall_ms``.
* ``quality.*`` — rotation-quality probes (int4 path, sampled every K
  decode dispatches): ``quality.<stat>`` pooled histograms and
  ``quality.layer<NN>.<stat>`` per-layer latest-value gauges for
  ``l1_imbalance_pre/post`` (max/mean blockwise ℓ1 mass, the paper's
  Theorem quantity), ``sat_rate`` (int4 codes pinned at the grid ends),
  and ``kurtosis_pre/post``; plus the ``quality.probe_dispatches``
  counter.

Snapshots are versioned dicts (`MetricsRegistry.snapshot()`), mergeable
across processes (`merge`: counters add, histogram buckets add) for the
multi-host roll-up. Traces are Chrome Trace Event Format JSON that opens
directly in Perfetto (`Tracer.save`): request lifecycles and each engine
step's phases, with no device synchronise, on a clock anchored to the Unix
epoch (`otherData.unix_ns_at_zero`, the clock of `torch.profiler`'s
events). An engine with no tracer records its phases into a session
tracer while a `torch.profiler` session records (`trace.profiler_session`);
the spans are not `record_function` ranges, whose device-side twins the
profile would count as device work. `python -m
repro_torch.serve.telemetry.check` validates both artifact kinds.
"""
from .metrics import (SCHEMA_VERSION, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .quality import PROBE_STATS, QualityProbes, activation_probe_stats
from .schema import validate_snapshot
from .trace import PID_ENGINE, PID_REQUESTS, Tracer, validate_trace

__doc__ = __doc__.format(ver=SCHEMA_VERSION)

__all__ = [
    "SCHEMA_VERSION", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Tracer", "validate_trace", "PID_ENGINE", "PID_REQUESTS",
    "QualityProbes", "activation_probe_stats", "PROBE_STATS",
    "validate_snapshot",
]
