"""The engine metric taxonomy: canonical names + snapshot validation.

Every metric `ServeEngine` emits is declared here, split by instrument
kind. `validate_snapshot` enforces the contract in both directions — a
snapshot must contain every required name (a silently-dropped metric is
a telemetry regression) and must not contain names the taxonomy doesn't
know (a typo'd or ad-hoc metric never lands in the recorded history).
Conditionally-emitted families (register-slot metrics for SSM/hybrid
models, per-entry kernel dispatch tallies, quality-probe stats) are
matched by pattern and may be absent.

The same names as the JAX package's `repro.serve.telemetry.schema`, so
one validator accepts both packages' snapshots. `launch/serve.py`
validates before writing, so a bad snapshot can never be produced in the
first place; `python -m repro_torch.serve.telemetry.check` validates a
written one.
"""
from __future__ import annotations

import re

from .metrics import SCHEMA_VERSION

# -- always emitted by the engine --------------------------------------

REQUIRED_COUNTERS = (
    "engine.steps",
    "engine.prefill_tokens",
    "engine.decode_tokens",
    "engine.generated_tokens",
    "engine.pages_walked",
    "engine.pages_walked_dense",
    "engine.requests.submitted",
    "engine.requests.admitted",
    "engine.requests.finished",
    "engine.requests.stop_hits",
    "engine.requests.cancelled",
    "engine.requests.expired",
    "engine.requests.failed",
    "engine.preemptions",
    "engine.replayed_prefill_tokens",
    "engine.dispatch.faults",
    "engine.admission.blocked",
    "engine.prefix.hits",
    "engine.prefix.misses",
    "engine.prefix.hit_tokens",
    "engine.prefix.cow_copies",
    "engine.prefix.inserted_pages",
    "engine.prefix.evicted_pages",
    "engine.swap.out",
    "engine.swap.in",
    "engine.swap.bytes",
    "engine.swap.retries",
    "engine.swap.fallbacks",
    "engine.requests.poisoned",
    "engine.stream.callback_errors",
)

REQUIRED_GAUGES = (
    "engine.pages.capacity",
    "engine.pages.in_use",
    "engine.pages.peak_in_use",
    "engine.pages.utilization",
    "engine.pages.utilization_peak",
    "engine.pages.reserved",
    "engine.pages.scrubbed",
    "engine.queue.depth",
    "engine.batch.decoding",
    "engine.batch.prefilling",
    "engine.pages.shared",
    "engine.prefix.tree_pages",
    "engine.prefix.tree_nodes",
    # host swap tier: zeros when no pool is attached (always emitted so
    # the snapshot shape is policy-independent)
    "engine.swap.host_pages",
    "engine.swap.host_pages_capacity",
    "engine.swap.host_bytes",
    "engine.swap.host_budget_bytes",
)

REQUIRED_HISTOGRAMS = (
    "engine.step.wall_s",
    "engine.step.budget_utilization",
    "engine.decode.batch_occupancy",
    "engine.decode.token_latency_s",
    "engine.admission.wait_s",
    "engine.request.e2e_s",
    "engine.prefill.chunk_tokens",
)

# -- emitted only when the config/run warrants them ---------------------

OPTIONAL_PATTERNS = (
    # register-slot pools exist only for ssm/hybrid state specs
    re.compile(r"^engine\.register_slots\."
               r"(capacity|in_use|peak_in_use|scrubbed)$"),
    # one tally per kernels entry point × dispatch path
    re.compile(r"^kernels\.dispatch\.[a-z0-9_]+\.(kernels|ref)$"),
    # quality probes: pooled histograms + per-layer latest-value gauges
    re.compile(r"^quality\.probe_dispatches$"),
    re.compile(r"^quality\.(layer\d+\.)?"
               r"(l1_imbalance_(pre|post)|sat_rate|kurtosis_(pre|post))$"),
)

_HIST_KEYS = ("base", "growth", "n_buckets", "counts", "count", "sum",
              "min", "max", "p50", "p95", "p99")


def _known(name: str, required: tuple) -> bool:
    return name in required or any(p.match(name) for p in OPTIONAL_PATTERNS)


def validate_snapshot(snap: dict) -> None:
    """Raise ValueError unless `snap` is a schema-valid engine metrics
    snapshot: current schema version, all required metric names present
    in the right instrument section, no unknown names, and well-formed
    histogram payloads."""
    if not isinstance(snap, dict):
        raise ValueError("snapshot must be a dict")
    ver = snap.get("schema_version")
    if ver != SCHEMA_VERSION:
        raise ValueError(f"snapshot schema_version {ver!r} != supported "
                         f"{SCHEMA_VERSION}")
    problems = []
    for section, required in (("counters", REQUIRED_COUNTERS),
                              ("gauges", REQUIRED_GAUGES),
                              ("histograms", REQUIRED_HISTOGRAMS)):
        got = snap.get(section)
        if not isinstance(got, dict):
            problems.append(f"missing section {section!r}")
            continue
        for name in required:
            if name not in got:
                problems.append(f"missing {section[:-1]} {name!r}")
        for name in got:
            if not _known(name, required):
                problems.append(f"unknown {section[:-1]} {name!r}")
    for name, h in (snap.get("histograms") or {}).items():
        if not isinstance(h, dict):
            problems.append(f"histogram {name!r} is not a dict")
            continue
        missing = [k for k in _HIST_KEYS if k not in h]
        if missing:
            problems.append(f"histogram {name!r} missing {missing}")
        elif len(h["counts"]) != h["n_buckets"] \
                or sum(h["counts"]) != h["count"]:
            problems.append(f"histogram {name!r} bucket counts are "
                            "inconsistent with its total count")
    if problems:
        raise ValueError("invalid metrics snapshot:\n  "
                         + "\n  ".join(problems))
