"""Helpers of the metric readers (`perfbench/metrics/<name>.py`)."""
from __future__ import annotations

import statistics

from . import counts
from .cell import percentile


def tail_ms(values, q: float = 95.0):
    v = percentile(values, q)
    return None if v is None else 1e3 * v


def step_ms(ctx):
    """Median host ms of `engine.step()` over the window."""
    if not ctx.records:
        return None
    return 1e3 * statistics.median(r.t1 - r.t0 for r in ctx.records)


def decode_rows(ctx):
    """Mean decode rows per step over the window."""
    if not ctx.records:
        return None
    return sum(len(r.decode_ctx) for r in ctx.records) / len(ctx.records)


def chunk_fill(ctx):
    """Real prompt rows over the padded rows computed, in %."""
    chunks = [r for rec in ctx.records for _, r, _ in rec.chunks]
    if not chunks:
        return None
    return 100.0 * sum(chunks) / sum(counts.next_pow2(r) for r in chunks)


def _traced_work(ctx):
    return [ctx.family.step_work(ctx.dims, r) for r in ctx.trace_records]


def kernel_roofline(ctx, group: str, work_class: str):
    """The summed bound time of a class of work in the traced slice over
    the measured device time of the kernel group that does it, in %."""
    if not ctx.trace or not ctx.trace_records:
        return None
    t = ctx.trace["group_s"].get(group, 0.0)
    if t <= 0:
        return None
    bound = sum(w[work_class][2] for w in _traced_work(ctx))
    return 100.0 * bound / t


def other_ops_ms(ctx, per: str):
    """Device ms of every kernel but the hand-written ones, per step
    (`per="step"`) or per prefill chunk (`per="chunk"`) of the slice."""
    if not ctx.trace or not ctx.trace_records:
        return None
    n = len(ctx.trace_records) if per == "step" else sum(
        len(r.chunks) for r in ctx.trace_records)
    if not n:
        return None
    return 1e3 * ctx.trace["other_s"] / n


def idle_share(ctx):
    if not ctx.trace or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])


def mfu(ctx):
    """Each class of counted work at its own peak, summed over the traced
    slice, over the slice's length, in %."""
    if not ctx.trace or ctx.trace["window_s"] <= 0:
        return None
    ideal = sum(w["ideal_s"] for w in _traced_work(ctx))
    return 100.0 * ideal / ctx.trace["window_s"]
