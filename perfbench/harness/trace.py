"""The traced slice: `torch.profiler` over a few engine steps after the
window, reduced to device busy time, kernel time by group and idle gaps.

Kernel events are the profiler's device events (it sees the kernels inside
CUDA-graph replays); an event counts once, by its own duration, never
through the host op that launched it. The harness marks each engine step
with a `record_function` span `pb.step.<i>`, whose host interval names
the idle gaps.
"""
from __future__ import annotations

import contextlib

# the hand-written kernels of the program, by their device symbol names; a
# family adds the groups of its own kernels (`KERNELS` of its module)
HAND_WRITTEN = {
    "int4_matmul": ("i4_mma_kernel",),
    "paged_attention": ("paged_attention_kernel",),
    "hadamard_quant": ("hq_cluster_kernel",),
    "block_hadamard": ("bh_warp_kernel", "bh_block_kernel",
                       "bh_dense_kernel"),
}
STEP_PREFIX = "pb.step."


def group_of(name: str, groups: dict = HAND_WRITTEN) -> str | None:
    for group, syms in groups.items():
        if any(s in name for s in syms):
            return group
    return None


@contextlib.contextmanager
def profiled():
    """A profiler over host ops and device activity; yields a holder whose
    `prof` is set once the block has closed."""
    from torch.profiler import ProfilerActivity, profile
    holder = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield holder
    holder["prof"] = prof


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_profile(prof, kinds: list[str],
                   groups: dict = HAND_WRITTEN) -> dict:
    """Busy seconds, kernel seconds by group (`groups`: device symbol names
    by group) and by name, the window and the longest idle gaps, from a
    profile whose i-th step span had kind `kinds[i]`."""
    from torch.autograd import DeviceType
    device, spans = [], {}
    # the profiler's own records, in ns; its parsed event tree is not built
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = e.start_ns() * 1e-3, (e.start_ns() + e.duration_ns()) * 1e-3
        if name.startswith(STEP_PREFIX):
            if e.device_type() == DeviceType.CPU:
                spans[int(name[len(STEP_PREFIX):])] = (s, t)
            continue
        if e.device_type() == DeviceType.CUDA:
            device.append((name, s, t))
    if not spans or not device:
        return {}
    steps = [spans[i] for i in sorted(spans)]
    w0, w1 = steps[0][0], steps[-1][1]
    by_name: dict[str, float] = {}
    by_group = {g: 0.0 for g in groups}
    inside = []
    for name, s, e in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        inside.append((s, e))
        g = group_of(name, groups)
        if g is not None:
            by_group[g] += (e - s) * 1e-6
        else:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    busy = _union(inside)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    named = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        what = "client bookkeeping"
        for i, (a, b) in enumerate(steps):
            if a <= mid <= b:
                what = f"{kinds[i]} step" if i < len(kinds) else "step"
                break
        named.append((what, (e - s) * 1e-6))
    named.sort(key=lambda t: -t[1])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "group_s": by_group,
        "other_s": sum(by_name.values()),
        "other_by_name": by_name,
        "idle_gaps": named,
    }


def breakdown(summary: dict) -> dict:
    """The result line's `breakdown`: the device operations that took most
    time (the hand-written kernels by group, the rest by name) and the
    longest idle gaps, at most 10 each."""
    ops = [[g, s] for g, s in summary["group_s"].items() if s > 0]
    ops += [[n[:80], s] for n, s in summary["other_by_name"].items()]
    ops.sort(key=lambda t: -t[1])
    return {"device_ops": ops[:10],
            "idle_gaps": [[w, s] for w, s in summary["idle_gaps"][:10]]}
