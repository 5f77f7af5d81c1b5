"""The program's own spans of the traced slice, for the `program_span`
metrics.

While the harness's profiler records the traced slice, `ServeEngine.step`
records its phases into the tracer of that `torch.profiler` session, which
outlives the engine: `repro_torch.serve.telemetry.trace.profiler_session`.
Each engine step is an "X" event `engine.step` (args: `step`,
`decode_rows`, `chunks`, ...) and each phase an "X" event with the same
`args.step`: `dispatch.decode` / `dispatch.prefill` (`dur` the host's
launch; the decode's `args.device_wall_ms` the device's clock between two
CUDA events around its launch, so its device time plus the device's idle
while the host launches it), `engine.decode.wait` (the token transfer),
and others. A program that records no such spans gives None.
"""
from __future__ import annotations

import statistics


def session_steps(ctx) -> dict[int, dict[str, list[dict]]] | None:
    """The traced slice's spans by engine step, then by name; None outside
    a traced run or where the program records none."""
    if not ctx.trace_records:
        return None
    try:
        from repro_torch.serve.telemetry.trace import profiler_session
    except ImportError:
        return None
    tracer = profiler_session()
    if tracer is None:
        return None
    steps: dict[int, dict[str, list[dict]]] = {}
    for e in tracer.events:
        if e.get("ph") != "X" or "step" not in e.get("args", {}):
            continue
        steps.setdefault(e["args"]["step"], {}).setdefault(
            e["name"], []).append(e)
    return steps or None


def decode_steps(ctx) -> list[dict[str, list[dict]]]:
    """Steps that ran a decode dispatch and no prefill chunk."""
    steps = session_steps(ctx) or {}
    return [s for _, s in sorted(steps.items())
            if "dispatch.decode" in s and "engine.step" in s
            and s["engine.step"][0]["args"]["chunks"] == 0]


def _end(e: dict) -> float:
    return e["ts"] + e["dur"]


def median(values) -> float | None:
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def prelaunch_ms(ctx) -> float | None:
    """Median ms from a decode step's start to its launch: admission,
    page growth, the inputs and their copies to the device."""
    return median(1e-3 * (s["dispatch.decode"][0]["ts"]
                          - s["engine.step"][0]["ts"])
                  for s in decode_steps(ctx))


def postsync_ms(ctx) -> float | None:
    """Median ms from the end of a decode step's token transfer to the
    step's end: commit, accounting and the stream flush."""
    return median(1e-3 * (_end(s["engine.step"][0])
                          - _end(s["engine.decode.wait"][0]))
                  for s in decode_steps(ctx) if "engine.decode.wait" in s)


def decode_wall_ms(ctx) -> float | None:
    """Median ms on the device's clock from a decode step's launch to the
    end of its device work."""
    return median(s["dispatch.decode"][0]["args"].get("device_wall_ms")
                  for s in decode_steps(ctx))


def prefill_host_ms(ctx) -> float | None:
    """Median host ms to launch one prefill chunk's forward."""
    steps = session_steps(ctx) or {}
    return median(1e-3 * e["dur"] for s in steps.values()
                  for e in s.get("dispatch.prefill", []))
