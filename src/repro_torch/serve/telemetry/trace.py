"""Request/dispatch tracing in Chrome Trace Event Format (Perfetto-ready).

`Tracer` records two families of events, stdlib-only and append-only so
the hot loop pays one list append per event:

* **Request lifecycle** (pid `PID_REQUESTS`, tid = request id): a
  `request` span wrapping the whole lifetime, with nested `queued`
  (submit → admission), `prefill` (admission → prompt fully cached) and
  `decode` (first token → finish) spans as B/E pairs, plus instant
  events for page/slot allocations. One row per request in the Perfetto
  track view.
* **Engine dispatches** (pid `PID_ENGINE`, tid 0): each decode/prefill
  forward as a complete ("X") event. The duration is wall time measured
  around the forward ending in `torch.cuda.synchronize(device)` (the
  *scheduler* synchronises, this module never imports torch) — so with
  tracing on, per-dispatch device time is real, at the cost of
  serializing host/device overlap. Tracing is therefore off by default
  and must stay bit-path-neutral: it may only ever add host-side
  timing/blocking, never change dispatch shapes, argument values, or
  sampling draws (regression-tested by the engine parity tests).

Timestamps are microseconds relative to tracer construction
(`time.perf_counter_ns`-derived, monotonic). `save()` writes the
standard `{"traceEvents": [...]}` JSON object that chrome://tracing and
https://ui.perfetto.dev open directly.

`validate_trace` is the well-formedness checker the tests and the CI
smoke job share: every event carries the required keys for its phase,
B/E pairs nest per (pid, tid) with non-negative span lengths, and "X"
durations are non-negative.
"""
from __future__ import annotations

import contextlib
import json
import time

PID_ENGINE = 1
PID_REQUESTS = 2

_PROCESS_NAMES = {PID_ENGINE: "engine", PID_REQUESTS: "requests"}


class Tracer:
    def __init__(self):
        self._t0 = time.perf_counter_ns()
        self.events: list[dict] = []
        for pid, name in _PROCESS_NAMES.items():
            self.events.append({"name": "process_name", "ph": "M",
                                "pid": pid, "tid": 0,
                                "args": {"name": name}})

    def ts(self) -> float:
        """Microseconds since tracer construction."""
        return (time.perf_counter_ns() - self._t0) / 1e3

    def begin(self, name: str, *, pid: int = PID_ENGINE, tid: int = 0,
              args: dict | None = None):
        ev = {"name": name, "ph": "B", "ts": self.ts(), "pid": pid,
              "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def end(self, name: str, *, pid: int = PID_ENGINE, tid: int = 0,
            args: dict | None = None):
        ev = {"name": name, "ph": "E", "ts": self.ts(), "pid": pid,
              "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, *, pid: int = PID_ENGINE, tid: int = 0,
                args: dict | None = None):
        ev = {"name": name, "ph": "i", "ts": self.ts(), "s": "t",
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def complete(self, name: str, ts: float, dur: float, *,
                 pid: int = PID_ENGINE, tid: int = 0,
                 args: dict | None = None):
        """An "X" event: `ts`/`dur` in µs on this tracer's clock."""
        ev = {"name": name, "ph": "X", "ts": ts, "dur": max(dur, 0.0),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, *, pid: int = PID_ENGINE, tid: int = 0,
             args: dict | None = None):
        self.begin(name, pid=pid, tid=tid, args=args)
        try:
            yield
        finally:
            self.end(name, pid=pid, tid=tid)

    def to_dict(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)


def validate_trace(obj: dict) -> int:
    """Raise ValueError unless `obj` is well-formed Chrome Trace JSON:
    a `traceEvents` list whose events carry the keys their phase
    requires, with non-negative "X" durations and B/E pairs that nest
    properly per (pid, tid) track (matching names, end ts >= begin ts).
    Returns the number of events checked."""
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        raise ValueError("trace must be an object with a traceEvents list")
    stacks: dict[tuple, list] = {}
    for n, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"event {n} is not an object")
        ph = ev.get("ph")
        for key in ("name", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {n} ({ph!r}) missing {key!r}")
        if ph == "M":
            continue
        if ph not in ("B", "E", "X", "i"):
            raise ValueError(f"event {n} has unknown phase {ph!r}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {n} has invalid ts {ts!r}")
        track = (ev["pid"], ev["tid"])
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {n} ('X') has invalid dur {dur!r}")
        elif ph == "B":
            stacks.setdefault(track, []).append((ev["name"], ts, n))
        elif ph == "E":
            stack = stacks.get(track) or []
            if not stack:
                raise ValueError(
                    f"event {n}: 'E' {ev['name']!r} on track {track} "
                    "without an open 'B'")
            bname, bts, bn = stack.pop()
            if bname != ev["name"]:
                raise ValueError(
                    f"event {n}: 'E' {ev['name']!r} closes 'B' {bname!r} "
                    f"(event {bn}) — spans must nest")
            if ts < bts:
                raise ValueError(
                    f"event {n}: span {ev['name']!r} ends at {ts} before "
                    f"it begins at {bts}")
    open_spans = [(t, s) for t, st in stacks.items() for s in st]
    if open_spans:
        raise ValueError(f"unclosed 'B' spans at end of trace: {open_spans}")
    return len(obj["traceEvents"])
