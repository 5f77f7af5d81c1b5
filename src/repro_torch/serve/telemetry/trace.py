"""Request and engine-phase tracing in Chrome Trace Event Format
(Perfetto-ready), on the clock of `torch.profiler`'s device trace.

`Tracer` records two families of events, stdlib-only and append-only so
the hot loop pays one list append per event:

* **Request lifecycle** (pid `PID_REQUESTS`, tid = request id): a
  `request` span wrapping the whole lifetime, with nested `queued`
  (submit → admission), `prefill` (admission → prompt fully cached) and
  `decode` (prompt cached → finish) spans as B/E pairs, plus instant
  events for page/slot allocations and the first delivered token. One
  row per request in the Perfetto track view.
* **Engine phases** (pid `PID_ENGINE`, tid 0): complete ("X") events
  for each engine step (`engine.step`) and the phases inside it
  (`engine.admit`, `engine.grow`, `engine.decode.inputs`,
  `engine.decode.copy`, `dispatch.decode`, `engine.decode.wait`,
  `engine.decode.commit`, `engine.prefill.inputs`, `dispatch.prefill`,
  `engine.prefill.wait`, `engine.prefill.commit`, `engine.account`,
  `engine.flush`), each with `args.step`, the engine's step index. No
  phase synchronises the device: a dispatch's `dur` is the host's time to
  launch it. On a CUDA device `dispatch.decode` also carries
  `args.device_wall_ms`, the device's clock between two CUDA events
  recorded just before and just after the launch, read once the step's
  token transfer has finished the device's work: the dispatch's device
  time plus the device's idle while the host still launches it. It is no
  device time alone, and under `torch.profiler`, whose CUPTI callbacks
  slow a launch, the idle grows; the profile's own kernel events are the
  device time. Tracing adds host work only - never a changed dispatch
  shape, argument or sampling draw (the engine parity tests hold that).

Timestamps are microseconds since the tracer's zero, read from
`time.perf_counter_ns` (monotonic). The zero is also taken as Unix-epoch
nanoseconds (`unix_ns_at_zero`, exported as `otherData.unix_ns_at_zero`),
the clock `torch.profiler`'s events carry, so `ts + unix_ns_at_zero / 1e3`
places a span on the profiler's timeline against the device's kernels
and idle gaps.

**Profiler sessions.** An engine without a tracer of its own records its
engine-phase spans whenever a `torch.profiler` session is recording, into
a session tracer: a new `Tracer` starts at the engine's first step under
each session (the profiler names no session, so two sessions with no
engine step between them share one), and `profiler_session()` returns the
latest after the session closed (the benchmark's readers, and an operator
who profiles a live server, read it there). Request lifecycle spans are left
out of a session: a request submitted before it began could not be
balanced. The spans are not `torch.profiler.record_function` ranges: a
range around a launch gets a device-side twin in the profile, which would
count as device work.

`save()` writes the standard `{"traceEvents": [...]}` JSON object that
chrome://tracing and https://ui.perfetto.dev open directly.

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


def _clock_pair(reads: int = 8) -> tuple[int, int]:
    """One instant on both clocks, `(perf_counter_ns, time_ns)`: of a few
    perf-unix-perf brackets, the narrowest, its perf reading taken at the
    bracket's middle."""
    best = None
    for _ in range(reads):
        p0 = time.perf_counter_ns()
        unix = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, (p0 + p1) // 2, unix)
    return best[1], best[2]


class Tracer:
    def __init__(self):
        self._t0, self.unix_ns_at_zero = _clock_pair()
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
                 args: dict | None = None) -> dict:
        """An "X" event: `ts`/`dur` in µs on this tracer's clock. Returns
        the event, whose `args` a caller may complete later."""
        ev = {"name": name, "ph": "X", "ts": ts, "dur": max(dur, 0.0),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)
        return ev

    def phase(self, name: str, ts: float, args: dict) -> float:
        """An engine-track "X" event from `ts` to now; returns now, the
        next phase's start."""
        now = self.ts()
        self.complete(name, ts, now - ts, args=args)
        return now

    @contextlib.contextmanager
    def span(self, name: str, *, pid: int = PID_ENGINE, tid: int = 0,
             args: dict | None = None):
        self.begin(name, pid=pid, tid=tid, args=args)
        try:
            yield
        finally:
            self.end(name, pid=pid, tid=tid)

    def to_dict(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms",
                "otherData": {"unix_ns_at_zero": self.unix_ns_at_zero}}

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)


_session: Tracer | None = None    # the latest profiler session's tracer


def new_session() -> Tracer:
    """Start the tracer of a `torch.profiler` session, from now the one
    `profiler_session()` returns."""
    global _session
    _session = Tracer()
    return _session


def profiler_session() -> Tracer | None:
    """The tracer of the latest `torch.profiler` session an engine stepped
    under, or None."""
    return _session


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
