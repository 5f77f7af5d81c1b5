"""The `program_span` metrics read the program's engine-phase spans of the
traced slice (`perfbench/harness/spans.py`): numbers from a synthetic
profiler session, None without one or from a program that records none."""
import types

import pytest

from perfbench.harness import spec
from repro_torch.serve.telemetry import trace

NAMES = ("prelaunch_ms.decode", "postsync_ms.decode",
         "dispatch_wall_ms.decode", "forward_host_ms.prefill")
TRACED = types.SimpleNamespace(trace_records=[object()])


def _decode_step(tr, k, t, pre, wait, post, wall_ms):
    """A step with no prefill chunk starting at `t` µs: `pre` µs to its
    launch (200 µs to launch), `wait` µs of token transfer, `post` µs
    after it."""
    tr.complete("engine.admit", t, pre / 2, args={"step": k})
    tr.complete("dispatch.decode", t + pre, 200.0,
                args={"step": k, "rows": 64, "device_wall_ms": wall_ms})
    tr.complete("engine.decode.wait", t + pre + 200.0, wait,
                args={"step": k})
    dur = pre + 200.0 + wait + post
    tr.complete("engine.step", t, dur,
                args={"step": k, "decode_rows": 64, "chunks": 0})
    return t + dur


def synthetic_session() -> trace.Tracer:
    tr = trace.Tracer()
    t = _decode_step(tr, 0, 0.0, 8000.0, 41000.0, 900.0, 44.0)
    t = _decode_step(tr, 1, t, 7000.0, 42000.0, 700.0, 45.0)
    t = _decode_step(tr, 2, t, 9000.0, 40000.0, 800.0, 43.0)
    # a step holding a chunk: its decode is left out of the decode medians
    tr.complete("dispatch.decode", t + 50_000.0, 200.0,
                args={"step": 3, "device_wall_ms": 99.0})
    tr.complete("engine.decode.wait", t + 50_200.0, 10.0, args={"step": 3})
    for i, host in enumerate((300_000.0, 320_000.0)):
        tr.complete("dispatch.prefill", t + 1000.0 + i * host, host,
                    args={"step": 3, "tokens": 2048, "padded": 2048})
    tr.complete("engine.step", t, 700_000.0,
                args={"step": 3, "decode_rows": 64, "chunks": 2})
    return tr


WANT = {"prelaunch_ms.decode": 8.0, "postsync_ms.decode": 0.8,
        "dispatch_wall_ms.decode": 44.0, "forward_host_ms.prefill": 310.0}


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_the_session(name, monkeypatch):
    monkeypatch.setattr(trace, "_session", synthetic_session())
    assert spec.reader(name)(TRACED) == pytest.approx(WANT[name])
    untraced = types.SimpleNamespace(trace_records=None)
    assert spec.reader(name)(untraced) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_without_a_session(name, monkeypatch):
    monkeypatch.setattr(trace, "_session", None)
    assert spec.reader(name)(TRACED) is None
    monkeypatch.setattr(trace, "_session", trace.Tracer())
    assert spec.reader(name)(TRACED) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_of_a_program_without_session_spans(name, monkeypatch):
    """A program that has no `profiler_session` (the parent of this
    metric) gives None and raises nothing."""
    monkeypatch.setattr(trace, "_session", synthetic_session())
    monkeypatch.delattr(trace, "profiler_session")
    assert spec.reader(name)(TRACED) is None


def test_device_reader_needs_device_times(monkeypatch):
    """On the CPU a dispatch carries no `device_wall_ms`: the device's
    reader gives None, the host ones still read."""
    tr = synthetic_session()
    for e in tr.events:
        e.get("args", {}).pop("device_wall_ms", None)
    monkeypatch.setattr(trace, "_session", tr)
    assert spec.reader("dispatch_wall_ms.decode")(TRACED) is None
    assert spec.reader("prelaunch_ms.decode")(TRACED) == pytest.approx(8.0)
    assert spec.reader("forward_host_ms.prefill")(TRACED) \
        == pytest.approx(310.0)
