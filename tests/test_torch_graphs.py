"""`serve/engine/graphs.py::CapturedCall` and the tally helpers of
`kernels/ops.py` on the CPU.

A CUDA graph cannot be captured here, so the capture path runs against a
stand-in for `torch.cuda.CUDAGraph` / `torch.cuda.graph` whose capture
executes the function (as the card's would not) and whose replay does
nothing: that is enough to hold the bookkeeping - which call is eager,
what is returned, how the tallies move, that errors raise. Replays on the
card are held against eager calls in `tests/test_torch_gpu.py`."""
import contextlib

import pytest
import torch

from repro_torch.kernels import block_hadamard as BH
from repro_torch.kernels import hadamard_quant as HQ
from repro_torch.kernels import int4_matmul as I4
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ops as kops
from repro_torch.serve.engine.graphs import CapturedCall


@pytest.fixture
def tallies(monkeypatch):
    """Fresh launch counts and dispatch tallies for the test alone."""
    for mod in (BH, HQ, I4, PA):
        monkeypatch.setattr(mod, "LAUNCHES", dict.fromkeys(mod.LAUNCHES, 0))
    monkeypatch.setattr(kops, "_DISPATCH", {})


def _call(x):
    """A dispatch as the engine's: two entry points (plain versions on the
    CPU, tallied "ref") and two launches of a kernel, counted as a wrapper
    counts them."""
    codes, scale, zero = kops.quantize_act(x)
    I4.LAUNCHES["int4_matmul"] += 2
    return kops.hadamard_quant(x, 4)[0] + codes, scale


def _calls(k):
    """Both tallies after k calls of `_call`, zeros left out."""
    return ({"int4_matmul": 2 * k},
            {("quantize_act", "ref"): k, ("hadamard_quant", "ref"): k})


def _nonzero(counts):
    return tuple({k: n for k, n in c.items() if n} for c in counts)


@pytest.mark.parametrize("n", [1, 4])
def test_count_helpers_replay_what_eager_counts(tallies, n):
    """A capture's counts taken back, then added once per replay: after n
    dispatches both tallies read what n eager calls read."""
    x = torch.randn(3, 16)
    for _ in range(n):
        _call(x)
    eager = kops.count_snapshot()
    kops.reset_dispatch_counts()
    kops.reset_kernel_launch_counts()
    before = kops.count_snapshot()
    _call(x)                                       # the capture
    delta = kops.counts_since(before)
    assert delta == _calls(1)
    kops.add_counts(delta, -1)
    assert _nonzero(kops.count_snapshot()) == _nonzero(before)
    for _ in range(n):
        kops.add_counts(delta)                     # the replays
    assert kops.count_snapshot() == eager


def test_direct_call_uses_the_static_buffers():
    """Without a pool every call fills the same buffers and calls the
    function on them; a value of another shape or a missing input is
    refused, never broadcast."""
    seen = []

    def fn(a, b):
        seen.append((a, b))
        return a * b

    call = CapturedCall(fn, {"a": torch.zeros(2, 3), "b": torch.zeros(3)},
                        torch.device("cpu"))
    a, b = torch.randn(2, 3), torch.randn(3)
    assert torch.equal(call(a=a, b=b), a * b)
    assert torch.equal(call(a=2 * a, b=b), 2 * a * b)
    assert seen[0][0] is seen[1][0] is call.inputs["a"]
    assert seen[0][0] is not a and call.graph is None
    with pytest.raises(ValueError, match="shape"):
        call(a=torch.randn(1, 3), b=b)             # would broadcast
    with pytest.raises(ValueError, match="inputs"):
        call(a=a)


class _FakeGraph:
    """Stands in for `torch.cuda.CUDAGraph`: replay does nothing, or raises
    when `fail` is set."""
    fail = False

    def replay(self):
        if self.fail:
            raise RuntimeError("replay failed")


def _fake_capture(fail_on_exit):
    @contextlib.contextmanager
    def graph(g, pool=None):
        assert pool == "pool"
        yield
        if fail_on_exit:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
    return graph


def test_capture_then_replays(tallies, monkeypatch):
    """The first call runs eagerly and returns its own result, then
    captures (taking the capture's counts back); every later call replays
    and returns the captured outputs, the tallies advancing by one call's
    counts; a replay that fails raises."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture(False))
    x = torch.randn(3, 16)
    call = CapturedCall(_call, {"x": x}, torch.device("cpu"), pool="pool")
    first = call(x=x)
    assert first is not call.outputs and isinstance(call.graph, _FakeGraph)
    assert call.capture_s >= 0
    assert _nonzero(kops.count_snapshot()) == _calls(1)
    for k in (2, 3):
        assert call(x=x) is call.outputs
        assert _nonzero(kops.count_snapshot()) == _calls(k)
    call.graph.fail = True
    with pytest.raises(RuntimeError, match="replay failed"):
        call(x=x)


def test_capture_error_raises(tallies, monkeypatch):
    """A capture that fails raises out of the call, keeps no graph, and
    leaves the tallies at the one eager run's."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture(True))
    x = torch.randn(3, 16)
    call = CapturedCall(_call, {"x": x}, torch.device("cpu"), pool="pool")
    with pytest.raises(RuntimeError, match="capturing"):
        call(x=x)
    assert call.graph is None and call.outputs is None
    assert _nonzero(kops.count_snapshot()) == _calls(1)
