"""The port's examples (`repro_torch.examples`) at their own reduced sizes
on the CPU: the quickstart reports a finite error, and the served example
gives every request its tokens, a valid telemetry snapshot, and the same
tokens when its quantized model is served again.
"""
import math

import pytest
import torch

from repro_torch.examples import quickstart, serve_quantized


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module; the worker's own
    setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_main(capsys):
    err = quickstart.main(device="cpu")
    assert math.isfinite(err) and err > 0
    assert "MassDiff" in capsys.readouterr().out


def test_serve_quantized_main_then_serve_again(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    out = serve_quantized.main(device="cpu", trace_path=str(trace))
    done = {r.rid: r.generated for r in out["done"]}
    assert sorted(done) == list(range(6))
    assert all(len(g) == serve_quantized.MAX_NEW for g in done.values())
    assert out["snapshot"]["counters"]
    assert trace.exists()
    again, _ = serve_quantized.serve(out["qmodel"], out["params"])
    assert {r.rid: r.generated for r in again} == done
    assert "served 6 requests" in capsys.readouterr().out
