"""The paper's harnesses in the port (`repro_torch.paper`) at a tiny size
on the CPU: the surrogate's cache, every harness's `main`, MassDiff's
speed and the runner. Their numbers are held against the JAX package's
harness in `tests/test_torch_paper.py`; here each table must print finite
perplexities in its format.
"""
import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bench import kernel_bench
from repro_torch.paper import (common, fig3_delta, fig45_bounds,
                               massdiff_speed, run as paper_run,
                               table1_blocksize, table2_formats,
                               table6_permutations)
from repro_torch.tree import leaves


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module (under several
    test workers a thread pool per worker oversubscribes the cores); the
    worker's own setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def test_bench_model_trains_then_restores_from_its_cache(tmp_path):
    first = common.bench_model(2, device="cpu", cache_dir=str(tmp_path))
    again = common.bench_model(2, device="cpu", cache_dir=str(tmp_path))
    for a, b in zip(leaves(first[2]), leaves(again[2])):
        assert torch.equal(a, b)
    assert common.CheckpointManager(str(tmp_path)).latest_step() == 2


@pytest.fixture(scope="module")
def tiny_args(tmp_path_factory):
    return ["--device", "cpu", "--train-steps", "2", "--cache-dir",
            str(tmp_path_factory.mktemp("bench"))]


@pytest.mark.parametrize("name,fn,extra", [
    ("fig3", fig3_delta.main, []),
    ("fig45", fig45_bounds.main, []),
    ("table1", table1_blocksize.main, ["--block-sizes", "16", "--n-eval", "1"]),
    ("table5", table1_blocksize.main, ["--rounding", "rtn", "--block-sizes",
                                       "256", "--n-eval", "1"]),
    ("table6", table6_permutations.main, ["--n-eval", "1"]),
    ("table2", table2_formats.main, ["--formats", "int4", "--n-eval", "1"]),
])
def test_harness_main_at_a_tiny_size(tiny_args, name, fn, extra):
    out = _stdout(fn, tiny_args + extra).splitlines()
    assert out[0].startswith("# ")
    last = [ln.split(",")[-1] for ln in out[1:]
            if "," in ln and not ln.startswith(("#", "method", "perm"))]
    nums = [float(v) for v in last if v not in ("True", "False")]
    assert nums and np.all(np.isfinite(nums))


def test_massdiff_speed_and_the_runner(monkeypatch, tiny_args):
    monkeypatch.setattr(massdiff_speed, "LAYERS", 1)
    out = _stdout(massdiff_speed.main)
    assert "layers,1" in out and "under_two_minutes,True" in out
    # the runner: every job reports, a failing one does not end the run
    calls = []
    for mod in (fig3_delta, fig45_bounds, table1_blocksize,
                table6_permutations, table2_formats):
        monkeypatch.setattr(mod, "main", lambda argv, m=mod: calls.append(
            (m.__name__, argv)))
    monkeypatch.setattr(kernel_bench, "main", lambda argv: calls.append(
        (kernel_bench.__name__, argv)))
    monkeypatch.setattr(massdiff_speed, "main", lambda argv: 1 / 0)
    out = _stdout(paper_run.main, tiny_args)
    assert "massdiff_speed" in out and "fail:ZeroDivisionError" in out
    assert "table34_opcounts" in out and "===== table2_formats" in out
    assert "kernel_bench" in out and "===== kernel_bench" in out
    assert len(calls) == 7 and all(a[-len(tiny_args):] == tiny_args
                                   for _, a in calls[:-1])
    # the kernel bench, last: the runner's --device alone, and its record
    # out of artifacts/
    name, argv = calls[-1]
    assert name == kernel_bench.__name__
    assert argv[:2] == ["--device", "cpu"] and argv[2] == "--out"
    assert len(argv) == 4 and "artifacts" not in Path(argv[3]).parts


def test_the_runners_kernel_bench_job_at_a_tiny_size(tmp_path):
    out = tmp_path / "BENCH_kernels.json"
    _stdout(kernel_bench.main, ["--smoke", "--reduced", "--device", "cpu",
                                "--out", str(out)])
    rec = json.loads(out.read_text())["history"][-1]
    assert rec["smoke"] and rec["reduced"] and rec["rows"]
    assert rec["device"]["platform"] == "cpu"
