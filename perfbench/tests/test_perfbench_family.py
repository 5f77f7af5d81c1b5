"""A configuration names its model family (`perfbench/families/<family>.py`).

* The dense family gives what the harness gave before it was moved there:
  the same draws, the same packed program, the same work counts and the
  same check numbers, against values recorded from the harness before the
  move (`dense_identity.json`).
* A new family is added by a file alone: a stub family in a directory of
  its own runs a whole cell to `correct`, and the readers count its work.
* A configuration that names an unknown family fails where the cell is
  read, with the family's name in the message.
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench.harness import spec
from perfbench.harness import trace as tr
from perfbench.harness.cell import Runner, StepRecord, pick_sample, run_cell

import test_perfbench_gate as gate

HERE = Path(__file__).resolve().parent
PINS = json.loads((HERE / "dense_identity.json").read_text())
BENCH = spec.load_benchmark()
SEED = 2**33 + 5


@pytest.fixture(autouse=True)
def one_thread():
    """The pins were recorded with one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = {"qwen_f32": lambda: gate.small_config("float32"),
        "qwen_bf16": lambda: gate.small_config("bfloat16"),
        "granite_f32": gate.small_granite}
STEPS = {"decode": StepRecord(0, 1, [100, 2000, 6000, 17], []),
         "prefill": StepRecord(0, 1, [57, 300], [(1024, 1000, True),
                                                 (0, 77, False),
                                                 (2048, 5, True)])}


def digest(tree) -> str:
    """sha256 over a tree's paths, dtypes, shapes and bytes."""
    h = hashlib.sha256()

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t, key=str):
                walk(t[k], path + "/" + str(k))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + "/" + str(i))
        elif not isinstance(t, torch.Tensor):
            h.update((path + repr(t)).encode())
        else:
            h.update(path.encode())
            h.update(str(t.dtype).encode())
            h.update(str(tuple(t.shape)).encode())
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    walk(tree, "")
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(TINY))
def test_dense_draws_as_before(name):
    cfg = TINY[name]()
    assert digest(spec.family(cfg).draw(cfg, SEED, "cpu")) \
        == PINS["draw"][name]


@pytest.mark.parametrize("name", sorted(TINY))
def test_dense_packs_as_before(name):
    cfg = TINY[name]()
    rn = Runner(cfg, gate.TRAFFIC, SEED, "cpu", spec.family(cfg))
    assert digest(rn.engine.adapter.params) == PINS["packed"][name]


def _work_cases():
    cfgs = {c["name"]: (lambda c=c: spec.config(BENCH, c["name"]))
            for c in BENCH["configs"]}
    cfgs.update(qwen_f32=TINY["qwen_f32"], granite_f32=gate.small_granite)
    return [(f"{k}.{s}", make, step) for k, make in cfgs.items()
            for s, step in STEPS.items()]


@pytest.mark.parametrize("key, make, step", _work_cases(),
                         ids=[c[0] for c in _work_cases()])
def test_dense_counts_as_before(key, make, step):
    cfg = make()
    fam = spec.family(cfg)
    assert fam.step_work(fam.dims(cfg), step) == PINS["step_work"][key]


def fixed_drive(cfg, seed, control=False, steps=12) -> dict:
    """A run with a fixed number of loop steps in place of the timed window
    (so the sample is the same on every machine), then the check."""
    fam = spec.family(cfg)
    lim = spec.limits(gate.CELL)
    rn = Runner(cfg, gate.TRAFFIC, seed, "cpu", fam)
    rn.warm_up(seed)
    rn.prime()
    for _ in range(steps):
        rn.step()
    held = [fam.held(rn.engine, rn.reqs[rid],
                     lim.layers_held(rn.dims["n_layers"]))
            for rid in pick_sample(rn, gate.TRAFFIC.sample_requests, seed)]
    out = fam.numbers(cfg, seed, "cpu", held, lim)
    if control:
        out["control"] = fam.numbers(cfg, seed, "cpu", held, lim,
                                     control=True)
    return out


GATE_CASES = [
    ("pass_float32", None, "float32", SEED, False),
    ("pass_bfloat16", None, "bfloat16", SEED, False),
    ("state_unchanged", gate._kv_writes_dropped, "float32", SEED, False),
    ("half_the_batch", gate._half_the_batch, "float32", SEED, False),
    ("attention_wrong", gate._attention_left_out, "float32", SEED, False),
    ("token_altered", gate._token_altered, "float32", SEED, False),
    ("control", None, "bfloat16", 2**31 + 9, True)]


@pytest.mark.parametrize("name, fault, dtype, seed, control", GATE_CASES,
                         ids=[c[0] for c in GATE_CASES])
def test_dense_checks_as_before(name, fault, dtype, seed, control,
                                monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    got = fixed_drive(gate.small_config(dtype), seed, control)
    assert got == PINS["gate"][name]


STUB = '''"""A family that serves the dense model under another name, with a
kernel group of its own."""
import importlib.util

_spec = importlib.util.spec_from_file_location("stub_dense", {dense!r})
dense = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(dense)

dims, draw, build = dense.dims, dense.draw, dense.build
held, numbers = dense.held, dense.numbers
KERNELS = {{"stub_scan": ("stub_scan_kernel",)}}
WORK_CALLS = []


def step_work(dims, step):
    WORK_CALLS.append(step)
    return dense.step_work(dims, step)
'''


def test_a_family_is_added_by_a_file_alone(tmp_path, monkeypatch):
    fams = tmp_path / "families"
    fams.mkdir()
    (fams / "stub.py").write_text(
        STUB.format(dense=str(spec.FAMILIES / "dense.py")))
    monkeypatch.setattr(spec, "FAMILIES", fams)
    cfg = gate.small_config("float32")
    cfg["family"] = "stub"
    out = run_cell(cfg, gate.TRAFFIC, seed=SEED, seconds=1.0, trace=False,
                   device="cpu", t_start=time.perf_counter(),
                   limits=spec.limits(gate.CELL))
    assert out["correct"], out["checks"]
    assert out["check"]["positions"] >= 40
    ctx = out["ctx"]
    assert ctx.family.__name__ == "perfbench.families.stub"
    # the readers count the work by the family's step_work
    ctx.trace_records = ctx.records[:4]
    ctx.trace = {"window_s": 1.0, "busy_s": 0.5, "other_s": 0.0,
                 "group_s": {"int4_matmul": 0.25}}
    dense = ctx.family.dense
    want = sum(dense.step_work(ctx.dims, r)["ideal_s"]
               for r in ctx.trace_records)
    assert spec.reader("mfu.decode")(ctx) == pytest.approx(100.0 * want)
    assert ctx.family.WORK_CALLS[-4:] == ctx.trace_records
    groups = {**tr.HAND_WRITTEN, **ctx.family.KERNELS}
    assert tr.group_of("void stub_scan_kernel<4>", groups) == "stub_scan"
    assert tr.group_of("void stub_scan_kernel<4>") is None


def test_an_unknown_family_fails_in_spec():
    cfg = gate.small_config("float32")
    cfg["family"] = "nonesuch"
    with pytest.raises(KeyError, match="nonesuch"):
        spec.family(cfg)
    del cfg["family"]
    with pytest.raises(KeyError, match="family None"):
        spec.family(cfg)


def test_an_unknown_family_cannot_read_the_cell(tmp_path):
    """`run.py` exits 2, before any look for a card, and prints no
    result."""
    root = Path(spec.ROOT)
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = tmp_path / "perfbench" / "configs" / "qwen1.5-0.5b-w4a4.json"
    cfg = json.loads(p.read_text())
    cfg["family"] = "nonesuch"
    p.write_text(json.dumps(cfg))
    run = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "qwen1.5-0.5b.longctx", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert run.returncode == 2, run.stderr
    assert run.stdout.strip() == ""
    assert "cannot read the cell" in run.stderr
    assert "nonesuch" in run.stderr
