"""The port's training launcher on sharded meshes (`repro_torch.launch.
train` with `--model-parallel` > 1 or a ZeRO-3 arch), on four spawned gloo
ranks (`tests/torch_train_ranks.py`: torch and the port only, a `file://`
store, no network), against one-process runs:

- tensor-parallel llama3-1b on (2, 2) and (1, 4) meshes, ZeRO-3
  deepseek-coder-33b and llama4-maverick (MoE expert weights) on (4, 1)
  and (2, 2), reduced, 3 steps of 2 micro-batches with remat: each step's
  loss and the first step's gradients equal a one-process run's on the
  data ranks' batches side by side, within 2e-5 of each tensor's largest
  magnitude; the final parameters within `PARAM_FRAC` (see there), the
  same on every rank;
- each rank holds its share of every parameter and AdamW moment, as
  `shardings._fit` splits it (a ZeRO-3 leaf that both splits divide: 1/4);
- the AdamW update on shards issues no gather: its global norm, learning
  rate and clip scale mix with the DTensors as scalars;
- a sharded checkpoint restores onto its layout bit for bit, resumes on
  another mesh shape and on one process with the same losses, and the
  JAX launcher's step-0 checkpoint resumes on (2, 2) with the losses of
  the reference's own step on the same batches;
- a step that fails on rank 1 alone makes every rank retry and then
  restore once (`restores=1` everywhere). The spawn's join has a time
  limit, so a hang fails the tests rather than the suite;
- under `torchrun` (two processes, a local rendezvous) the launcher makes
  its process group itself; without one, `--model-parallel 2` is refused.
"""
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from torch_train_ranks import (CASES, COMMON, ELASTIC, FAIL_CALLS,
                               RESUME_STEPS, STEPS, launch, rank_main)

from repro.checkpoint.manager import CheckpointManager as JCkpt
from repro.configs.registry import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.data.pipeline import batch_iterator as jax_batches
from repro.launch import train as jtrain
from repro.models.transformer import build_model as jax_build
from repro.optim import adamw as jadamw
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, batch_iterator
from repro_torch.distributed import shardings as TS
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer import build_model
from repro_torch.optim import adamw
from repro_torch.train.step import TrainConfig, make_train_step
from repro_torch.tree import flatten_with_paths

WORLD = 4
SPAWN_TIMEOUT_S = 300
FRAC = 2e-5
# a gradient leaf below NOISE x the largest gradient is cancellation noise
# in both runs (llama4-maverick's top-1 router: its gate is 1 whatever the
# logits), held to that bound instead
NOISE = 1e-6
# The final parameters after 3 AdamW steps: within PARAM_FRAC of each
# leaf's largest magnitude, but for at most PARAM_LOOSE of the elements
# (AdamW's first steps move a weight by lr * g / (|g| + eps), so a
# gradient of cancellation noise lands anywhere in [-lr, lr]), which stay
# within 4 x the sum of the learning rates. Measured over five runs of
# these cases: at most 4.2e-7 of a leaf's largest magnitude apart in four,
# 4.2e-5 (llama4-maverick on (2, 2)) in one.
PARAM_FRAC, PARAM_LOOSE = 1e-5, 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module; the worker's own
    setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.devices = np.empty(shape)


def mesh_shape(mp):
    return (WORLD // mp, mp)


def concat_batches(vocab, dp, steps):
    """The batches the data ranks of a mesh with `dp` of them draw for
    `steps` steps, side by side, as one process takes them."""
    its = [batch_iterator(SyntheticCorpus(vocab, seed=0),
                          DataConfig(vocab, 16, 4, host_id=h, num_hosts=dp))
           for h in range(dp)]
    out = []
    for _ in range(steps):
        parts = [next(i) for i in its]
        out.append({k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]})
    return out


def one_process(arch, dp):
    """The case's run in one process on plain tensors: the launcher's
    init, optimizer and step on the data ranks' batches side by side."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt_cfg = adamw.AdamWConfig(lr=3e-3, total_steps=STEPS)
    opt = adamw.init_state(opt_cfg, params)
    step = make_train_step(model, opt_cfg,
                           TrainConfig(num_microbatches=2, remat=True))
    grads, losses = {}, []
    apply = adamw.apply_updates

    def first_grads(c, p, g, s):
        if not grads:
            grads.update({"/".join(map(str, k)): v.detach()
                          for k, v in flatten_with_paths(g)})
        return apply(c, p, g, s)

    adamw.apply_updates = first_grads
    try:
        for b in concat_batches(cfg.vocab, dp, STEPS):
            params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                                for k, v in b.items()})
            losses.append(float(m["loss"]))
    finally:
        adamw.apply_updates = apply
    lrs = sum(float(adamw.lr_at(opt_cfg, torch.tensor(s)))
              for s in range(1, STEPS + 1))
    return {"losses": losses, "grads0": grads, "lrs": lrs,
            "params": {"/".join(map(str, k)): v
                       for k, v in flatten_with_paths(params)}}


def reference_losses(ckpt_dir):
    """The JAX package's step from the JAX launcher's step-0 checkpoint, on
    the (2, 2) mesh's batches side by side, with the launcher's defaults."""
    jcfg = jax_get_config("llama3-1b").reduced()
    jm = jax_build(jcfg)
    target = jm.init(jax.random.PRNGKey(0))
    opt_cfg = jadamw.AdamWConfig(lr=3e-3, total_steps=RESUME_STEPS)
    state = JCkpt(ckpt_dir).restore(0, target={
        "params": target, "opt": jadamw.init_state(opt_cfg, target)})
    step = jax.jit(jax_make_train_step(jm, opt_cfg,
                                       JTrainConfig(remat=False)))
    its = [jax_batches(JCorpus(jcfg.vocab, seed=0),
                       JDataConfig(jcfg.vocab, 16, 4, host_id=h,
                                   num_hosts=2)) for h in range(2)]
    params, opt, losses = state["params"], state["opt"], []
    for _ in range(RESUME_STEPS):
        parts = [next(i) for i in its]
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' records, the one-process runs of every case and the
    reference's losses (computed while the ranks run)."""
    out = tmp_path_factory.mktemp("train_ranks")
    jdir = out / "jax"
    jtrain.main(["--arch", "llama3-1b", "--reduced", "--batch", "4",
                 "--seq", "16", "--steps", "0", "--workdir", str(jdir)])
    ref_ckpt = jdir / "ckpt" / "step_000000000"
    ctx = tmp.start_processes(
        rank_main, args=(WORLD, str(out / "store"), str(out), str(ref_ckpt)),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        plain = {name: one_process(arch, mesh_shape(mp)[0])
                 for name, (arch, mp) in CASES.items()}
        ref = reference_losses(str(jdir / "ckpt"))
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the ranks hung"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    recs = [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]
    return {"out": out, "ranks": recs, "plain": plain, "reference": ref}


def assert_close(got, want, frac=FRAC, what=""):
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    assert err <= frac * scale, (what, err, scale)


def finished(rec, step, failures=0, restores=0):
    return f"finished at step {step}; failures={failures} " \
        f"restores={restores}" in rec["lines"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_runs_match_one_process(ranks, case):
    want = ranks["plain"][case]
    first = ranks["ranks"][0][case]
    for rec in ranks["ranks"]:
        rec = rec[case]
        assert finished(rec, STEPS) and rec["end"] == STEPS
        assert_close(torch.tensor(rec["losses"]),
                     torch.tensor(want["losses"]), what="losses")
        assert sorted(rec["grads0"]) == sorted(want["grads0"])
        top = max(float(g.abs().max()) for g in want["grads0"].values())
        for k, g in want["grads0"].items():
            if float(g.abs().max()) <= NOISE * top:
                assert float(rec["grads0"][k].abs().max()) <= NOISE * top, k
            else:
                assert_close(rec["grads0"][k], g, what=k)
        for k, p in rec["params"].items():      # one replica everywhere
            assert torch.equal(p, first["params"][k]), k
    loose = total = 0
    for k, w in want["params"].items():
        diff = (first["params"][k] - w).abs()
        loose += int((diff > PARAM_FRAC * w.abs().max()).sum())
        total += w.numel()
        assert float(diff.max()) <= 4 * want["lrs"], k
    assert loose <= PARAM_LOOSE * total, (loose, total)


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_rank_holds_its_share(ranks, case):
    """Every parameter and both of its moments: this rank's elements are
    the whole count over the ranks that split it, as `_fit` decides; a
    ZeRO-3 mesh keeps a quarter of the bytes or less on each rank."""
    arch, mp = CASES[case]
    fake = FakeMesh(mesh_shape(mp))
    shapes = build_model(get_config(arch).reduced()).init_shapes()
    specs = {"/".join(map(str, k)): s.spec for k, s in flatten_with_paths(
        TS.param_shardings(fake, shapes, arch))}
    sizes = dict(zip(fake.axis_names, mesh_shape(mp)))
    for rec in ranks["ranks"]:
        rec, local, total = rec[case], 0, 0
        for key, (n_local, n) in rec["counts"].items():
            if key == "opt/step":
                assert n_local == n == 1
                continue
            spec = specs[key.split("/", 2 if key.startswith("opt/")
                                   else 1)[-1]]
            split = int(np.prod([sizes[a] for e in spec if e is not None
                                 for a in ((e,) if isinstance(e, str)
                                           else e)]))
            assert n_local * split == n, (key, n_local, n, spec)
            local, total = local + n_local, total + n
        if arch in TS.ZERO3_ARCHS:
            assert local <= 0.26 * total, (local, total)


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_on_shards_gathers_nothing(ranks, case):
    """AdamW's update of the first step on each rank's shards: its only
    collectives are the global norm's all-reduces of one element each."""
    for rec in ranks["ranks"]:
        comms = rec[case]["update_comms"]
        assert comms and set(comms) == {("all_reduce", 1)}, comms


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_checkpoint_restores_bit_for_bit(ranks, case):
    for rec in ranks["ranks"]:
        assert rec[case]["restored_bit_equal"]


@pytest.mark.parametrize("case", sorted(ELASTIC))
def test_sharded_checkpoint_resumes_elsewhere(ranks, case, tmp_path):
    """The (2, 2) run's checkpoint on a (1, 4) mesh (its data extent of 1
    draws one process's batches) and in one process: resumed from step 3,
    the same losses."""
    shutil.copytree(ranks["out"] / case / "ckpt", tmp_path / "ckpt")
    _, alone = launch(["--arch", CASES[case][0], "--steps",
                       str(RESUME_STEPS), "--workdir", str(tmp_path)]
                      + COMMON)
    end = STEPS + RESUME_STEPS
    assert "resumed from step 3" in alone["lines"] and finished(alone, end)
    for rec in ranks["ranks"]:
        rec = rec[ELASTIC[case]]
        assert "resumed from step 3" in rec["lines"] and finished(rec, end)
        assert_close(torch.tensor(rec["losses"]),
                     torch.tensor(alone["losses"]), what="losses")


def test_references_checkpoint_resumes_on_a_mesh(ranks):
    """The JAX launcher's step-0 checkpoint on the (2, 2) mesh: the
    reference's losses on the same batches."""
    want = torch.tensor(ranks["reference"])
    for rec in ranks["ranks"]:
        rec = rec["ref_resume"]
        assert "resumed from step 0" in rec["lines"]
        assert finished(rec, RESUME_STEPS)
        assert_close(torch.tensor(rec["losses"]), want, what="losses")


def test_a_failure_on_one_rank_restores_every_rank(ranks):
    """Rank 1's step fails on every attempt of the third step: every rank
    counts the three failures, restores once from step 2 and finishes."""
    n = len(FAIL_CALLS)
    for rec in ranks["ranks"]:
        rec = rec["failing"]
        assert (rec["failures"], rec["restores"], rec["end"]) == \
            (n, 1, STEPS)
        assert finished(rec, STEPS, failures=n, restores=1)


def test_torchrun_starts_the_sharded_launcher(tmp_path):
    """Under `torchrun` (its environment names the group) the launcher
    makes the gloo group itself and trains tensor-parallel on it."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "llama3-1b", "--model-parallel", "2", "--steps", "1",
         "--workdir", str(tmp_path)] + COMMON,
        env=env, cwd=tmp_path, capture_output=True, text=True,
        timeout=SPAWN_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("finished at step 1; failures=0 restores=0") \
        == 2, out.stdout


def test_model_parallel_needs_as_many_ranks():
    with pytest.raises(SystemExit, match="--model-parallel 2 needs"):
        ttrain.main(["--arch", "llama3-1b", "--reduced", "--device", "cpu",
                     "--model-parallel", "2", "--steps", "1"])
