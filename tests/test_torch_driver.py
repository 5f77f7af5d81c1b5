"""The port's fault-tolerant driver (`repro_torch.runtime.driver`) and
training launcher (`repro_torch.launch.train`) against the JAX package's:

- `StepStats`, `ElasticMesh.shape_for`, `straggler_rate` and
  `should_rescale` on the same inputs give the same answers;
- a flaky step (one transient failure) and a dying step (a persistent one,
  twice) through both drivers, from the same parameters and batches: the
  same failures, restores, final step, latest checkpoint, and the same
  batch at every call. Neither driver rewinds the batch iterator on a
  restore (ROADMAP Queue C, R9), which the batch of each call pins; the
  state just after a restore is the checkpoint's, bit for bit;
- the reference launcher's run, then the port's launcher resuming the
  reference's own step-0 checkpoint: it resumes, ends at the same step, and
  a second port run resumes from the port's last step.

Final parameters after several steps are held as `test_torch_train.py`
holds one step, summed over the steps: within 1e-5 of each leaf's largest
magnitude, except where AdamW turned a gradient of cancellation noise into
an update anywhere in [-lr, lr] (at most 1 % of the elements, within the
updates' bound, 4 × the sum of the learning rates).
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCkpt
from repro.configs.registry import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.data.pipeline import batch_iterator as jax_batches
from repro.launch import train as jtrain
from repro.models.transformer import build_model as jax_build
from repro.optim import adamw as jadamw
from repro.runtime import driver as JD
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import interop
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, batch_iterator
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import driver as TD
from repro_torch.train.step import TrainConfig, make_train_step
from repro_torch.tree import flatten_with_paths

LEAF_FRAC = 1e-5
SMALL = dict(n_layers=2, d_model=64, vocab=256, d_ff=128)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module; the worker's own
    setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lr_sum(opt_cfg, n):
    return sum(float(adamw.lr_at(opt_cfg, torch.tensor(s)))
               for s in range(1, n + 1))


def assert_run_close(got: dict, want: dict, lrs: float):
    """`got`, `want`: {path: array} of the same leaves."""
    assert sorted(got) == sorted(want)
    loose = total = 0
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        diff = np.abs(np.asarray(got[k], np.float32) - w)
        off = diff > LEAF_FRAC * np.abs(w).max()
        loose += int(off.sum())
        total += w.size
        assert diff.max(initial=0.0) <= 4 * lrs, (k, diff.max())
    assert loose <= 1e-2 * total, (loose, total)


# ---------------------------------------------------------------------------
# the policies
# ---------------------------------------------------------------------------

def test_step_stats_flag_the_same_stragglers():
    rng = np.random.default_rng(0)
    dts = rng.uniform(0.9, 1.1, 60)
    dts[[25, 26, 40]] = [5.0, 4.0, 4.0]
    j, t = JD.StepStats(), TD.StepStats()
    for i, dt in enumerate(dts):
        assert t.record(i, dt, 2.5, 0.1) == j.record(i, dt, 2.5, 0.1)
    assert t.stragglers == j.stragglers == [25, 26, 40]
    assert t.ewma == j.ewma and t.count == j.count == 60


@pytest.mark.parametrize("mp", [1, 2, 4, 16])
def test_elastic_mesh_sizing(mp):
    for n in [1, 2, 3, 4, 7, 8, 28, 32, 100, 512]:
        assert TD.ElasticMesh(mp).shape_for(n) == \
            JD.ElasticMesh(mp).shape_for(n)
    mesh = TD.ElasticMesh(mp).make(list(range(32)), device_type="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == JD.ElasticMesh(mp).shape_for(32)


def test_one_process_mesh():
    mesh = TD.ElasticMesh(1).make(device_type="cpu")
    assert mesh.devices.shape == (1, 1) and mesh.size == 1


def test_straggler_rate_and_rescale():
    cfg = dict(straggler_window=20)
    for strag in ([], [3], list(range(10, 16)), list(range(30, 36))):
        drivers = [D.TrainDriver(None, None, D.RuntimeConfig(**cfg))
                   for D in (JD, TD)]
        for d in drivers:
            d.stats.count = 40
            d.stats.stragglers = list(strag)
        assert drivers[0].straggler_rate == drivers[1].straggler_rate
        assert drivers[0].should_rescale() == drivers[1].should_rescale()
    d = TD.TrainDriver(None, None, TD.RuntimeConfig())
    assert d.straggler_rate == 0.0


# ---------------------------------------------------------------------------
# faults, through both drivers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    jcfg = jax_get_config("llama3-1b").reduced(**SMALL)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("llama3-1b").reduced(**SMALL))
    opt_cfg = jadamw.AdamWConfig(lr=1e-3)
    jstep = jax.jit(jax_make_train_step(jm, opt_cfg, JTrainConfig(remat=False)))
    tstep = make_train_step(tm, adamw.AdamWConfig(lr=1e-3),
                            TrainConfig(remat=False))
    return jcfg, jp, jstep, tstep, opt_cfg


def faulty(step, fail_on, fed, to_device=False):
    """`step` that fails on the calls numbered in `fail_on`; `fed` gets
    each call's batch."""
    def run(p, o, b):
        fed.append(b)
        if len(fed) in fail_on:
            raise RuntimeError("injected device error")
        if to_device:
            b = {k: torch.from_numpy(v) for k, v in b.items()}
        return step(p, o, b)
    return run


def counted(it, seen):
    for b in it:
        seen.append(b)
        yield b


def run_both(small, tmp_path, fail_on, rcfg, n):
    jcfg, jp, jstep, tstep, opt_cfg = small
    out = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        seen, fed = [], []
        if pkg == "jax":
            mgr, D = JCkpt(str(d)), JD
            params, opt = jp, jadamw.init_state(opt_cfg, jp)
            step = faulty(jstep, fail_on, fed)
            it = jax_batches(JCorpus(jcfg.vocab, seed=0),
                             JDataConfig(jcfg.vocab, 32, 4))
        else:
            mgr, D = CheckpointManager(str(d)), TD
            params = interop.tree_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")
            opt = adamw.init_state(adamw.AdamWConfig(lr=1e-3), params)
            step = faulty(tstep, fail_on, fed, to_device=True)
            it = batch_iterator(SyntheticCorpus(jcfg.vocab, seed=0),
                                DataConfig(jcfg.vocab, 32, 4))
        mgr.save(0, {"params": params, "opt": opt}, blocking=True)
        driver = D.TrainDriver(step, mgr, D.RuntimeConfig(**rcfg))
        (p, _), end = driver.run(params, opt, counted(it, seen), num_steps=n)
        out[pkg] = dict(driver=driver, end=end, latest=mgr.latest_step(),
                        params=p, batches=len(seen),
                        fed=[[id(x) for x in seen].index(id(b))
                             for b in fed])
    j, t = out["jax"], out["torch"]
    for k in ("end", "latest", "batches", "fed"):
        assert t[k] == j[k], k
    for k in ("failures", "restores"):
        assert getattr(t["driver"], k) == getattr(j["driver"], k), k
    assert t["driver"].stats.count == j["driver"].stats.count
    want = {tuple(getattr(k, "key", k) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                j["params"])[0]}
    got = {path: v.numpy() for path, v in flatten_with_paths(t["params"])}
    assert_run_close(got, want, lr_sum(adamw.AdamWConfig(lr=1e-3), n + 4))
    return j, t


def test_flaky_step_retries_as_the_reference(small, tmp_path):
    j, t = run_both(small, tmp_path, {3}, dict(checkpoint_every=4,
                                               max_retries=2), 8)
    assert t["end"] == 8 and t["driver"].failures == 1
    assert t["driver"].restores == 0 and t["latest"] == 8


def test_dying_step_restores_as_the_reference(small, tmp_path):
    """Calls 4-7 fail: with one retry, two restores to step 2. Neither
    package rewinds the iterator (R9): step 2 runs again on the sixth batch
    drawn, not on the third it first ran on."""
    j, t = run_both(small, tmp_path, {4, 5, 6, 7},
                    dict(checkpoint_every=2, max_retries=1), 6)
    assert t["end"] == 6 and t["driver"].restores == 2
    assert t["driver"].failures == 4
    # the batch of each call: steps 0-2, step 3 twice, step 2 twice (both
    # failed), then steps 2-5 on the batches after
    assert t["fed"] == [0, 1, 2, 3, 3, 4, 4, 5, 6, 7, 8] == j["fed"]


def test_restore_puts_back_the_checkpoint_bit_for_bit(small, tmp_path):
    """The state the driver trains on just after a restore is the
    checkpoint's."""
    jcfg, jp, _, tstep, _ = small
    params = interop.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    opt = adamw.init_state(adamw.AdamWConfig(lr=1e-3), params)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"params": params, "opt": opt}, blocking=True)
    seen = []

    def step(p, o, b):
        seen.append((p, o))
        if len(seen) in (3, 4):
            raise RuntimeError("injected persistent failure")
        return tstep(p, o, {k: torch.from_numpy(v) for k, v in b.items()})

    driver = TD.TrainDriver(step, mgr, TD.RuntimeConfig(checkpoint_every=2,
                                                        max_retries=1))
    it = batch_iterator(SyntheticCorpus(jcfg.vocab, seed=0),
                        DataConfig(jcfg.vocab, 32, 4))
    _, end = driver.run(params, opt, it, num_steps=3)
    assert end == 3 and driver.restores == 1
    back = CheckpointManager(str(tmp_path)).restore(2)
    p, o = seen[4]
    for path, v in flatten_with_paths({"params": p, "opt": o}):
        assert torch.equal(v, back["::".join(map(str, path))]), path


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "llama3-1b", "--reduced", "--batch", "4", "--seq", "16",
          "--checkpoint-every", "2"]


def test_launcher_resumes_the_references_checkpoint(tmp_path, capsys):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jtrain.main(LAUNCH + ["--steps", "4", "--workdir", str(jdir)])
    assert "finished at step 4" in capsys.readouterr().out
    os.makedirs(tdir / "ckpt")
    shutil.copytree(jdir / "ckpt" / "step_000000000",
                    tdir / "ckpt" / "step_000000000")
    run = ttrain.main(LAUNCH + ["--steps", "4", "--workdir", str(tdir),
                                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed from step 0" in out
    assert "finished at step 4; failures=0 restores=0" in out
    assert run["step"] == 4 and run["driver"].stats.count == 4
    want = JCkpt(str(jdir / "ckpt")).restore(4)
    got = {k: v.numpy() for k, v in
           CheckpointManager(str(tdir / "ckpt")).restore(4).items()}
    lrs = lr_sum(adamw.AdamWConfig(lr=3e-3, total_steps=4), 4)
    params = {k: v for k, v in want.items() if k.startswith("params")}
    assert_run_close({k: got[k] for k in params}, params, lrs)
    assert int(got["opt::step"]) == int(want["opt::step"]) == 4
    # the port's own checkpoint resumes too
    ttrain.main(LAUNCH + ["--steps", "2", "--workdir", str(tdir),
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "finished at step 6" in out
    assert CheckpointManager(str(tdir / "ckpt")).latest_step() == 6


def test_launcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        ttrain.main(["--reduced", "--steps", "1"])
