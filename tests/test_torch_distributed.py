"""The port's distributed seam (`repro_torch.distributed`) against the JAX
package's:

- the axis rules and the mesh context: `AXIS_RULES`, `logical_to_spec`
  (with and without the serving overrides), `mesh_axis_size`; `shard_act`
  is the identity without a mesh and on a one-device mesh;
- the sharding rules, for every arch of the registry at full size, leaf by
  leaf: `param_shardings` (and `param_spec` with and without ZeRO-3 for
  every leaf), `opt_state_shardings`, `batch_shardings`, `cache_shardings`
  and `serve_cache_shardings`, on stand-in meshes of (4, 2) and
  (2, 16, 16) devices. The trees carry shapes only: the reference's
  `jax.eval_shape` of its init, the port's meta tensors. The reference's
  `NamedSharding` needs a real mesh, so its module's constructor is
  replaced in the test by one that keeps the spec;
- on two gloo ranks (spawned, a `file://` store, no network):
  `compressed_psum` against the reference's under `jax.vmap(...,
  axis_name="pod")` over the two ranks' stacked inputs, each rank's result
  within 1 ulp of its row; `restore_sharded` placing a leaf as `Shard(d)`
  per its spec; `shard_act` redistributing a DTensor; the training
  launcher data-parallel over the two ranks: the same parameters on both,
  and those of one process stepping on the two ranks' batches side by
  side (the train-step tolerances of `test_torch_driver.py`).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from torch_dist_ranks import LAUNCH, inputs, rank_main

from repro.configs.registry import get_config as jax_get_config
from repro.distributed import compression as JC
from repro.distributed import context as JX
from repro.distributed import shardings as JS
from repro.models.transformer import build_model as jax_build
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed import compression as TC
from repro_torch.distributed import context as TX
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, batch_iterator
from repro_torch.distributed import shardings as TS
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer import build_model
from repro_torch.optim import adamw
from repro_torch.train.step import TrainConfig, make_train_step
from repro_torch.tree import flatten_with_paths, leaves

SPAWN_TIMEOUT_S = 120


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(params=sorted(MESHES))
def mesh(request):
    return FakeMesh(*MESHES[request.param])


@pytest.fixture
def jax_specs(monkeypatch):
    """The reference's sharding functions return bare specs."""
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)


def ref_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p):
            tuple(s) for p, s in flat}


def port_specs(tree):
    return {p: tuple(s.spec) for p, s in flatten_with_paths(tree)}


def jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p): v
            for p, v in flat}


def ulp(x, mantissa_bits):
    """One unit in the last place of each value, for a float format with
    `mantissa_bits` stored mantissa bits."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, e - 1 - mantissa_bits)


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# rules and context
# ---------------------------------------------------------------------------

LOGICAL = [None] + sorted(JX.AXIS_RULES)


def test_axis_rules_are_the_references():
    assert TX.AXIS_RULES == JX.AXIS_RULES
    assert TS.ZERO3_ARCHS == JS.ZERO3_ARCHS
    assert TS.SERVE_RULES == JS.SERVE_RULES


@pytest.mark.parametrize("rules", [None, "serve"])
def test_logical_to_spec_matches(mesh, rules):
    over = JS.SERVE_RULES if rules else None
    with JX.mesh_context(mesh, over), TX.mesh_context(mesh, over):
        for a in LOGICAL:
            for b in LOGICAL:
                want = tuple(JX.logical_to_spec((a, b), mesh))
                assert tuple(TX.logical_to_spec((a, b), mesh)) == want
        for name in ("pod", "data", "model", "other"):
            assert TX.mesh_axis_size(name) == JX.mesh_axis_size(name)
        assert TX.current_mesh() is mesh
    assert TX.current_mesh() is None and TX.mesh_axis_size("data") == 1
    assert TX.current_rules() == JX.current_rules()


def test_partition_spec_normalises_as_jax():
    P = jax.sharding.PartitionSpec
    for entries in [(("data",), None), (["pod", "data"],), ((),),
                    ("model", ("pod", "data"))]:
        assert tuple(TX.P(*entries)) == tuple(P(*entries))


def test_shard_act_is_the_identity_off_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert TX.shard_act(x, ("batch", "embed")) is x
    with TX.mesh_context(TX.Mesh(np.zeros((1, 1), int), ("data", "model"),
                                 "cpu")):
        assert TX.shard_act(x, ("batch", "embed")) is x


def test_fit_and_cache_spec_fallbacks():
    m = FakeMesh((4, 2), ("data", "model"))
    assert tuple(TS._fit(TX.P("model", "data"), (7, 8), m)) == \
        tuple(JS._fit(jax.sharding.PartitionSpec("model", "data"), (7, 8), m))
    m = FakeMesh((4, 16), ("data", "model"))
    for shape in [(16, 8, 32768, 8, 64), (16, 8, 32768, 32, 64),
                  (16, 8, 100, 8, 64)]:
        assert tuple(TS.cache_spec("layers/k", shape, m)) == \
            tuple(JS.cache_spec("layers/k", shape, m))


# ---------------------------------------------------------------------------
# every arch's shardings, leaf by leaf
# ---------------------------------------------------------------------------

def shapes(arch):
    jm = jax_build(jax_get_config(arch))
    ref = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    port = build_model(get_config(arch)).init_shapes()
    want = {p: (tuple(v.shape), str(v.dtype)) for p, v in
            jax_paths(ref).items()}
    got = {p: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for p, v in flatten_with_paths(port)}
    assert got == want
    return jm, ref, port


def batch_trees(cfg, b, s):
    shp = {"tokens": (b, s), "labels": (b, s)}
    if cfg.frontend == "audio_frames":
        shp = {"frames": (b, s, 512), "labels": (b, s)}
    if cfg.frontend == "vision_patches":
        shp["patches"] = (b, 4, 1024)
    return ({k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in shp.items()},
            {k: meta(v, torch.int32) for k, v in shp.items()})


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shardings_match_for_every_leaf(arch, jax_specs):
    cfg = get_config(arch)
    jm, ref, port = shapes(arch)
    jopt = jax.eval_shape(
        lambda p: jadamw.init_state(jadamw.AdamWConfig(), p), ref)
    topt = adamw.init_state(adamw.AdamWConfig(), port)
    for shape, names in MESHES.values():
        m = FakeMesh(shape, names)
        assert port_specs(TS.param_shardings(m, port, arch)) == \
            ref_specs(JS.param_shardings(m, ref, arch))
        assert port_specs(TS.opt_state_shardings(m, topt, port, arch)) == \
            ref_specs(JS.opt_state_shardings(m, jopt, ref, arch))
        for zero3 in (False, True):
            paths, tl = TS._tree_paths(port)
            jpaths, jflat, _ = JS._tree_paths(ref)
            assert paths == jpaths
            for p, t, j in zip(paths, tl, jflat):
                got = TS._fit(TS.param_spec(p, t.dim(), m, zero3=zero3),
                              tuple(t.shape), m)
                want = JS._fit(JS.param_spec(p, j.ndim, m, zero3=zero3),
                               j.shape, m)
                assert tuple(got) == tuple(want), (p, zero3)
        for b in (8, 3):                 # 3: the batch dim falls back
            jb, tb = batch_trees(cfg, b, 64)
            assert port_specs(TS.batch_shardings(m, tb)) == \
                ref_specs(JS.batch_shardings(m, jb))
        if cfg.family == "encoder":
            continue
        for b, max_len in ((8, 4096), (2, 100)):   # seq fallback, none
            jc = jax.eval_shape(lambda: jm.init_cache(b, max_len))
            tc = build_model(cfg).init_cache(b, max_len, device="meta")
            assert port_specs(TS.cache_shardings(m, tc)) == \
                ref_specs(JS.cache_shardings(m, jc))
            assert port_specs(TS.serve_cache_shardings(m, tc)) == \
                ref_specs(JS.serve_cache_shardings(m, jc))
    assert tuple(TS.replicated(m).spec) == ()


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

def test_two_ranks_psum_restore_sharded_shard_act(tmp_path):
    world = 2
    w = np.arange(24, dtype=np.float32).reshape(4, 6)
    b = np.arange(3, dtype=np.float32)
    CheckpointManager(str(tmp_path / "ckpt")).save(
        1, {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
        blocking=True)
    ctx = tmp.start_processes(
        rank_main, args=(world, str(tmp_path / "store"),
                          str(tmp_path / "ckpt"), str(tmp_path)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the ranks hung"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    # the reference: psum/pmax over the vmapped "pod" axis of the stacked
    # inputs
    ins = [inputs(r) for r in range(world)]
    for k, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        x = jnp.stack([jnp.asarray(i[k], dt) for i in ins])
        want = np.asarray(jax.vmap(lambda v: JC.compressed_psum(v, "pod"),
                                   axis_name="pod")(x), np.float32)
        for r in range(world):
            got = np.load(tmp_path / f"rank{r}.npz")[k]
            assert np.all(np.abs(got - want[r])
                          <= ulp(want[r], 23 if k == "f32" else 7)), k
    # the launcher's data-parallel run: the same replica on both ranks, and
    # the single-process step on the two ranks' batches side by side
    outs = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    dp = [{k[4:]: o[k] for k in o.files if k.startswith("dp::")}
          for o in outs]
    assert all(int(o["dp_step"]) == 2 for o in outs)
    assert all(np.array_equal(dp[0][k], dp[1][k]) for k in dp[0])
    assert_run_close(dp[0], *single_process_run(world))
    for r in range(world):
        out = outs[r]
        np.testing.assert_array_equal(out["w_local"], w[:, 3 * r:3 * r + 3])
        np.testing.assert_array_equal(out["w_full"], w)
        np.testing.assert_array_equal(out["b_local"], b)
        np.testing.assert_array_equal(out["act_local"], w[2 * r:2 * r + 2])


def single_process_run(world):
    """The launcher's two steps in one process, each on the ranks' batches
    concatenated: ({path: array} of the final params, the sum of the
    learning rates)."""
    args = ttrain.build_parser().parse_args(LAUNCH)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps)
    opt = adamw.init_state(opt_cfg, params)
    step = make_train_step(model, opt_cfg, TrainConfig(remat=False))
    its = [batch_iterator(SyntheticCorpus(cfg.vocab, seed=0),
                          DataConfig(cfg.vocab, args.seq, args.batch,
                                     host_id=r, num_hosts=world))
           for r in range(world)]
    for _ in range(args.steps):
        parts = [next(i) for i in its]
        batch = {k: torch.from_numpy(np.concatenate([p[k] for p in parts]))
                 for k in parts[0]}
        params, opt, _ = step(params, opt, batch)
    lrs = sum(float(adamw.lr_at(opt_cfg, torch.tensor(s)))
              for s in range(1, args.steps + 1))
    return ({"::".join(p): v.numpy() for p, v in flatten_with_paths(params)},
            lrs)


def assert_run_close(got, want, lrs, frac=1e-5):
    """Within `frac` of each leaf's largest magnitude, except at most 1 %
    of the elements (AdamW's early updates of cancellation-noise
    gradients, `test_torch_train.py`), which stay within 4 × `lrs`, the
    sum of the learning rates."""
    loose = total = 0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        loose += int((diff > frac * np.abs(w).max()).sum())
        total += w.size
        assert diff.max() <= 4 * lrs, k
    assert loose <= 1e-2 * total, (loose, total)


def test_compressed_psum_needs_a_bound_axis():
    with pytest.raises(NameError, match="pod"):
        TC.compressed_psum(torch.ones(3), "pod")
    with TX.mesh_context(TX.Mesh(np.zeros((1,), int), ("data",), "cpu")):
        with pytest.raises(NameError, match="pod"):
            TC.compressed_psum(torch.ones(3), "pod")


def test_one_device_sharding_is_a_move(tmp_path):
    mesh = TX.Mesh(np.zeros((1, 1), int), ("data", "model"), "cpu")
    tree = {"w": torch.arange(16.0).reshape(4, 4), "s": torch.tensor(3)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=True)
    shard = {"w": TX.NamedSharding(mesh, TX.P("data", "model")),
             "s": TS.replicated(mesh)}
    out = mgr.restore_sharded(tree, shard)
    for a, b in zip(leaves(out), leaves(tree)):
        assert type(a) is torch.Tensor and torch.equal(a, b)
