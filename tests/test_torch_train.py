"""The port's training path (`Model.loss_fn`, `optim/adamw.py`,
`train/step.py`) against the JAX package's, from bridged state: the same
parameters, optimizer state and batch carried across as numpy.

Tolerances (f32, other summation orders): losses rel 1e-5; gradients, and
AdamW's update from the reference's own gradients, within 1e-5 of each
leaf's largest magnitude; learning rate and grad norm rel 1e-6. A whole
step composes the two, and AdamW's early steps move a weight by
lr·g/(|g| + eps), which a gradient of cancellation noise (|g| below 1e-4
of the leaf's largest, where the 1e-5 gradient tolerance is a large
relative error) turns into any value in [-lr, lr]: there the updated
weight is held within the update's own bound (4·lr), and elsewhere within
1e-5 of the leaf's largest magnitude.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models.transformer import build_model as jax_build
from repro.optim import adamw as jadamw
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import interop
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, batch_iterator
from repro_torch.models.transformer import build_model
from repro_torch.optim import adamw
from repro_torch.train.step import TrainConfig, make_eval_step, make_train_step
from repro_torch.tree import flatten_with_paths, leaves, unflatten

LOSS_REL = 1e-5
LEAF_FRAC = 1e-5
OPT = dict(lr=3e-3, warmup_steps=5, total_steps=60)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module (under several
    test workers a thread pool per worker oversubscribes the cores); the
    worker's own setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p):
            np.asarray(v) for p, v in flat}


def assert_tree_close(got, want_jax, frac=LEAF_FRAC):
    want = jax_paths(want_jax)
    got = dict(flatten_with_paths(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path].detach().to(torch.float32).numpy()
        w = w.astype(np.float32)
        tol = frac * max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= tol, (path, np.abs(g - w).max(), tol)


def assert_step_close(got, want_jax, grads_jax, lr):
    """Updated params: tight where the reference's gradient is
    conditioned, within the update's bound where it is noise."""
    want, grads = jax_paths(want_jax), jax_paths(grads_jax)
    got = dict(flatten_with_paths(got))
    noisy = 0
    for path, w in want.items():
        diff = np.abs(got[path].detach().numpy() - w)
        g = np.abs(grads[path])
        cond = (g >= 1e-4 * g.max()) | (g == 0)
        noisy += int((~cond).sum())
        tol = LEAF_FRAC * float(np.abs(w).max())
        assert diff[cond].max(initial=0.0) <= tol, (path, diff[cond].max())
        assert diff[~cond].max(initial=0.0) <= 4 * lr, path
    assert noisy <= 1e-2 * sum(w.size for w in want.values())


def batch_for(cfg, rng, b, s):
    batch = {}
    if cfg.frontend == "audio_frames":
        batch["frames"] = rng.standard_normal((b, s, 512)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        labels[rng.random((b, s)) < 0.3] = -1          # masked frames
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.frontend == "vision_patches":
        batch["patches"] = rng.standard_normal((b, 4, 1024)).astype(np.float32)
    batch["labels"] = labels
    return batch


@functools.lru_cache(maxsize=None)
def bridged(arch):
    """The reference model, its params, the port's model and the same
    params as tensors."""
    jcfg = jax_get_config(arch).reduced()
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(arch).reduced())
    return jcfg, jm, jp, tm, interop.tree_from_numpy(np_tree(jp), "cpu")


@pytest.fixture(scope="module")
def dense():
    """llama3 (reduced): the reference's first two train steps, with the
    batches and the state after each."""
    jcfg, jm, jp, tm, tp = bridged("llama3-1b")
    it = batch_iterator(SyntheticCorpus(jcfg.vocab, seed=0),
                        DataConfig(jcfg.vocab, 32, 8))
    batches = [next(it) for _ in range(2)]
    opt_cfg = jadamw.AdamWConfig(**OPT)
    step = jax.jit(jax_make_train_step(jm, opt_cfg, JTrainConfig(remat=False)))
    opt0 = jadamw.init_state(opt_cfg, jp)
    p1, opt1, m1 = step(jp, opt0, batches[0])
    p2, opt2, m2 = step(p1, opt1, batches[1])
    grad = jax.jit(jax.grad(lambda p, b: jm.loss_fn(p, b)[0]))
    g0, g1 = grad(jp, batches[0]), grad(p1, batches[1])
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, batches=batches, g0=g0, g1=g1,
                states=[(jp, opt0), (p1, opt1), (p2, opt2)], metrics=[m1, m2])


@pytest.mark.parametrize("arch", ["llama3-1b", "internvl2-2b",
                                  "hubert-xlarge"])
def test_loss_fn_matches_the_reference(arch):
    jcfg, jm, jp, tm, tp = bridged(arch)
    batch = batch_for(jcfg, np.random.default_rng(0), 2, 16)
    jl, jmx = jax.jit(jm.loss_fn)(jp, batch)
    with torch.no_grad():
        tl, tmx = tm.loss_fn(tp, to_torch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_REL)
    for k in ("nll", "zloss", "tokens"):
        np.testing.assert_allclose(float(tmx[k]), float(jmx[k]),
                                   rtol=LOSS_REL)


def test_grads_include_every_leaf_and_the_zloss(dense):
    tp, tm = dense["tp"], dense["tm"]
    flat = [p.detach().requires_grad_(True) for p in leaves(tp)]
    loss, _ = tm.loss_fn(unflatten(tp, flat), to_torch(dense["batches"][0]))
    grads = torch.autograd.grad(loss, flat)
    assert_tree_close(unflatten(tp, list(grads)), dense["g0"])


def test_one_train_step_matches_the_reference(dense):
    jp, opt0 = dense["states"][0]
    p1, opt1 = dense["states"][1]
    want = dense["metrics"][0]
    step = make_train_step(dense["tm"], adamw.AdamWConfig(**OPT),
                           TrainConfig(remat=False))
    tp, to, m = step(dense["tp"], interop.opt_state_from_jax(np_tree(opt0),
                                                             "cpu"),
                     to_torch(dense["batches"][0]))
    for k in ("loss", "nll", "zloss"):
        np.testing.assert_allclose(float(m[k]), float(want[k]),
                                   rtol=LOSS_REL)
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(want[k]), rtol=1e-6)
    assert_step_close(tp, p1, dense["g0"], float(want["lr"]))
    assert_tree_close(to["m"], opt1["m"])
    assert_tree_close(to["v"], opt1["v"])
    assert int(to["step"]) == int(opt1["step"]) == 1


@pytest.mark.parametrize("i", [0, 1])
def test_adamw_update_from_the_references_grads(dense, i):
    """`apply_updates` alone, fed the reference's gradients and state."""
    jp, jopt = dense["states"][i]
    jp1, jopt1 = dense["states"][i + 1]
    grads = dense["g0" if i == 0 else "g1"]
    tp, to, m = adamw.apply_updates(
        adamw.AdamWConfig(**OPT), interop.tree_from_numpy(np_tree(jp), "cpu"),
        interop.tree_from_numpy(np_tree(grads), "cpu"),
        interop.opt_state_from_jax(np_tree(jopt), "cpu"))
    np.testing.assert_allclose(float(m["lr"]),
                               float(dense["metrics"][i]["lr"]), rtol=1e-6)
    assert_tree_close(tp, jp1)
    assert_tree_close(to["m"], jopt1["m"])
    assert_tree_close(to["v"], jopt1["v"])


def test_second_step_from_the_references_first(dense):
    """The port's step from the state the reference's first step left."""
    p1, opt1 = dense["states"][1]
    p2, opt2 = dense["states"][2]
    step = make_train_step(dense["tm"], adamw.AdamWConfig(**OPT),
                           TrainConfig(remat=True))
    tp, to, m = step(interop.tree_from_numpy(np_tree(p1), "cpu"),
                     interop.opt_state_from_jax(np_tree(opt1), "cpu"),
                     to_torch(dense["batches"][1]))
    np.testing.assert_allclose(float(m["loss"]),
                               float(dense["metrics"][1]["loss"]),
                               rtol=LOSS_REL)
    assert_step_close(tp, p2, dense["g1"], float(dense["metrics"][1]["lr"]))
    assert_tree_close(to["v"], opt2["v"])


def test_microbatched_grads_match_full_batch(dense):
    opt_cfg = adamw.AdamWConfig(grad_clip=0.0)
    batch = to_torch(dense["batches"][0])

    def run(n_micro):
        step = make_train_step(dense["tm"], opt_cfg,
                               TrainConfig(num_microbatches=n_micro,
                                           remat=False))
        return step(dense["tp"], adamw.init_state(opt_cfg, dense["tp"]),
                    batch)

    p1, o1, m1 = run(1)
    p4, o4, m4 = run(4)
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    # the first moment is (1 - beta1)·grad: the accumulated grads themselves
    for a, b in zip(leaves(o1["m"]), leaves(o4["m"])):
        tol = 1e-5 * max(float(a.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= tol
    for a, b in zip(leaves(p1), leaves(p4)):
        assert float((a - b).abs().max()) < 5e-3


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_matches_no_remat(dense, policy):
    tm = build_model(dense["tm"].cfg, remat_policy=policy)
    batch = to_torch(dense["batches"][0])
    out = []
    for remat in (False, True):
        flat = [p.detach().requires_grad_(True) for p in leaves(dense["tp"])]
        loss, _ = tm.loss_fn(unflatten(dense["tp"], flat), batch, remat=remat)
        out.append((loss, torch.autograd.grad(loss, flat)))
    assert float(out[0][0].detach()) == float(out[1][0].detach())
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_loss_decreases():
    cfg = get_config("llama3-1b").reduced()
    tm = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = tm.init(gen)
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    step = make_train_step(tm, opt_cfg, TrainConfig(remat=False))
    opt = adamw.init_state(opt_cfg, params)
    it = batch_iterator(SyntheticCorpus(cfg.vocab, seed=0),
                        DataConfig(cfg.vocab, 32, 8))
    losses = []
    for _ in range(20):
        params, opt, m = step(params, opt, to_torch(next(it)))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses
    ev = make_eval_step(tm)(params, to_torch(next(it)))
    assert np.isfinite(float(ev["nll"])) and float(ev["tokens"]) == 8 * 32


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_the_reference(schedule):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, schedule=schedule,
              min_lr_ratio=0.1)
    steps = [0, 1, 5, 10, 11, 50, 99, 100, 150]
    got = [float(adamw.lr_at(adamw.AdamWConfig(**kw),
                             torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    want = [float(jadamw.lr_at(jadamw.AdamWConfig(**kw),
                               jnp.asarray(s, jnp.int32))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if schedule != "constant":
        assert got[0] < got[2] < got[3] and got[3] >= got[5] >= got[7]
        assert abs(got[7] - 0.1) < 1e-5


def test_bf16_moments(dense):
    opt_cfg = adamw.AdamWConfig(moment_dtype="bfloat16", **OPT)
    jopt_cfg = jadamw.AdamWConfig(moment_dtype="bfloat16", **OPT)
    state = adamw.init_state(opt_cfg, dense["tp"])
    assert all(t.dtype == torch.bfloat16
               for t in leaves(state["m"]) + leaves(state["v"]))
    assert state["step"].dtype == torch.int32
    jp, jb = dense["jp"], dense["batches"][0]
    jstep = jax.jit(jax_make_train_step(dense["jm"], jopt_cfg,
                                        JTrainConfig(remat=False)))
    jp1, jo1, _ = jstep(jp, jadamw.init_state(jopt_cfg, jp), jb)
    tp1, to1, _ = make_train_step(dense["tm"], opt_cfg,
                                  TrainConfig(remat=False))(
        dense["tp"], state, to_torch(jb))
    assert all(t.dtype == torch.bfloat16 for t in leaves(to1["m"]))
    assert_step_close(tp1, jp1, dense["g0"], float(adamw.lr_at(
        opt_cfg, torch.tensor(1))))
    # a bf16 moment is one rounding of the f32 one: within 1 bf16 ulp
    assert_tree_close(to1["m"], jo1["m"], frac=2 ** -7)


def test_compress_grads_is_queued():
    with pytest.raises(NotImplementedError, match="A11b"):
        make_train_step(None, adamw.AdamWConfig(),
                        TrainConfig(compress_grads=True))
