"""The MoE, SSM and hybrid families of the port's `Model` and PTQ pipeline
against the JAX package's, on reduced configs (f32) of mamba2-1.3b,
zamba2-1.2b, deepseek-moe-16b and llama4-maverick-400b-a17b with the JAX
parameters (outlier channels injected) carried across:

- `Model.forward`, and the dense-cache `forward_chunk` (a prefill chunk,
  then per-slot decode steps), within 1e-4 of max|logit|; `loss_fn`'s
  value within 1e-5 relative;
- with quantisation off, the merged transforms leave the logits unchanged
  (2e-3 of max|logit|, the reference test's bound, on the port's own
  seeded weights);
- the SSM's head-preserving MassDiff permutation and its absorption into
  the Mamba2 inner channels equal the reference's;
- `rtn_only`: the weights on the reference's grid points (>= 99 % of the
  entries of every leaf); `perq_star`: the fake-quant model's logit MSE
  against the bf16 model on a held-out batch within 5 % of the
  reference's (the bar of the dense families). For the MoE families the
  reference calibrates each routed expert's gate and up projections on
  inputs rotated twice by R1 (ROADMAP Queue C, R8: the quarot R1 is a
  symmetric Hadamard, so twice is the unrotated input), where the port
  rotates once; there the port's MSE is held to at most the reference's
  plus 5 %, and (deepseek-moe) with the stream rotation off (R1 = I:
  MassDiff + Qronos) within 5 % both ways. The PTQ runs take one layer
  (zamba2: its one group of two and the shared block).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import pipeline as JP
from repro.core.synthetic import inject_outlier_channels as jax_inject
from repro.models.transformer import build_model as jax_build
from repro_torch import interop
from repro_torch.configs.registry import get_config
from repro_torch.core import pipeline as TP
from repro_torch.core.quantizers import QuantSpec
from repro_torch.models.transformer import build_model

ARCHS = ["mamba2-1.3b", "zamba2-1.2b", "deepseek-moe-16b",
         "llama4-maverick-400b-a17b"]
FRAC = 1e-4          # of max|logit|
MSE_FRAC = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module; the worker's
    own setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def carried(name, **over):
    jcfg = jax_get_config(name).reduced(**over)
    jm = jax_build(jcfg)
    p = jax_inject(jm.init(jax.random.PRNGKey(0)))
    tp = interop.tree_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    return jcfg, jm, p, build_model(get_config(name).reduced(**over)), tp


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return carried(request.param)


def close(got, want, frac=FRAC):
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (err, np.abs(want).max())


def test_forward_and_dense_cache_match_the_reference(arch):
    jcfg, jm, p, tm, tp = arch
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    close(tm.forward(tp, {"tokens": torch.from_numpy(toks)}),
          jax.jit(jm.forward)(p, {"tokens": jnp.asarray(toks)}))
    jc = jm.init_cache(2, 16, dtype=jnp.float32)
    tc = tm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    step = jax.jit(jm.forward_chunk)
    want, jc = step(p, jnp.asarray(toks[:, :6]), jc, jnp.asarray(0, jnp.int32))
    got, tc = tm.forward_chunk(tp, torch.from_numpy(toks[:, :6]), tc, 0)
    close(got, want)
    for t in range(6, 9):                 # per-slot decode steps
        idx = np.array([t, t], np.int32)
        want, jc = step(p, jnp.asarray(toks[:, t:t + 1]), jc,
                        jnp.asarray(idx))
        got, tc = tm.forward_chunk(tp, torch.from_numpy(toks[:, t:t + 1]),
                                   tc, torch.from_numpy(idx))
        close(got, want)


def test_loss_matches_the_reference(arch):
    jcfg, jm, p, tm, tp = arch
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(-1, jcfg.vocab, (2, 16)).astype(np.int32)
    want, jaux = jax.jit(jm.loss_fn)(p, {"tokens": jnp.asarray(toks),
                                         "labels": jnp.asarray(labels)})
    got, taux = tm.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(labels)})
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert float(taux["tokens"]) == float(jaux["tokens"])


@pytest.mark.parametrize("name", ARCHS)
def test_transforms_preserve_function(name):
    """The port of the reference's row for these archs: with quantisation
    off the folded norms, R1/R2, P3 (head-preserving for SSM) and the
    pre-rotation of R3 (whose online inverse still runs) leave the logits
    unchanged to f32 roundoff. MoE runs with capacity >= S, as in the
    reference test."""
    cfg = get_config(name).reduced()
    if cfg.uses_moe:
        cfg = cfg.reduced(capacity_factor=cfg.n_experts / cfg.top_k)
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    rng = np.random.default_rng(1)
    cal = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))}]
    x = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))}
    noq = QuantSpec(fmt="none")
    res = TP.quantize_model(model, params, cal, TP.PTQConfig(
        weight_spec=noq, act_spec=noq, block_size=16, permutation="massdiff",
        rotation="quarot", rounding="rtn"))
    hooks = {k: v for k, v in res.hooks.items() if k != "act_in"}
    want = model.forward(params, x)
    got = build_model(cfg, quant_hooks=hooks).forward(res.params, x)
    assert float((got - want).abs().max()) <= 2e-3 * float(want.abs().max())
    assert res.report["r1"] == "quarot"


def test_ssm_permutation_matches_the_reference():
    """The head-preserving P3 (MassDiff within each head) and its
    absorption into (z, x, conv, norm) of one Mamba2 layer equal the
    reference's on the same calibration and weights."""
    jcfg, jm, p, tm, tp = carried("mamba2-1.3b")
    rng = np.random.default_rng(3)
    d_inner = jcfg.d_inner
    y = np.abs(rng.standard_normal((64, d_inner))).astype(np.float32)
    y[:, rng.choice(d_inner, 9, replace=False)] *= 20.0
    for cfg_name, b in (("perq_star", 64), ("perq_star", 16)):
        jc, tc = JP.preset(cfg_name, block_size=b), TP.preset(cfg_name,
                                                               block_size=b)
        want = JP._ffn_permutation(y, jc, d=d_inner,
                                   head_dim=jcfg.ssm_head_dim)
        got = TP._ffn_permutation(torch.from_numpy(y), tc, d=d_inner,
                                  head_dim=jcfg.ssm_head_dim)
        assert np.array_equal(np.asarray(got), np.asarray(want))
        assert (np.asarray(got) // jcfg.ssm_head_dim
                == np.arange(d_inner) // jcfg.ssm_head_dim).all()
    perm = np.asarray(want)
    assert not np.array_equal(perm, np.arange(d_inner))
    jP = jax.tree.map(lambda a: np.array(a, np.float32), p)
    tP = {"layers": {"ssm": {k: v.clone() for k, v in
                             tp["layers"]["ssm"].items()}}}
    JP._permute_ssm_channels(jP, 1, perm, jcfg)
    TP._permute_ssm_channels(tP, 1, perm, jcfg)
    for k, v in tP["layers"]["ssm"].items():
        assert np.array_equal(v.numpy(), jP["layers"]["ssm"][k]), k


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# one layer (the hybrid: one group of `hybrid_period` layers and its shared
# block), which keeps the reference's eager GPTQ / Qronos to seconds
PTQ_LAYERS = {"zamba2-1.2b": 2}


@functools.lru_cache(maxsize=None)
def ptq(name, preset, **over):
    """The reference's and the port's PTQ of the same params on one [4, 128]
    calibration batch, each with its fake-quant logit MSE against the bf16
    model on a held-out [8, 64] batch."""
    jcfg, jm, p, tm, tp = carried(name, n_layers=PTQ_LAYERS.get(name, 1))
    rng = np.random.default_rng(0)
    calib = rng.integers(0, jcfg.vocab, (4, 128)).astype(np.int32)
    held = rng.integers(0, jcfg.vocab, (8, 64)).astype(np.int32)
    want = np.asarray(jax.jit(jm.forward)(p, {"tokens": jnp.asarray(held)}))
    over = dict(block_size=16, **over)
    jr = JP.quantize_model(jm, p, [{"tokens": jnp.asarray(calib)}],
                           JP.preset(preset, **over))
    tr = TP.quantize_model(tm, tp, [{"tokens": torch.from_numpy(calib)}],
                           TP.preset(preset, **over))
    jl = np.asarray(jax.jit(JP.build_quantized_model(jm, jr).forward)(
        jr.params, {"tokens": jnp.asarray(held)}))
    tl = TP.build_quantized_model(tm, tr).forward(
        tr.params, {"tokens": torch.from_numpy(held)}).numpy()
    return (jr, float(np.mean((jl - want) ** 2)),
            tr, float(np.mean((tl - want) ** 2)))


@pytest.mark.parametrize("name", ARCHS)
def test_rtn_only_matches_the_reference(name):
    jr, j_mse, tr, t_mse = ptq(name, "rtn_only")
    want = dict(leaves(jax.tree.map(np.asarray, jr.params)))
    for path, got in leaves(tr.params):
        got, ref = got.numpy(), want[path]
        on = np.isclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
        assert on.mean() >= 0.99, (path, on.mean())
    assert abs(t_mse - j_mse) <= MSE_FRAC * j_mse, (t_mse, j_mse)


@pytest.mark.parametrize("name", ARCHS)
def test_perq_star_matches_the_reference(name):
    jr, j_mse, tr, t_mse = ptq(name, "perq_star")
    assert tr.report["r1"] == jr.report["r1"] == "quarot"
    assert len(tr.report["per_layer"]) == len(jr.report["per_layer"])
    for a, b in zip(jr.report["per_layer"], tr.report["per_layer"]):
        for k in a:
            assert abs(b[k] - a[k]) <= 1e-5 * abs(a[k])
    if get_config(name).uses_moe:
        # R8: the reference's routed experts calibrate on x R1 R1 = x
        assert t_mse <= (1 + MSE_FRAC) * j_mse, (t_mse, j_mse)
        if name != "deepseek-moe-16b":
            return
        _, j_mse, _, t_mse = ptq(name, "perq_star", rotation="none")
    assert abs(t_mse - j_mse) <= MSE_FRAC * j_mse, (t_mse, j_mse)
