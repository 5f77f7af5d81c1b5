"""The port's PTQ pipeline (`repro_torch.core.pipeline`) against the JAX
package's, on the reduced llama3-1b with injected outlier channels: the
same parameters (carried across) and the same calibration tokens (one
[4, 128] batch, as the launchers calibrate).

Per preset (`cayley_steps=4`): the report's per-layer block masses within
1e-5 relative; the RTN presets' weights on the reference's grid points
except at rounding ties (<= 0.1 % of the entries differ); the presets that
diffuse error (GPTQ, Qronos) or learn a rotation (Cayley) are chaotic in
the last bits of their inputs (the reference's Qronos damping, 1e-3
sigma_1, amplifies a 1e-7 difference of the captures into other grid
points), so there the fake-quant model's logit MSE against the bf16 model
on a held-out [8, 64] batch is held within 5 % of the reference's. Then the
port's own versions of the reference's pipeline tests, and P6: the packed
tree the port's `rtn_only` serves equals the reference's.
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
from repro.serve import quantized as jq
from repro_torch import interop
from repro_torch.configs.registry import get_config
from repro_torch.core import pipeline as TP
from repro_torch.core.quantizers import QuantSpec
from repro_torch.core.synthetic import inject_outlier_channels
from repro_torch.models.transformer import build_model
from repro_torch.serve.quantized import pack_dense_params

PRESETS = sorted(JP.PRESETS)
RTN_PRESETS = ("rtn_only", "mr_rtn", "perq_dagger")
MSE_FRAC = 0.05


@functools.lru_cache(maxsize=None)
def setup():
    jcfg = jax_get_config("llama3-1b").reduced()
    jm = jax_build(jcfg)
    p = jax_inject(jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    calib = rng.integers(0, jcfg.vocab, (4, 128)).astype(np.int32)
    held = rng.integers(0, jcfg.vocab, (8, 64)).astype(np.int32)
    tm = build_model(get_config("llama3-1b").reduced())
    tp = interop.tree_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    want = np.asarray(jax.jit(jm.forward)(p, {"tokens": jnp.asarray(held)}))
    return jcfg, jm, p, tm, tp, calib, held, want


@functools.lru_cache(maxsize=None)
def results(name):
    """The reference's and the port's PTQ of the same params, each with its
    fake-quant model's logit MSE against the bf16 model."""
    jcfg, jm, p, tm, tp, calib, held, want = setup()
    over = dict(block_size=16, cayley_steps=4)
    jr = JP.quantize_model(jm, p, [{"tokens": jnp.asarray(calib),
                                    "labels": jnp.zeros_like(calib)}],
                           JP.preset(name, **over))
    tr = TP.quantize_model(tm, tp, [{"tokens": torch.from_numpy(calib)}],
                           TP.preset(name, **over))
    jl = np.asarray(jax.jit(JP.build_quantized_model(jm, jr).forward)(
        jr.params, {"tokens": jnp.asarray(held)}))
    tl = TP.build_quantized_model(tm, tr).forward(
        tr.params, {"tokens": torch.from_numpy(held)}).numpy()
    return (jr, float(np.mean((jl - want) ** 2)),
            tr, float(np.mean((tl - want) ** 2)))


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_the_reference(name):
    jr, j_mse, tr, t_mse = results(name)
    assert tr.report["r1"] == jr.report["r1"]
    assert len(tr.report["per_layer"]) == len(jr.report["per_layer"])
    for a, b in zip(jr.report["per_layer"], tr.report["per_layer"]):
        for k in a:
            assert abs(b[k] - a[k]) <= 1e-5 * abs(a[k])
    assert np.isfinite(t_mse)
    if name in RTN_PRESETS:
        want = dict(leaves(jax.tree.map(np.asarray, jr.params)))
        for path, got in leaves(tr.params):
            got, ref = got.numpy(), want[path]
            off = ~np.isclose(got, ref, rtol=1e-5,
                              atol=1e-6 * np.abs(ref).max())
            assert off.mean() <= 1e-3, (path, off.mean())
    assert abs(t_mse - j_mse) <= MSE_FRAC * j_mse, (t_mse, j_mse)


def test_rtn_only_packs_the_references_int4_weights():
    """P6: `rtn_only` folds the norm scales and rounds with MSE-searched
    scales before packing, as the reference's launcher does; the packed
    tree (codes, scales, norms, embeddings) equals the reference's
    `pack_dense_params(quantize_model(rtn_only).params)` leaf for leaf."""
    jcfg = setup()[0]
    jr, _, tr, _ = results("rtn_only")
    want = dict(leaves(jax.tree.map(np.asarray,
                                    jq.pack_dense_params(jr.params, jcfg))))
    got = dict(leaves(pack_dense_params(tr.params, get_config(
        "llama3-1b").reduced())))
    assert set(want) == {k for k in got if not k.endswith(".colsum")}
    for path, ref in want.items():
        assert np.array_equal(got[path].numpy(), ref), path
    # the norm scales were folded: the packed tree differs from raw packing
    _, _, _, _, tp, _, _, _ = setup()
    raw = pack_dense_params(tp, get_config("llama3-1b").reduced())
    assert not torch.equal(raw["layers"]["attn"]["wq"]["packed"],
                           got["layers.attn.wq.packed"])


@pytest.mark.parametrize("arch", ["llama3-1b", "qwen1.5-0.5b",
                                  "hubert-xlarge", "internvl2-2b"])
def test_transforms_preserve_function(arch):
    """With quantisation off, the merged transforms (norm fold, R1/R2, the
    MassDiff P3 and the pre-rotation of R3, whose online inverse still
    runs) leave the logits unchanged to f32 roundoff (2e-3 of max|logit|,
    the reference test's bound)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    rng = np.random.default_rng(1)

    def batch():
        b = {}
        if cfg.frontend == "audio_frames":
            b["frames"] = torch.from_numpy(
                rng.standard_normal((2, 32, 512)).astype(np.float32))
            return b
        n_text = 32 - (cfg.frontend_tokens if cfg.frontend else 0)
        b["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab, (2, n_text)))
        if cfg.frontend == "vision_patches":
            b["patches"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.frontend_tokens, 1024)).astype(np.float32))
        return b

    noq = QuantSpec(fmt="none")
    res = TP.quantize_model(model, params, [batch()], TP.PTQConfig(
        weight_spec=noq, act_spec=noq, block_size=16, permutation="massdiff",
        rotation="quarot", rounding="rtn"))
    qmodel = build_model(cfg, quant_hooks={
        "down_proj_fn": res.hooks["down_proj_fn"]})
    x = batch()
    want = model.forward(params, x)
    got = qmodel.forward(res.params, x)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-3 * scale
    if cfg.norm == "rmsnorm":
        assert res.report["r1"] == "quarot"


def test_pipeline_ordering_matches_paper():
    """On the model with outlier channels and four [4, 128] calibration
    batches: rtn_only > mr_rtn > perq_star in output MSE, and perq_star at
    b = 32 comes within 25 % of full-vector QuaRot (the reference test's
    claims, on the port's own seeded weights); MassDiff lowers or keeps
    every layer's largest block mass."""
    cfg = get_config("llama3-1b").reduced()
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = inject_outlier_channels(model.init(gen))
    rng = np.random.default_rng(9)
    held = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))}
    cal = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 128)))}
           for _ in range(4)]
    want = model.forward(params, held)

    def err(name):
        res = TP.quantize_model(model, params, cal, TP.preset(name))
        got = TP.build_quantized_model(model, res).forward(res.params, held)
        return float(((got - want) ** 2).mean()), res

    e_none, _ = err("rtn_only")
    e_mr, _ = err("mr_rtn")
    e_perq, res = err("perq_star")
    e_full, _ = err("quarot")
    assert e_mr < e_none and e_perq < e_mr, (e_none, e_mr, e_perq)
    assert e_perq < e_full * 1.25, (e_perq, e_full)
    for entry in res.report["per_layer"]:
        assert entry["max_block_l1_after"] <= \
            entry["max_block_l1_before"] * (1 + 1e-6)


def test_other_families_name_queue_a10():
    model = build_model(get_config("llama3-1b").reduced())
    cfg = get_config("mamba2-1.3b").reduced()
    with pytest.raises(NotImplementedError, match="A10"):
        build_model(cfg)
    model.cfg = cfg
    with pytest.raises(NotImplementedError, match="A10"):
        TP.quantize_model(model, {"lm_head": torch.zeros(1)}, [],
                          TP.preset("rtn_only"))
