"""int8 error-feedback gradient compression
(`repro_torch.distributed.compression`) against the JAX package's, on the
same numpy-made gradients:

- `ef_compress_grads` on f32 and bf16 leaves, against the reference both
  as written and under `jax.jit`: the int8 codes equal (a rounding tie may
  fall the other way at most once per leaf); elsewhere the decompressed
  gradients and the new error equal the eager reference's bit for bit,
  and the jitted one's within two f32 ulps of the leaf's largest
  magnitude (XLA multiplies by 1/127 for the scale, one ulp of the scale
  and so one ulp of the largest magnitude after the dequantizing product,
  and fuses the residual into one multiply-add);
- over 20 steps the error-feedback sum tracks the true sum (the reference
  test's bound) and the port's running sums stay with the reference's;
- one step's error is at most half a scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as JC
from repro_torch.distributed import compression as TC
from repro_torch.tree import leaves

SHAPES = {"w": (64, 96), "b": (96,), "e": (4, 8, 16)}


def grads_np(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale * (1 + i)).astype(np.float32)
            for i, (k, s) in enumerate(sorted(SHAPES.items()))}


def to_jax(tree, dt):
    return {k: jnp.asarray(v, dt) for k, v in tree.items()}


def to_torch(tree, dt):
    return {k: torch.from_numpy(v).to(dt) for k, v in tree.items()}


def f32(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_compress_matches_the_reference(dtype, jit):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    g = grads_np(0)
    ef = {k: v * 1e-2 for k, v in grads_np(1).items()}
    fn = jax.jit(JC.ef_compress_grads) if jit else JC.ef_compress_grads
    jdeq, jef = fn(to_jax(g, jdt), to_jax(ef, jnp.float32))
    tdeq, tef = TC.ef_compress_grads(to_torch(g, tdt),
                                     to_torch(ef, torch.float32))
    for k in sorted(SHAPES):
        g32 = f32(to_torch(g, tdt)[k]) + ef[k]
        qfn = jax.jit(JC._quantize_leaf) if jit else JC._quantize_leaf
        jq, jscale = qfn(jnp.asarray(g32))
        tq, tscale = TC._quantize_leaf(torch.from_numpy(g32))
        assert tq.dtype == torch.int8
        diff = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq, np.int32))
        assert diff.max() <= 1 and (diff != 0).sum() <= 1, k
        same = diff == 0
        tol = 2 * float(np.spacing(np.float32(np.abs(g32).max())))
        if not jit:
            tol = 0.0
            assert float(tscale) == float(jscale)
        assert tdeq[k].dtype == tdt and tef[k].dtype == torch.float32
        for got, want in ((f32(tdeq[k]), f32(jdeq[k])),
                          (tef[k].numpy(), np.asarray(jef[k]))):
            assert np.abs(got - want)[same].max() <= tol, k


def test_new_error_is_taken_on_the_f32_dequantized_grads():
    g = to_torch(grads_np(2), torch.bfloat16)
    ef = TC.init_ef_state(g)
    assert all(e.dtype == torch.float32 and not e.any() for e in leaves(ef))
    deq, new = TC.ef_compress_grads(g, ef)
    for k in g:
        q, scale = TC._quantize_leaf(g[k].float())
        full = q.float() * scale
        assert torch.equal(deq[k], full.to(torch.bfloat16))
        assert torch.equal(new[k], g[k].float() - full)


def test_ef_sum_tracks_the_true_sum_over_20_steps():
    base = grads_np(3)
    jef = JC.init_ef_state(to_jax(base, jnp.float32))
    tef = TC.init_ef_state(to_torch(base, torch.float32))
    true = {k: np.zeros(v.shape) for k, v in base.items()}
    jsum = {k: np.zeros(v.shape) for k, v in base.items()}
    tsum = {k: np.zeros(v.shape) for k, v in base.items()}
    for i in range(20):
        g = {k: (v * (1 + 0.1 * i)).astype(np.float32)
             for k, v in base.items()}
        jdeq, jef = JC.ef_compress_grads(to_jax(g, jnp.float32), jef)
        tdeq, tef = TC.ef_compress_grads(to_torch(g, torch.float32), tef)
        for k in g:
            true[k] += g[k]
            jsum[k] += np.asarray(jdeq[k])
            tsum[k] += tdeq[k].numpy()
    for k in base:
        np.testing.assert_allclose(tsum[k] + tef[k].numpy(), true[k],
                                   atol=1e-3)
        np.testing.assert_allclose(tsum[k], jsum[k], atol=1e-3)
        np.testing.assert_allclose(tef[k].numpy(), np.asarray(jef[k]),
                                   atol=1e-4)


def test_single_step_error_is_at_most_half_a_scale():
    g = {"w": torch.from_numpy(np.random.default_rng(1)
                               .standard_normal(128).astype(np.float32))}
    deq, _ = TC.ef_compress_grads(g, TC.init_ef_state(g))
    scale = float(g["w"].abs().max()) / 127
    assert float((deq["w"] - g["w"]).abs().max()) <= scale / 2 + 1e-7
