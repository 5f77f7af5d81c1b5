"""The port's PTQ building blocks against the JAX package's: the
permutations (MassDiff and its baselines), the Hadamard transforms and
op-count models, the equivariance merges and the Cayley-learned rotation.

Tolerances: permutations equal index for index; transforms and merges
within 1e-6 of max|value| (f32, other summation orders); the Cayley
transform within 1e-5; `learn_rotation`'s loss over 4 steps within 1e-4
relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cayley as JC
from repro.core import equivariance as JE
from repro.core import hadamard as JH
from repro.core import massdiff as JM
from repro.core import quantizers as JQ
from repro_torch.core import cayley as TC
from repro_torch.core import equivariance as TE
from repro_torch.core import hadamard as TH
from repro_torch.core import massdiff as TM
from repro_torch.core import quantizers as TQ

t = torch.from_numpy


def close(got, want, frac=1e-6):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= frac * max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def calib():
    """Calibration activations [tokens, 256] with a few heavy channels."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 256)).astype(np.float32)
    x[:, rng.choice(256, 12, replace=False)] *= 20.0
    return x


# -------------------- permutations --------------------

@pytest.mark.parametrize("method", ["massdiff", "zigzag", "absmax", "random",
                                    "identity"])
@pytest.mark.parametrize("b", [8, 32])
def test_permutations_equal_the_reference(calib, method, b):
    want = JM.make_permutation(method, calib, b, seed=3)
    assert np.array_equal(TM.make_permutation(method, calib, b, seed=3), want)
    # the pipeline hands its captures over as tensors
    assert np.array_equal(TM.make_permutation(method, t(calib), b, seed=3),
                          want)
    assert sorted(want.tolist()) == list(range(256))


@pytest.mark.parametrize("b", [4, 16, 64])
def test_massdiff_torch_equals_massdiff_jax(calib, b):
    mass = np.abs(calib).mean(0).astype(np.float32)
    want = np.asarray(jax.jit(JM.massdiff_jax, static_argnums=1)(
        jnp.asarray(mass), b))
    got = TM.massdiff_torch(t(mass), b).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, TM.massdiff(mass, b))


def test_massdiff_lowers_the_max_block_mass_and_helpers(calib):
    mass = TM.coordinate_mass(calib)
    assert np.allclose(mass, JM.coordinate_mass(calib), rtol=1e-12)
    perm = TM.massdiff(mass, 16)
    before = TM.block_l1_norms(t(calib).abs().mean(0), 16).max()
    after = TM.block_l1_norms(t(calib).abs().mean(0)[perm], 16).max()
    assert after <= before
    close(TM.block_l1_norms(t(calib), 16),
          JM.block_l1_norms(jnp.asarray(calib), 16))
    p = TM.perm_matrix(perm)
    assert np.array_equal(calib @ p, calib[:, perm])
    assert np.array_equal(TM.invert(perm)[perm], np.arange(256))


# -------------------- Hadamard --------------------

@pytest.mark.parametrize("d", [64, 224, 768, 3072])
def test_full_vector_transform_equals_the_reference(d):
    x = np.random.default_rng(d).standard_normal((5, d)).astype(np.float32)
    close(TH.hadamard_transform(t(x)), JH.hadamard_transform(jnp.asarray(x)))
    assert TH.constructible(d) == JH.constructible(d)


@pytest.mark.parametrize("d,b", [(256, 16), (256, 32), (240, 12), (8192, 16)])
def test_block_transform_and_matrix_equal_the_reference(d, b):
    x = np.random.default_rng(b).standard_normal((3, 2, d)).astype(np.float32)
    close(TH.block_hadamard_transform(t(x), b),
          JH.block_hadamard_transform(jnp.asarray(x), b))
    if d <= 256:
        m = TH.block_hadamard_matrix(d, b).numpy()
        assert np.array_equal(m, np.asarray(JH.block_hadamard_matrix(d, b)))
        close(TH.block_hadamard_transform(t(x), b), x @ m)


def test_fwht_rotation_matrix_and_fallback():
    x = np.random.default_rng(1).standard_normal((4, 128)).astype(np.float32)
    close(TH.fwht(t(x)), JH.fwht(jnp.asarray(x)))
    close(TH.fwht(t(x), normalize=False), x @ TH.sylvester(128))
    r = TH.rotation_matrix(12).numpy()
    assert np.array_equal(r, np.asarray(JH.rotation_matrix(12)))
    gen = torch.Generator()
    gen.manual_seed(0)
    q = TH.random_orthogonal(10, gen)
    close(q @ q.T, np.eye(10, dtype=np.float32), 1e-5)
    assert not TH.constructible(10)
    with pytest.raises(ValueError):
        TH.rotation_matrix(10)
    q = TH.rotation_matrix(10, gen=gen)
    close(q @ q.T, np.eye(10, dtype=np.float32), 1e-5)


@pytest.mark.parametrize("d", [8192, 14336, 3072, 6144, 9728, 12288])
def test_op_counts_equal_the_reference(d):
    for fn in ("ops_dense_matmul", "ops_butterfly_matmul", "ops_optimized",
               "ops_full_vector"):
        assert getattr(TH, fn)(d) == getattr(JH, fn)(d)
    for b in (32, 128, 512):
        assert TH.ops_block(d, b) == JH.ops_block(d, b)


# -------------------- equivariance --------------------

def test_merges_equal_the_reference_and_preserve_function():
    rng = np.random.default_rng(5)
    d, f, kv, h, dh = 32, 64, 2, 4, 8
    x = rng.standard_normal((7, d)).astype(np.float32)
    wg, wu = (rng.standard_normal((d, f)).astype(np.float32) for _ in range(2))
    wd = rng.standard_normal((f, d)).astype(np.float32)
    perm = rng.permutation(f)
    got = TE.merge_perm_into_ffn(t(wg), t(wu), t(wd), perm)
    want = JE.merge_perm_into_ffn(jnp.asarray(wg), jnp.asarray(wu),
                                  jnp.asarray(wd), perm)
    for g_, w_ in zip(got, want):
        assert np.array_equal(g_.numpy(), np.asarray(w_))
    silu = torch.nn.functional.silu
    y0 = (silu(t(x) @ t(wg)) * (t(x) @ t(wu))) @ t(wd)
    y1 = (silu(t(x) @ got[0]) * (t(x) @ got[1])) @ got[2]
    close(y1, y0.numpy(), 1e-5)
    wv = rng.standard_normal((d, kv * dh)).astype(np.float32)
    wo = rng.standard_normal((h * dh, d)).astype(np.float32)
    r = TH.rotation_matrix(dh).numpy()
    gv, go = TE.merge_head_rotation(t(wv), t(wo), t(r), kv, h)
    jv, jo = JE.merge_head_rotation(jnp.asarray(wv), jnp.asarray(wo),
                                    jnp.asarray(r), kv, h)
    close(gv, jv)
    close(go, jo)
    b = rng.standard_normal(f).astype(np.float32)
    wp, bp = TE.permute_producer(t(wg), perm, t(b))
    assert np.array_equal(bp.numpy(), b[perm])
    rf = TH.rotation_matrix(f)
    y2 = (t(x) @ TE.rotate_producer(t(wg), rf)) @ TE.rotate_consumer(t(wd), rf)
    close(y2, x @ wg @ wd, 1e-5)
    g = np.abs(rng.standard_normal(d)).astype(np.float32) + 0.5
    ones, (fw,) = TE.fold_rmsnorm(t(g), [t(wg)])
    assert torch.equal(ones, torch.ones(d))
    close(t(x / g) @ fw, (x @ wg))
    close(TE.fold_layernorm_center(t(wg)), wg @ TE.center_matrix(f), 1e-5)


# -------------------- Cayley --------------------

def test_cayley_transform_equals_the_reference():
    d = 12
    a = np.random.default_rng(2).standard_normal(d * (d - 1) // 2).astype(np.float32) * 0.3
    a_skew = TC.skew(t(a), d)
    assert np.array_equal(a_skew.numpy(), np.asarray(JC.skew(jnp.asarray(a), d)))
    r = TC.cayley(a_skew)
    close(r, JC.cayley(jnp.asarray(a_skew.numpy())), 1e-5)
    close(r @ r.T, np.eye(d, dtype=np.float32), 1e-5)


def test_learn_rotation_follows_the_reference_loss_history():
    """Adam over the free entries of A, gradients through the activation
    quantiser by STE: 4 steps from a Hadamard start."""
    d = 16
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, d)).astype(np.float32)
    x[:, 3] *= 15.0
    w = (rng.standard_normal((d, 8)) / 4).astype(np.float32)
    r0 = TH.rotation_matrix(d).numpy()

    def jloss(r):
        xq = JQ.quantize_act(jnp.asarray(x) @ r, JQ.QuantSpec())
        return jnp.mean((xq @ (r.T @ jnp.asarray(w)) - jnp.asarray(x @ w)) ** 2)

    def tloss(r):
        xq = TQ.quantize_act(t(x) @ r, TQ.QuantSpec())
        return torch.mean((xq @ (r.T @ t(w)) - t(x @ w)) ** 2)

    jr, jh = JC.learn_rotation(jloss, d, r0=jnp.asarray(r0), steps=4, lr=5e-3)
    tr, th = TC.learn_rotation(tloss, d, r0=t(r0), steps=4, lr=5e-3)
    jh = np.asarray(jh)
    assert np.all(np.abs(th.numpy() - jh) <= 1e-4 * np.abs(jh))
    close(tr @ tr.T, np.eye(d, dtype=np.float32), 1e-5)
    close(tr, jr, 1e-3)
