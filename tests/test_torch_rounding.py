"""The port's rounding algorithms (`repro_torch.core.rounding`) against
the JAX package's on the same weights and the same Hessians.

RTN is bit-equal (the pipeline runs both eagerly). GPTQ and Qronos diffuse
each row's error into the rows after it, in another summation order than
XLA's, so a grid point can flip near a rounding tie and its error then
travels on: on >= 99 % of the entries the two pick the same grid point
(equal within 1e-5 of the value), and the objective each minimises -
||X~ (W_q - W)||^2 for GPTQ with H = X~^T X~, ||X~ W_q - X W||^2 for
Qronos - is within 1e-3 relative of the reference's and below RTN's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizers as JQ
from repro.core import rounding as JR
from repro_torch.core import quantizers as TQ
from repro_torch.core import rounding as TR

SHAPES = [(64, 48), (128, 96), (256, 64)]
FORMATS = ["int4", "fp4", "mxfp4"]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def layer(request):
    """Weights, full-precision inputs with outlier channels, and the
    reference's quantised-input Hessian and cross product."""
    d_in, d_out = request.param
    rng = np.random.default_rng(d_in)
    x = rng.standard_normal((512, d_in)).astype(np.float32)
    x[:, :3] *= 10.0
    w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    xq = JQ.quantize_act(jnp.asarray(x), JQ.QuantSpec())
    h = np.array(JR.hessian_from_activations(xq))
    c = np.array(JR.cross_from_activations(xq, jnp.asarray(x)))
    return x, w, h, c, np.array(xq)


def same_grid(got, want):
    return np.isclose(got, want, rtol=1e-5, atol=1e-7 * np.abs(want).max())


def objective(algo, x, xq, wq, w):
    if algo == "gptq":
        return float(((xq @ (wq - w)) ** 2).sum())
    return float(((xq @ wq - x @ w) ** 2).sum())


def test_hessian_and_cross_products(layer):
    x, _, h, c, xq = layer
    t = torch.from_numpy
    assert np.allclose(TR.hessian_from_activations(t(xq)).numpy(), h,
                       rtol=1e-5, atol=1e-5 * np.abs(h).max())
    assert np.allclose(TR.cross_from_activations(t(xq), t(x)).numpy(), c,
                       rtol=1e-5, atol=1e-5 * np.abs(c).max())


@pytest.mark.parametrize("fmt", FORMATS)
def test_rtn_is_bit_equal(layer, fmt):
    _, w, _, _, _ = layer
    want = np.asarray(JR.rtn(jnp.asarray(w), JQ.QuantSpec(fmt=fmt)))
    got = TR.rtn(torch.from_numpy(w), TQ.QuantSpec(fmt=fmt)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("algo", ["gptq", "qronos"])
def test_error_diffusion_matches_the_reference(layer, fmt, algo):
    x, w, h, c, xq = layer
    js, ts = JQ.QuantSpec(fmt=fmt), TQ.QuantSpec(fmt=fmt)
    t = torch.from_numpy
    if algo == "gptq":
        want = np.asarray(JR.gptq(jnp.asarray(w), jnp.asarray(h), js))
        got = TR.gptq(t(w), t(h), ts).numpy()
    else:
        want = np.asarray(JR.qronos(jnp.asarray(w), jnp.asarray(h), js,
                                    c_qx=jnp.asarray(c)))
        got = TR.qronos(t(w), t(h), ts, c_qx=t(c)).numpy()
    assert same_grid(got, want).mean() >= 0.99
    e_ref = objective(algo, x, xq, want, w)
    e_got = objective(algo, x, xq, got, w)
    assert abs(e_got - e_ref) <= 1e-3 * e_ref
    assert e_got < objective(algo, x, xq, TR.rtn(t(w), ts).numpy(), w)


def test_dead_channels_and_qronos_without_refit(layer):
    """A dead input channel (H_ii = 0) is pinned, not divided by; Qronos
    without the cross product is GPTQ with sigma_1 damping."""
    _, w, h, _, _ = layer
    h = h.copy()
    h[5, :] = 0.0
    h[:, 5] = 0.0
    t = torch.from_numpy
    spec = TQ.QuantSpec()
    got = TR.qronos(t(w), t(h), spec).numpy()
    assert np.isfinite(got).all()
    assert np.array_equal(got, TR.gptq(t(w), t(h), spec, damp_sigma=1e-3).numpy())
    want = np.asarray(JR.qronos(jnp.asarray(w), jnp.asarray(h), JQ.QuantSpec()))
    assert same_grid(got, want).mean() >= 0.99


def test_sigma_max_is_the_largest_singular_value(layer):
    _, _, h, _, _ = layer
    want = float(JR._sigma_max(jnp.asarray(h)))
    got = float(TR._sigma_max(torch.from_numpy(h)))
    assert abs(got - want) <= 1e-5 * want
    # 32 power iterations approach sigma_1 from below
    assert got <= np.linalg.norm(h.astype(np.float64), 2) * (1 + 1e-5)
