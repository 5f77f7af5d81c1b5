"""The port's quantizers (`repro_torch.core.quantizers`) against the JAX
package's, on the same numpy-made inputs.

Two compiled forms exist in the reference and the port mirrors the one each
function runs in: the weight scale search is run eagerly by the pipeline's
RTN (a true division by the format's maximum, the ratio grid computed at
run time), so the port's weight quantizers equal the *eager* JAX functions
bit for bit; the activation quantiser runs inside the jitted model, where
XLA multiplies by the f32 reciprocal of 2^bits - 1, so the port's
`quantize_act` equals the *jitted* JAX function bit for bit. The jitted
weight quantizers differ from the eager ones only by an ulp of a scale
(a few ulps of the value): held to 1e-6 of the value, the same grid
point.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizers as JQ
from repro_torch.core import quantizers as TQ

FORMATS = ["int4", "int8", "fp4", "mxfp4"]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((192, 96)) * 0.05).astype(np.float32)
    w[:, 5] *= 12.0                                # an outlier channel
    x = (rng.standard_normal((3, 17, 256)) * 2.0).astype(np.float32)
    x[..., 7] += 30.0
    return w, x


def test_the_scale_search_grid_is_the_references():
    """The 80 ratios r in [0.2, 1] are the f32 values of the reference's
    `jnp.linspace(0.2, 1.0, 80)` as it runs eagerly, bit for bit."""
    want = np.asarray(jnp.linspace(0.2, 1.0, 80))
    assert np.array_equal(TQ.scale_ratios().numpy(), want)
    assert np.array_equal(TQ.scale_ratios(17, 0.3).numpy(),
                          np.asarray(jnp.linspace(0.3, 1.0, 17)))


@pytest.mark.parametrize("bits", [4, 8])
def test_int_weight_scales_equal_the_reference(data, bits):
    w, _ = data
    want = np.asarray(JQ.int_weight_scales_mse(jnp.asarray(w), bits))
    got = TQ.int_weight_scales_mse(torch.from_numpy(w), bits).numpy()
    assert np.array_equal(got, want)


def test_fp4_weight_scales_equal_the_reference(data):
    w, _ = data
    want = np.asarray(JQ.fp4_weight_scales_mse(jnp.asarray(w)))
    assert np.array_equal(TQ.fp4_weight_scales_mse(torch.from_numpy(w)).numpy(),
                          want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_weight_equals_the_reference(data, fmt):
    """Bit-equal to the eager reference; within 1e-6 of the value of the
    jitted one (whose scales differ by an ulp)."""
    w, _ = data
    got = TQ.quantize_weight(torch.from_numpy(w), TQ.QuantSpec(fmt=fmt)).numpy()
    spec = JQ.QuantSpec(fmt=fmt)
    assert np.array_equal(got, np.asarray(JQ.quantize_weight(jnp.asarray(w), spec)))
    jitted = np.asarray(jax.jit(lambda a: JQ.quantize_weight(a, spec))(jnp.asarray(w)))
    assert np.all(np.abs(got - jitted) <= 1e-6 * np.abs(jitted))


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_act_equals_the_jitted_reference(data, fmt):
    _, x = data
    spec = JQ.QuantSpec(fmt=fmt)
    want = np.asarray(jax.jit(lambda a: JQ.quantize_act(a, spec))(jnp.asarray(x)))
    got = TQ.quantize_act(torch.from_numpy(x), TQ.QuantSpec(fmt=fmt)).numpy()
    assert np.array_equal(got, want)


def test_quantize_act_keeps_the_dtype_and_none_is_the_identity(data):
    _, x = data
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert TQ.quantize_act(xb, TQ.QuantSpec()).dtype == torch.bfloat16
    t = torch.from_numpy(x)
    assert TQ.quantize_act(t, TQ.QuantSpec(fmt="none")) is t
    assert TQ.quantize_weight(t, TQ.QuantSpec(fmt="none")) is t


@pytest.mark.parametrize("fmt", ["int4", "fp4"])
def test_element_quantizers_equal_the_reference(data, fmt):
    _, x = data
    s = np.float32(0.37)
    if fmt == "int4":
        want = np.asarray(JQ.int_quantize(jnp.asarray(x), s, 0.0, 4))
        got = TQ.int_quantize(torch.from_numpy(x), s, 0.0, 4).numpy()
    else:
        want = np.asarray(JQ.fp4_quantize(jnp.asarray(x), s))
        got = TQ.fp4_quantize(torch.from_numpy(x), s).numpy()
    assert np.array_equal(got, want)
    vals = np.unique(np.abs(TQ.fp4_quantize(torch.from_numpy(x), 1.0).numpy()))
    assert set(vals.tolist()) <= set(TQ.FP4_VALUES)


def test_ste_round_passes_the_gradient_through():
    x = torch.linspace(-3, 3, 13, requires_grad=True)
    y = TQ.ste_round(x * 1.3)
    assert torch.equal(y, torch.round(x.detach() * 1.3))
    (y * torch.arange(13.0)).sum().backward()
    assert torch.allclose(x.grad, 1.3 * torch.arange(13.0))
    g = torch.ones(4, 32, requires_grad=True)
    TQ.quantize_act(g * 2.5, TQ.QuantSpec()).sum().backward()
    assert torch.isfinite(g.grad).all() and g.grad.abs().sum() > 0
