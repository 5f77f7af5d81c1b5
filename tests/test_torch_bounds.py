"""The port's Section 3 quantities (`repro_torch.core.bounds`) against the
JAX package's on seeded vectors of several leading shapes and block sizes
(rel 1e-6, f32), then the reference's hypothesis properties
(`tests/test_bounds_properties.py`) re-run on the torch functions, the
port's Hadamard transforms and its MassDiff.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds as JB
from repro_torch.core import bounds
from repro_torch.core import hadamard as hd
from repro_torch.core import massdiff as md

REL = 1e-6
SHAPES = [(64,), (5, 128), (2, 3, 256)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module (under several
    test workers a thread pool per worker oversubscribes the cores); the
    worker's own setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.laplace(size=shape).astype(np.float32)
    x[..., ::17] *= 20.0                       # outlier coordinates
    return x


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=REL,
                               atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_vector_quantities_match_the_reference(shape):
    x = _x(shape, 0)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    for name in ("mass_concentration", "energy_concentration",
                 "prop31_bound"):
        _close(getattr(bounds, name)(t), getattr(JB, name)(j))
    xr = _x(shape, 1)
    _close(bounds.suppression_ratio(t, torch.from_numpy(xr)),
           JB.suppression_ratio(j, jnp.asarray(xr)))
    d = shape[-1]
    assert bounds.sufficient_threshold_full(d) == JB.sufficient_threshold_full(d)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", [4, 32])
def test_block_quantities_match_the_reference(shape, b):
    x = _x(shape, 2)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    _close(bounds.block_mass_concentration(t, b),
           JB.block_mass_concentration(j, b))
    _close(bounds.prop32_bound(t, b), JB.prop32_bound(j, b))
    _close(bounds.zeta(t, b), JB.zeta(j, b))
    _close(bounds.cor33_rhs(t, b, 2), JB.cor33_rhs(j, b, 2))
    for tight in (True, False):
        _close(bounds.prop34_bound(t, b, 0.05, tight=tight),
               JB.prop34_bound(j, b, 0.05, tight=tight))
    assert bounds.sufficient_threshold_block(b) == \
        JB.sufficient_threshold_block(b)


def test_zero_vector_and_bad_block():
    z = torch.zeros(3, 32)
    assert torch.all(bounds.mass_concentration(z) == 0)
    with pytest.raises(ValueError):
        bounds.prop32_bound(z, 5)


# ---------------------------------------------------------------------------
# the reference's hypothesis properties, on the port
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


def vec(d, lo=-100.0, hi=100.0):
    return st.lists(
        st.floats(lo, hi, allow_nan=False, allow_infinity=False, width=32),
        min_size=d, max_size=d,
    ).map(lambda v: torch.tensor(v, dtype=torch.float32))


def _nonzero(x):
    return float(x.abs().max()) > 1e-6


@settings(max_examples=60, deadline=None)
@given(vec(64))
def test_prop31_full_vector_bound(x):
    if not _nonzero(x):
        return
    lhs = float(hd.fwht(x).abs().max())
    assert lhs <= float(bounds.prop31_bound(x)) * (1 + 1e-4) + 1e-5


@settings(max_examples=60, deadline=None)
@given(vec(64), st.sampled_from([4, 8, 16, 32]))
def test_prop32_block_bound(x, b):
    if not _nonzero(x):
        return
    lhs = float(hd.block_hadamard_transform(x, b).abs().max())
    assert lhs <= float(bounds.prop32_bound(x, b)) * (1 + 1e-4) + 1e-5


@settings(max_examples=60, deadline=None)
@given(vec(64), st.sampled_from([(8, 2), (8, 4), (16, 2), (4, 4)]))
def test_cor33_evolution(x, bk):
    b_small, k = bk
    assert float(bounds.zeta(x, b_small * k)) <= \
        float(bounds.cor33_rhs(x, b_small, k)) * (1 + 1e-4) + 1e-5


@settings(max_examples=40, deadline=None)
@given(vec(64))
def test_delta_ranges(x):
    if not _nonzero(x):
        return
    d = x.shape[-1]
    assert 1.0 / d - 1e-5 <= float(bounds.mass_concentration(x)) <= 1.0 + 1e-5
    dp = float(bounds.energy_concentration(x))
    assert 1.0 / math.sqrt(d) - 1e-4 <= dp <= 1.0 + 1e-4


@settings(max_examples=40, deadline=None)
@given(vec(64))
def test_sufficient_condition_guarantees_suppression(x):
    """δ < 1/√d ⇒ ‖XR‖∞ < ‖X‖∞ (the Prop-3.1 guarantee)."""
    if not _nonzero(x):
        return
    delta = float(bounds.mass_concentration(x))
    if delta < bounds.sufficient_threshold_full(64) * (1 - 1e-3):
        assert float(bounds.suppression_ratio(x, hd.fwht(x))) < 1.0 + 1e-4


def test_prop34_probabilistic_bound_monte_carlo():
    """Rademacher-sign resampling violates the 1−ε bound at most ~ε often."""
    rng = np.random.default_rng(0)
    d, b, eps, trials = 128, 16, 0.05, 400
    y = np.abs(rng.laplace(size=d)).astype(np.float32)
    s = rng.choice([-1.0, 1.0], size=(trials, d)).astype(np.float32)
    x = torch.from_numpy(s * y)
    lhs = hd.block_hadamard_transform(x, b).abs().amax(-1)
    rhs = bounds.prop34_bound(x, b, eps, tight=True)
    assert float((lhs > rhs).float().mean()) <= eps


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.sampled_from([8, 16, 32]))
def test_massdiff_minimizes_prop32_bound_vs_identity(seed, b):
    """Permuting by MassDiff never increases the Prop-3.2 bound on the
    calibration mass profile (the quantity Alg. 1 greedily minimizes)."""
    rng = np.random.default_rng(seed)
    calib = rng.laplace(size=(32, 128)).astype(np.float32) * \
        rng.uniform(0.1, 10.0, size=(1, 128)).astype(np.float32)
    mass = md.coordinate_mass(calib)
    perm = md.massdiff(mass, b)
    before = mass.reshape(-1, b).sum(-1).max()
    after = mass[perm].reshape(-1, b).sum(-1).max()
    assert after <= before * (1 + 1e-9)
    # and the torch form of the bound agrees: MassDiff lowers the largest
    # block l1 mass of the mean profile
    t = torch.from_numpy(mass)
    assert float(bounds.prop32_bound(t[torch.from_numpy(perm)], b)) <= \
        float(bounds.prop32_bound(t, b)) * (1 + 1e-9)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_permutations_are_bijections(seed):
    rng = np.random.default_rng(seed)
    calib = rng.standard_normal((8, 96)).astype(np.float32)
    for meth in ["identity", "random", "absmax", "zigzag", "massdiff"]:
        p = md.make_permutation(meth, calib, 16, seed=seed)
        assert sorted(p.tolist()) == list(range(96)), meth


def test_perm_matrix_convention():
    rng = np.random.default_rng(3)
    perm = rng.permutation(24)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    np.testing.assert_allclose(x @ md.perm_matrix(perm), x[:, perm], atol=0)
    np.testing.assert_allclose(x[:, perm][:, md.invert(perm)], x, atol=0)
