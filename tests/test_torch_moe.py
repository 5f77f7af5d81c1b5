"""The port's MoE feed-forward (`repro_torch.models.moe`) against the JAX
package's, on the same seeded parameters (carried across) and numpy-made
inputs: the capacity-bounded gather dispatch at capacity factors 0.5, 1.25
and E/k (the same expert indices, the same tokens in the same grid cells,
the same drops; outputs within 1e-5 of max|out|), the evaluate-every-expert
oracle, the dispatch against the oracle when no slot is dropped (rtol
2e-4, as the reference's smoke test), and the deterministic combine (two
calls bit-equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch import interop
from repro_torch.models import moe as TM

B, S, D, E, K, FF = 2, 16, 32, 8, 2, 16
FRAC = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module; the worker's
    own setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["silu", "gelu"])
def carried(request):
    p = JM.init_moe(jax.random.PRNGKey(0), D, E, FF, 1, request.param,
                    jnp.float32)
    x = np.random.default_rng(1).standard_normal((B, S, D)).astype(np.float32)
    return request.param, p, interop.tree_from_numpy(
        jax.tree.map(np.asarray, p), "cpu"), x


def grid_capture():
    """An `act_in` hook that records the expert-major grid (which token
    sits in which capacity cell, zero rows where dropped or empty)."""
    seen = {}

    def act_in(x, tag):
        if tag == "expert_in":
            seen["grid"] = np.asarray(x)
        return x
    return seen, act_in


def close(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= FRAC * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("cf", [0.5, 1.25, E / K])
def test_dispatch_matches_the_reference(carried, cf):
    act, p, tp, x = carried
    jv, ji = JM._route(jnp.asarray(x), p["router"], K)
    tv, ti = TM._route(torch.from_numpy(x), tp["router"], K)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    close(tv, jv)
    jseen, jhook = grid_capture()
    tseen, thook = grid_capture()
    kw = dict(n_experts=E, top_k=K, capacity_factor=cf, act=act)
    want = JM.moe_ffn(jnp.asarray(x), p, act_in=jhook, **kw)
    got = TM.moe_ffn(torch.from_numpy(x), tp, act_in=thook, **kw)
    c = TM.capacity(S, E, K, cf)
    assert jseen["grid"].shape == tseen["grid"].shape == (B, E, c, D)
    # the same tokens in the same cells, the same cells empty or dropped
    assert np.array_equal(jseen["grid"] == 0, tseen["grid"] == 0)
    close(tseen["grid"], jseen["grid"])
    _, _, cells = TM.dispatch(ti, tv, E, c)
    dropped = int((cells == E * c).sum())
    if cf == E / K:
        assert dropped == 0            # capacity >= S: nothing dropped
    elif cf == 0.5:
        assert dropped > 0
    close(got, want)


def test_oracle_matches_the_reference(carried):
    act, p, tp, x = carried
    kw = dict(n_experts=E, top_k=K, act=act)
    close(TM.moe_ffn_dense_oracle(torch.from_numpy(x), tp, **kw),
          JM.moe_ffn_dense_oracle(jnp.asarray(x), p, **kw))


def test_dispatch_equals_the_oracle_without_drops(carried):
    """With capacity >= S no slot is dropped, so the gather dispatch is
    the oracle up to summation order."""
    act, _, tp, x = carried
    xt = torch.from_numpy(x)
    got = TM.moe_ffn(xt, tp, n_experts=E, top_k=K, capacity_factor=E / K,
                     act=act)
    want = TM.moe_ffn_dense_oracle(xt, tp, n_experts=E, top_k=K, act=act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4 * float(want.abs().max()))


def test_combine_is_deterministic(carried):
    act, _, tp, x = carried
    xt = torch.from_numpy(x)
    kw = dict(n_experts=E, top_k=K, capacity_factor=1.25, act=act)
    assert torch.equal(TM.moe_ffn(xt, tp, **kw), TM.moe_ffn(xt, tp, **kw))


def test_padded_rows_take_no_capacity_from_live_ones(carried):
    """Routing is per batch row: a row's output does not depend on what
    the other rows hold."""
    act, _, tp, x = carried
    xt = torch.from_numpy(x)
    kw = dict(n_experts=E, top_k=K, capacity_factor=0.5, act=act)
    alone = TM.moe_ffn(xt[:1], tp, **kw)
    padded = TM.moe_ffn(torch.cat([xt[:1], torch.zeros_like(xt[:1])]), tp,
                        **kw)
    assert torch.equal(alone[0], padded[0])
