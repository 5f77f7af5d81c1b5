"""The port's Mamba2 block (`repro_torch.models.ssm`) against the JAX
package's, on the same seeded parameters (carried across) and numpy-made
inputs: the causal conv (with a carried state, with and without
`valid_len`), the chunked SSD scan (with a carried state), the SSD against
a numpy sequential recurrence, the whole block's chunked carry against its
recurrent decode with a right-padded last chunk, and the register-pool
gather and write-back against the reference's. f32; 1e-5 of max|value|
against JAX (other summation orders), 2e-3 against the recurrence (the
reference test's bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch import interop
from repro_torch.models import ssm as TS

B, D, EXPAND, HD, N, W, CHUNK = 2, 32, 2, 16, 8, 4, 8
FRAC = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module; the worker's
    own setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried():
    p = JS.init_ssm(jax.random.PRNGKey(0), D, expand=EXPAND, head_dim=HD,
                    state=N, conv_width=W, dtype=jnp.float32)
    # non-trivial conv bias, skip and dt bias
    rng = np.random.default_rng(5)
    p = dict(p)
    for k in ("conv_b", "D", "dt_bias"):
        p[k] = jnp.asarray(rng.standard_normal(p[k].shape).astype(np.float32)
                           * 0.3)
    return p, interop.tree_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def close(got, want, frac=FRAC):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (err, np.abs(want).max())


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_causal_conv_matches_the_reference(masked):
    rng = np.random.default_rng(1)
    x, w, b = rand(rng, B, 9, 12), rand(rng, W, 12), rand(rng, 12)
    init = rand(rng, B, W - 1, 12)
    vl = np.array([9, 4], np.int32) if masked else None
    jo, jt = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             init_state=jnp.asarray(init),
                             valid_len=None if vl is None else jnp.asarray(vl))
    to, tt = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b),
                             init_state=torch.from_numpy(init),
                             valid_len=None if vl is None
                             else torch.from_numpy(vl))
    close(to, jo)
    close(tt, jt)
    if masked:
        # row 1's tail ends at its 4th token, not at the padded end
        xp = np.concatenate([init, x], 1)
        assert np.array_equal(tt[1].numpy(), xp[1, 4:4 + W - 1])


def ssd_inputs(s, seed=2):
    rng = np.random.default_rng(seed)
    h = EXPAND * D // HD
    x = rand(rng, B, s, h, HD)
    dt = np.log1p(np.exp(rand(rng, B, s, h))).astype(np.float32)
    a = -np.exp(rng.uniform(0, 2, h)).astype(np.float32)
    bm, cm = rand(rng, B, s, N), rand(rng, B, s, N)
    init = rand(rng, B, h, N, HD, scale=0.5)
    return x, dt, a, bm, cm, init


@pytest.mark.parametrize("s", [8, 13])
def test_ssd_chunked_matches_the_reference(s):
    x, dt, a, bm, cm, init = ssd_inputs(s)
    jy, jst = JS.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), CHUNK,
                             init_state=jnp.asarray(init))
    ty, tst = TS.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)),
                             CHUNK, init_state=torch.from_numpy(init))
    close(ty, jy)
    close(tst, jst)


def test_ssd_chunked_matches_a_sequential_recurrence():
    x, dt, a, bm, cm, init = ssd_inputs(21, seed=3)
    y, st = TS.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)), CHUNK,
                           init_state=torch.from_numpy(init))
    state = init.astype(np.float64)
    ys = []
    for t in range(x.shape[1]):
        decay = np.exp(dt[:, t] * a)                           # [b, h]
        upd = np.einsum("bn,bh,bhp->bhnp", bm[:, t], dt[:, t], x[:, t])
        state = state * decay[:, :, None, None] + upd
        ys.append(np.einsum("bn,bhnp->bhp", cm[:, t], state))
    close(y, np.stack(ys, 1), frac=2e-3)
    close(st, state, frac=2e-3)


def block(tp, x, cache=None, **kw):
    return TS.ssm_block(x, tp, head_dim=HD, state=N, chunk=CHUNK,
                        cache=cache, **kw)


def test_block_chunked_carry_equals_recurrent_decode(carried):
    """Prefill in a 5-token chunk and a right-padded last chunk (3 live of
    8, `valid_len`), then decode: the outputs and the carried state equal
    running the same tokens one recurrent step at a time."""
    _, tp = carried
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rand(rng, B, 10, D))
    one = TS.init_ssm_cache(B, D, expand=EXPAND, head_dim=HD, state=N,
                            conv_width=W, dtype=torch.float32, device="cpu")
    steps = [block(tp, x[:, t:t + 1], one) for t in range(10)]
    step_out = torch.cat(steps, dim=1)
    chunked = TS.init_ssm_cache(B, D, expand=EXPAND, head_dim=HD, state=N,
                                conv_width=W, dtype=torch.float32,
                                device="cpu")
    first = block(tp, x[:, :5], chunked)
    tail = torch.cat([x[:, 5:8], torch.zeros(B, 5, D)], dim=1)
    second = block(tp, tail, chunked, valid_len=torch.tensor([3, 3]))
    close(torch.cat([first, second[:, :3]], 1), step_out[:, :8], frac=1e-4)
    want = _state_after(tp, x[:, :8])
    for k in ("conv", "state"):
        close(chunked[k], want[k], frac=1e-4)
    more = [block(tp, x[:, t:t + 1], chunked) for t in range(8, 10)]
    close(torch.cat(more, 1), step_out[:, 8:], frac=1e-4)


def _state_after(tp, x):
    c = TS.init_ssm_cache(x.shape[0], D, expand=EXPAND, head_dim=HD, state=N,
                          conv_width=W, dtype=torch.float32, device="cpu")
    for t in range(x.shape[1]):
        block(tp, x[:, t:t + 1], c)
    return c


@pytest.mark.parametrize("s", [1, 6])
def test_register_pools_match_the_reference(carried, s):
    """Slot pools gathered by `register_index` and written back once:
    the live slots' new state and the outputs equal the reference's
    (padded rows point at scratch slot 0, which is never compared)."""
    p, tp = carried
    rng = np.random.default_rng(6)
    n_slots = 5
    one = JS.init_ssm_cache(n_slots, D, expand=EXPAND, head_dim=HD, state=N,
                            conv_width=W, dtype=jnp.float32)
    pools = {k: rand(rng, *v.shape, scale=0.5) for k, v in one.items()}
    x = rand(rng, 3, s, D)
    reg = np.array([3, 0, 1], np.int32)                  # row 1 is padding
    vl = np.array([s, 0, max(s - 2, 1)], np.int32) if s > 1 else None
    jo, jc = JS.ssm_block(jnp.asarray(x), p, head_dim=HD, state=N,
                          chunk=CHUNK,
                          cache={k: jnp.asarray(v) for k, v in pools.items()},
                          register_index=jnp.asarray(reg),
                          valid_len=None if vl is None else jnp.asarray(vl))
    tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    to = block(tp, torch.from_numpy(x), tpools,
               register_index=torch.from_numpy(reg),
               valid_len=None if vl is None else torch.from_numpy(vl))
    close(to[[0, 2]], np.asarray(jo)[[0, 2]])
    for k in ("conv", "state"):
        close(tpools[k][[1, 2, 3, 4]], np.asarray(jc[k])[[1, 2, 3, 4]])
        # slots no row points at are untouched
        assert np.array_equal(tpools[k][[2, 4]].numpy(), pools[k][[2, 4]])
