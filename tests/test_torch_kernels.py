"""The port's kernel modules against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs as its own tests run it here: the Pallas kernels in interpret mode
through `repro.kernels.ops`; for paged attention the un-jitted kernel entry
with `interpret=True` inside a scope that aliases the compiler-params class
this JAX version renamed, and removes the alias again. The port runs on
`device="cpu"`, i.e. each kernel's plain PyTorch version.
"""
import contextlib
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import block_hadamard as jbh
from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import block_hadamard as tbh_mod
from repro_torch.kernels import hadamard_quant as thq_mod
from repro_torch.kernels import int4_matmul as ti4_mod
from repro_torch.kernels.int4_matmul import int4_colsum, int4_plan


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(t):
    return t.detach().cpu().numpy()


@contextlib.contextmanager
def tpu_compiler_params_alias():
    """`pltpu.TPUCompilerParams` for the duration of one call only - a
    process-wide alias would change which of the JAX package's own tests
    pass depending on the worker that ran this file."""
    from jax.experimental.pallas import tpu as pltpu
    had = hasattr(pltpu, "TPUCompilerParams")
    if not had:
        pltpu.TPUCompilerParams = pltpu.CompilerParams
    try:
        yield
    finally:
        if not had:
            del pltpu.TPUCompilerParams


def jax_paged_attention(q, kv, bt, qpos, lens, **kw):
    with tpu_compiler_params_alias():
        out = jpa.paged_attention.__wrapped__(
            jnp.asarray(q), {k: jnp.asarray(v) for k, v in kv.items()},
            jnp.asarray(bt), jnp.asarray(qpos),
            None if lens is None else jnp.asarray(lens),
            interpret=True, **kw)
    return np.asarray(out)


# -------------------- int4 pack / scales --------------------

def test_int4_pack_unpack_exact():
    rng = np.random.default_rng(0)
    codes = rng.integers(-8, 8, (64, 34)).astype(np.int8)
    want = np.asarray(jref.int4_pack(jnp.asarray(codes)))
    got = tref.int4_pack(T(codes))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(N(got), want)
    np.testing.assert_array_equal(N(tref.int4_unpack(got)), codes)
    np.testing.assert_array_equal(
        N(tref.int4_unpack(got)), np.asarray(jref.int4_unpack(jnp.asarray(want))))
    with pytest.raises(ValueError):
        tref.int4_pack(T(codes[:63]))


@pytest.mark.parametrize("on_grid", [True, False])
def test_infer_scales_and_pack_weights_exact(on_grid):
    """Same grid, same nibbles, and the stored column sums are those of
    the unpacked codes. Exact: every step is elementwise f32 arithmetic or
    an integer sum, and the candidate errors are far from ties."""
    rng = np.random.default_rng(1)
    k, n = 96, 34
    if on_grid:
        s = rng.uniform(0.01, 0.1, (1, n)).astype(np.float32)
        top = rng.integers(3, 8, (n,))             # some channels never hit 7
        w = (np.clip(rng.integers(-7, 8, (k, n)), -top, top) * s).astype(np.float32)
    else:
        w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    js = np.asarray(jops.infer_int4_scales(jnp.asarray(w)))
    ts = tops.infer_int4_scales(T(w))
    np.testing.assert_array_equal(N(ts), js)
    jp = jops.pack_int4_weights(jnp.asarray(w))
    tp = tops.pack_int4_weights(T(w))
    np.testing.assert_array_equal(N(tp["packed"]), np.asarray(jp["packed"]))
    np.testing.assert_array_equal(N(tp["scale"]), np.asarray(jp["scale"]))
    unpacked = np.asarray(jref.int4_unpack(jp["packed"])).astype(np.int64)
    np.testing.assert_array_equal(N(tp["colsum"]), unpacked.sum(0))
    assert tp["colsum"].dtype == torch.int32
    np.testing.assert_array_equal(N(int4_colsum(tp["packed"])), unpacked.sum(0))
    # explicit scales, given as [1, N]
    tp2 = tops.pack_int4_weights(T(w), T(js[None]))
    np.testing.assert_array_equal(N(tp2["packed"]), N(tp["packed"]))


# -------------------- int4_matmul --------------------

@pytest.mark.parametrize("m,k,n", [
    (4, 128, 64), (16, 256, 128), (33, 64, 34),   # N = 2 * prime
    (1, 250, 514),                                 # K = 2 * odd, N = 2 * prime
])
def test_int4_matmul_matches_jax_kernel(m, k, n):
    """Integer accumulator exact; output to rtol 1e-6 (the epilogue is three
    f32 roundings in the same order on both sides; XLA may fuse a
    multiply-add)."""
    rng = np.random.default_rng(2)
    qa = rng.integers(0, 16, (m, k)).astype(np.int8)
    wc = rng.integers(-7, 8, (k, n)).astype(np.int8)
    sa = rng.uniform(0.01, 0.2, (m, 1)).astype(np.float32)
    za = np.round(rng.uniform(-12, 0, (m, 1))).astype(np.float32)
    sw = rng.uniform(0.001, 0.02, (n,)).astype(np.float32)
    wp = N(tref.int4_pack(T(wc)))
    acc_want = qa.astype(np.int64) @ wc.astype(np.int64)
    ones_m, ones_n = np.ones_like(sa), np.ones_like(sw)
    acc = tops.int4_matmul(T(qa), T(ones_m), T(np.zeros_like(za)), T(wp), T(ones_n))
    np.testing.assert_array_equal(N(acc).astype(np.int64), acc_want)
    want = np.asarray(jops.int4_matmul(jnp.asarray(qa), jnp.asarray(sa),
                                       jnp.asarray(za), jnp.asarray(wp),
                                       jnp.asarray(sw)))
    for w_scale in (sw, sw[None]):                 # [N] and [1, N]
        got = tops.int4_matmul(T(qa), T(sa), T(za), T(wp), T(w_scale))
        assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
        np.testing.assert_allclose(N(got), want, rtol=1e-6, atol=1e-7)
    # stored column sums give the same bits as recomputed ones
    got_cs = tops.int4_matmul(T(qa), T(sa), T(za), T(wp), T(sw),
                              int4_colsum(T(wp)))
    np.testing.assert_array_equal(N(got_cs), N(got))


def test_int4_matmul_leading_dims():
    rng = np.random.default_rng(3)
    qa = rng.integers(0, 16, (2, 3, 64)).astype(np.int8)
    sa = rng.uniform(0.01, 0.2, (2, 3, 1)).astype(np.float32)
    za = np.round(rng.uniform(-12, 0, (2, 3, 1))).astype(np.float32)
    wp = rng.integers(0, 256, (32, 48)).astype(np.uint8)
    sw = rng.uniform(0.001, 0.02, (48,)).astype(np.float32)
    want = np.asarray(jops.int4_matmul(*(jnp.asarray(a) for a in (qa, sa, za, wp, sw))))
    got = tops.int4_matmul(T(qa), T(sa), T(za), T(wp), T(sw))
    assert tuple(got.shape) == (2, 3, 48)
    np.testing.assert_allclose(N(got), want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        tops.int4_matmul(T(qa[..., :62]), T(sa), T(za), T(wp), T(sw))


@pytest.mark.parametrize("m,n,k", [(4, 2048, 2048), (4, 512, 2048),
                                   (32, 8192, 2048), (4, 2048, 8192),
                                   (256, 8192, 2048), (5, 514, 250),
                                   (16, 8192, 2048), (17, 8192, 2048),
                                   (1, 8, 64), (130, 1024, 512),
                                   (33, 514, 250), (4, 2048, 131072)])
def test_int4_split_plan_covers_k(m, n, k):
    """`int4_plan` (which replaced `split_plan`): the K splits cover the
    packed rows once, each a whole number of the kernel's 64-row stages,
    the grid covers M and N, and the shared memory fits one H100 block."""
    p = int4_plan(m, n, k)
    k2 = k // 2
    assert p.k_rows % 64 == 0 and p.splits >= 1
    assert p.k_rows * p.splits >= k2 > p.k_rows * (p.splits - 1)
    assert p.grid[1] == p.splits
    assert p.grid[0] * 128 >= n > (p.grid[0] - 1) * 128
    assert p.grid[2] * p.rows >= m > (p.grid[2] - 1) * p.rows
    assert p.rows == (32 if m <= 32 else 64) and p.threads == 4 * p.rows
    assert p.smem_bytes == 4 * (64 * 128 + p.rows * 160) <= 232_448


def test_int4_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="even K"):
        int4_plan(4, 64, 63)
    with pytest.raises(ValueError, match="even K"):
        int4_plan(0, 64, 64)
    qa = torch.zeros((2, 63), dtype=torch.int8)
    with pytest.raises(ValueError, match="packed K"):
        ti4_mod.int4_matmul(qa, torch.ones(2, 1), torch.zeros(2, 1),
                            torch.zeros((31, 8), dtype=torch.uint8), torch.ones(8))


# -------------------- hadamard_quant / quantize_act --------------------

@pytest.mark.parametrize("b", [1, 16, 32, 12])
@pytest.mark.parametrize("bits", [4, 8])
def test_hadamard_quant_matches_jax_kernel(b, bits):
    """scale / zero to rtol 1e-5; dequantised values within one scale step;
    codes differ at no more than 0.5 % of the entries. The two sides sum the
    rotation in different orders, so a rotated value can land on the other
    side of a rounding tie - one code step, never more."""
    rng = np.random.default_rng(4)
    d = 384 if b == 12 else 256
    x = (rng.standard_normal((2, 9, d)) * 3).astype(np.float32)
    x[..., ::37] *= 10.0
    if b == 1:
        jc, js, jz = jops.quantize_act(jnp.asarray(x), bits)
        tc, ts, tz = tops.quantize_act(T(x), bits)
    else:
        jc, js, jz = jops.hadamard_quant(jnp.asarray(x), b, bits=bits)
        tc, ts, tz = tops.hadamard_quant(T(x), b, bits=bits)
    jc, js, jz = (np.asarray(a) for a in (jc, js, jz))
    assert tc.dtype == torch.int8 and tuple(tc.shape) == x.shape
    assert tuple(ts.shape) == tuple(tz.shape) == (2, 9, 1)
    np.testing.assert_allclose(N(ts), js, rtol=1e-5)
    np.testing.assert_allclose(N(tz), jz, rtol=1e-5, atol=0)
    deq_t = N(ts) * (N(tc).astype(np.float32) + N(tz))
    deq_j = js * (jc.astype(np.float32) + jz)
    assert np.all(np.abs(deq_t - deq_j) <= js * 1.0001)
    assert np.mean(N(tc) != jc) <= 5e-3
    if bits == 4:
        assert N(tc).min() >= 0 and N(tc).max() <= 15


def test_hadamard_quant_vs_independent_oracle_and_errors():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 128)).astype(np.float32)
    tc, ts, tz = tops.hadamard_quant(T(x), 32)
    rot = np.asarray(jref.block_hadamard_ref(jnp.asarray(x), 32))
    deq = N(ts) * (N(tc).astype(np.float32) + N(tz))
    step = (rot.max(-1) - rot.min(-1)) / 15
    assert (np.abs(deq - rot).max(-1) <= step + 1e-5).all()
    np.testing.assert_allclose(N(tref.block_hadamard_ref(T(x), 32)), rot, atol=1e-5)
    with pytest.raises(ValueError):
        tops.hadamard_quant(T(x), 48)


# -------------------- paged attention --------------------

B, KH, G, DH = 3, 2, 2, 32
H = KH * G


def make_pool(rng, fmt, n_pages, t):
    shape = (n_pages, t, KH, DH)
    if fmt == "float":
        return {"k": rng.standard_normal(shape).astype(np.float32),
                "v": rng.standard_normal(shape).astype(np.float32)}
    bits = {"int8": 8, "int4": 4}[fmt]
    off, levels = 2 ** (bits - 1), 2 ** bits - 1
    kv = {}
    for nm in ("k", "v"):
        kv[nm] = (rng.integers(0, levels + 1, shape) - off).astype(np.int8)
        # scales sized so that dequantised values are O(1) in both formats
        # (the absolute tolerance below is a few f32 ulps at that size)
        hi = 0.2 if bits == 4 else 0.0125
        kv[nm + "_scale"] = rng.uniform(
            hi / 10, hi, (n_pages, t, KH, 1)).astype(np.float32)
        kv[nm + "_zero"] = np.round(rng.uniform(
            -0.75 * levels, 0.125 * levels,
            (n_pages, t, KH, 1))).astype(np.float32)
    return kv


def numpy_oracle(q, kv, bt, qpos, *, kv_bits, rope_theta):
    """Gather-to-slab + plain-softmax causal attention in float64 numpy,
    written independently of both kernels' helpers."""
    b, s, h, dh = q.shape
    t, kh = kv["k"].shape[1], kv["k"].shape[2]
    g = h // kh
    sk = bt.shape[1] * t
    k = kv["k"][bt].reshape(b, sk, kh, dh).astype(np.float64)
    v = kv["v"][bt].reshape(b, sk, kh, dh).astype(np.float64)
    if kv_bits is not None:
        off = 2 ** (kv_bits - 1)
        k = kv["k_scale"][bt].reshape(b, sk, kh, 1) * (
            k + off + kv["k_zero"][bt].reshape(b, sk, kh, 1))
        v = kv["v_scale"][bt].reshape(b, sk, kh, 1) * (
            v + off + kv["v_zero"][bt].reshape(b, sk, kh, 1))
        freqs = 1.0 / rope_theta ** (np.arange(0, dh, 2) / dh)
        ang = np.arange(sk)[:, None] * freqs
        cos, sin = np.cos(ang)[None, :, None], np.sin(ang)[None, :, None]
        k1, k2 = k[..., :dh // 2], k[..., dh // 2:]
        k = np.concatenate([k1 * cos - k2 * sin, k2 * cos + k1 * sin], -1)
    qg = q.astype(np.float64).reshape(b, s, kh, g, dh)
    logits = np.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(dh)
    valid = np.arange(sk)[None, None, :] <= qpos[:, :, None]
    logits = np.where(valid[:, None, None], logits, -np.inf)
    logits -= logits.max(-1, keepdims=True)
    p = np.exp(logits)
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bkgqs,bskd->bqkgd", p, v)
    return out.reshape(b, s, h, dh)


def make_case(rng, fmt, t, s, lens, n_cols):
    n_pages = 1 + B * n_cols
    kv = make_pool(rng, fmt, n_pages, t)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, n_cols), np.int32)
    for i, ln in enumerate(lens):
        used = -(-ln // t)
        bt[i, :used] = perm[i * n_cols:i * n_cols + used]
    q = rng.standard_normal((B, s, H, DH)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    qpos = np.stack([np.arange(max(ln - s, 0), max(ln - s, 0) + s)
                     for ln in lens]).astype(np.int32)
    bits = {"float": None, "int8": 8, "int4": 4}[fmt]
    kw = dict(rope_theta=10000.0 if bits else None, kv_bits=bits,
              kv_group=DH if bits else None)
    return q, kv, bt, qpos, lens, kw


@pytest.mark.parametrize("fmt", ["float", "int8", "int4"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_paged_attention_plain_matches_jax_kernel_and_oracle(fmt, mode):
    """atol 2e-5 in f32 against the interpret-mode JAX kernel (same walk,
    same split order; einsum and exp implementations differ in the last
    bits) and against the float64 gather + softmax oracle. Ragged lengths,
    one row of length 0 (comes out as exact zeros), and - for decode - a
    table wider than 4 columns so the split path and the combine run."""
    rng = np.random.default_rng(6)
    t = 8
    if mode == "prefill":
        s, lens, n_cols = 8, [24, 8, 13], 4
    else:
        s, lens, n_cols = 1, [50, 0, 17], 8
    q, kv, bt, qpos, lens, kw = make_case(rng, fmt, t, s, lens, n_cols)
    if mode == "decode":
        assert tpa.resolve_tiling(s, KH, n_cols)[1] > 1
    want = jax_paged_attention(q, kv, bt, qpos, lens, **kw)
    got = tops.paged_attention(T(q), {k: T(v) for k, v in kv.items()}, T(bt),
                               T(qpos), T(lens), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(N(got), want, atol=2e-5, rtol=0)
    live = lens > 0
    oracle = numpy_oracle(q, kv, bt, qpos, kv_bits=kw["kv_bits"],
                          rope_theta=kw["rope_theta"])
    if mode == "prefill":
        # rows whose position precedes the sequence (none here) aside, every
        # query row of a live sequence is comparable
        np.testing.assert_allclose(N(got)[live], oracle[live], atol=2e-5, rtol=0)
    else:
        np.testing.assert_allclose(N(got)[live], oracle[live], atol=2e-5, rtol=0)
        assert np.all(N(got)[~live] == 0.0)
    assert np.isfinite(N(got)).all()


def test_paged_attention_without_seq_lengths_and_explicit_splits():
    rng = np.random.default_rng(7)
    q, kv, bt, qpos, lens, kw = make_case(rng, "int4", 8, 1, [50, 9, 17], 8)
    tkv = {k: T(v) for k, v in kv.items()}
    base = tops.paged_attention(T(q), tkv, T(bt), T(qpos), T(lens), **kw)
    derived = tops.paged_attention(T(q), tkv, T(bt), T(qpos), None, **kw)
    np.testing.assert_array_equal(N(derived), N(base))
    want = jax_paged_attention(q, kv, bt, qpos, None, kv_splits=3, **kw)
    got = tops.paged_attention(T(q), tkv, T(bt), T(qpos), None, kv_splits=3, **kw)
    np.testing.assert_allclose(N(got), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(N(got), N(base), atol=2e-5, rtol=0)


def test_combine_partials_with_dead_splits():
    rng = np.random.default_rng(8)
    b, ks, h, s, dh = 2, 4, 4, 3, 16
    m = (rng.standard_normal((b, ks, h, s)) * 4).astype(np.float32)
    l = rng.uniform(0.5, 8, (b, ks, h, s)).astype(np.float32)
    acc = rng.standard_normal((b, ks, h, s, dh)).astype(np.float32)
    m[:, 2:] = -np.inf
    l[:, 2:] = 0
    acc[:, 2:] = 0
    m[1, :, 0] = -np.inf          # one output row with no live split at all
    l[1, :, 0] = 0
    acc[1, :, 0] = 0
    got = N(tpa.combine_partials_plain(T(m), T(l), T(acc)))
    want = np.stack([np.asarray(jpa.combine_partials(
        jnp.asarray(m[i]), jnp.asarray(l[i]), jnp.asarray(acc[i])))
        for i in range(b)])
    assert got.shape == (b, s, h, dh)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-6)
    assert np.all(got[1, :, 0] == 0.0) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, N(tref.combine_partials_ref(T(m), T(l), T(acc))))


def _merge_partials(rng, b, ks, h, s, dh):
    """Seeded split partials with dead splits (m = -inf, l = 0, acc = 0: the
    upper half of the splits of batch row 0, every split past the first of
    row 1) and output rows with no live split at all (row b - 1, head 0)."""
    m = (rng.standard_normal((b, ks, h, s)) * 4).astype(np.float32)
    l = rng.uniform(0.5, 16, (b, ks, h, s)).astype(np.float32)
    acc = rng.standard_normal((b, ks, h, s, dh)).astype(np.float32)
    dead = np.zeros((b, ks, h, s), bool)
    dead[0, ks // 2:] = True
    dead[1, 1:] = True
    dead[b - 1, :, 0] = True
    m[dead], l[dead], acc[dead] = -np.inf, 0.0, 0.0
    return m, l, acc


def _emulate_merged_launch(m, l, acc, kh, order):
    """numpy f32 emulation of one split launch of the attention kernel's
    epilogue: the blocks (batch row, KV head, split) - one query block -
    finish in `order`; each writes its partial rows of its G heads into the
    launch's partial buffers (garbage before) and arrives at its tile's
    counter; the last to arrive resets the counter and merges the tile from
    splits 0..KS-1 in that order, op for op as `merge_tile` in
    csrc/paged_attention.cu (every f32 product and sum rounded once). ->
    (out [B, S, H, Dh], the counters after the launch)."""
    b, ks, h, s, dh = acc.shape
    g = h // kh
    bufs = [np.full_like(x, np.nan) for x in (m, l, acc)]
    out = np.full((b, s, h, dh), np.nan, np.float32)
    cnt = np.zeros(b * kh, np.int32)
    f32 = np.float32
    for bi, khi, k in order:
        heads = slice(khi * g, (khi + 1) * g)
        for buf, x in zip(bufs, (m, l, acc)):
            buf[bi, k, heads] = x[bi, k, heads]
        tile = bi * kh + khi
        cnt[tile] += 1
        if cnt[tile] != ks:
            continue
        cnt[tile] = 0
        mp, lp, ap = (buf[bi, :, heads] for buf in bufs)
        mx = np.full(mp.shape[1:], -np.inf, f32)
        for j in range(ks):
            mx = np.maximum(mx, mp[j])
        l_tot = np.zeros_like(mx)
        a_tot = np.zeros(ap.shape[1:], f32)
        for j in range(ks):
            with np.errstate(invalid="ignore"):
                w = np.where(np.isneginf(mp[j]), f32(0), np.exp(mp[j] - mx)).astype(f32)
            l_tot = (l_tot + (lp[j] * w).astype(f32)).astype(f32)
            a_tot = (a_tot + (ap[j] * w[..., None]).astype(f32)).astype(f32)
        o = (a_tot / np.maximum(l_tot, f32(1e-30))[..., None]).astype(f32)
        out[bi, :, heads] = o.transpose(1, 0, 2)
    return out, cnt


@pytest.mark.parametrize("ks", [2, 3, 8, 13])
def test_attention_merge_emulation_matches_jax_combine(ks):
    """The merge by the last-arriving split gives one bit pattern whatever
    order the split blocks finish in, that pattern is the JAX
    `combine_partials` within 1e-6 relative, a row with no live split comes
    out exactly 0, and every counter is zero after the launch."""
    rng = np.random.default_rng(20 + ks)
    b, kh, g, s, dh = 3, 2, 4, 1, 16
    m, l, acc = _merge_partials(rng, b, ks, kh * g, s, dh)
    blocks = [(bi, khi, k) for bi in range(b) for khi in range(kh) for k in range(ks)]
    first = None
    for trial in range(6):
        order = blocks if trial == 0 else [blocks[i] for i in rng.permutation(len(blocks))]
        out, cnt = _emulate_merged_launch(m, l, acc, kh, order)
        assert not cnt.any()
        if first is None:
            first = out
        np.testing.assert_array_equal(out, first)
    # 1e-6 relative to the largest output of the row: the weights' exp
    # differs between numpy, XLA and the card by an ulp, and the merged sums
    # carry that error relative to their terms, not to their (cancelling) sum
    for other in (np.stack([np.asarray(jpa.combine_partials(
            jnp.asarray(m[i]), jnp.asarray(l[i]), jnp.asarray(acc[i])))
            for i in range(b)]),
            N(tpa.combine_partials_plain(T(m), T(l), T(acc)))):
        scale = np.abs(other).max(axis=-1, keepdims=True)
        assert np.all(np.abs(first - other) <= 1e-6 * scale)
    assert np.all(first[b - 1, :, 0] == 0.0) and np.isfinite(first).all()


def test_tiling_and_used_pages_equal_on_a_sweep():
    for s in (1, 2, 3, 4, 8, 12, 16, 32, 33):
        for kh in (1, 2, 8):
            for n_cols in (1, 2, 4, 5, 8, 16, 31, 32, 33, 64, 100):
                assert tpa.resolve_tiling(s, kh, n_cols) \
                    == jpa.resolve_tiling(s, kh, n_cols)
                for ksp in (1, 2, 3, 7):
                    assert tpa.resolve_tiling(s, kh, n_cols, kv_splits=ksp) \
                        == jpa.resolve_tiling(s, kh, n_cols, kv_splits=ksp)
    with pytest.raises(ValueError):
        tpa.resolve_tiling(6, 2, 4, q_block=4)
    assert (tpa.SPLIT_PAGE_COLS, tpa.MAX_KV_SPLITS, tpa.MASK_VALUE) \
        == (jpa.SPLIT_PAGE_COLS, jpa.MAX_KV_SPLITS, jpa.MASK_VALUE)
    rng = np.random.default_rng(9)
    for page in (4, 8, 16):
        for n_cols in (1, 4, 9):
            lens = rng.integers(0, 200, (6,)).astype(np.int32)
            qpos = rng.integers(0, 200, (6, 3)).astype(np.int32)
            for ln in (lens, None):
                want = np.asarray(jpa.used_page_counts(
                    jnp.asarray(qpos), None if ln is None else jnp.asarray(ln),
                    page, n_cols))
                got = tpa.used_page_counts(
                    T(qpos), None if ln is None else T(ln), page, n_cols)
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(N(got), want)


@pytest.mark.parametrize("dh,theta", [(32, 10000.0), (64, 500000.0), (128, 1e6)])
def test_rope_frequencies_are_the_reference_literal(dh, theta):
    np.testing.assert_array_equal(N(tpa.rope_frequencies(dh, theta)),
                                  np.asarray(jpa.rope_frequencies(dh, theta)))


def test_block_hadamard_is_plain_only_and_dispatch_counts():
    """On the CPU every entry takes its plain version, tallied under the
    reference's path tag `ref`; no kernel launches."""
    x = torch.randn(3, 64)
    tops.reset_dispatch_counts()
    y = tops.block_hadamard(x, 16)
    np.testing.assert_allclose(
        N(y), np.asarray(jref.block_hadamard_ref(jnp.asarray(N(x)), 16)), atol=1e-5)
    tops.quantize_act(x)
    with tops.use_kernels(False):
        assert not tops.kernels_enabled()
        tops.quantize_act(x)
    assert tops.kernels_enabled()
    counts = tops.dispatch_counts()
    assert counts[("block_hadamard", "ref")] == 1
    assert counts[("quantize_act", "ref")] == 2
    assert all(path == "ref" for _, path in counts)        # CPU tensors
    assert set(tops.kernel_launch_counts()) == {
        "block_hadamard", "hadamard_quant", "int4_matmul", "paged_attention",
        "combine_partials"}
    assert all(v == 0 for v in tops.kernel_launch_counts().values())


def _bf16_ulp(a):
    """One bf16 unit in the last place of each entry of `a` (f32)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7).astype(np.float32)


@pytest.mark.parametrize("b,d", [(1, 256), (2, 256), (16, 256), (12, 384),
                                 (128, 256), (256, 256)])       # b = D last
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_hadamard_matches_jax_kernel(b, d, dtype):
    """The port's `ops.block_hadamard` (plain on the CPU) against the JAX
    interpret-mode kernel, with leading dims and row counts that are no
    multiple of the kernel's row tile. Both sides are dense products in f32
    summed in other orders: f32 output agrees within 1e-5 * max|y|, bf16
    output (the f32 result rounded once) within one bf16 ulp."""
    rng = np.random.default_rng(b)
    for shape in ((2, 5, d), (7, d)):
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        x[..., ::29] *= 20.0                                  # outlier channels
        xj = jnp.asarray(x, dtype)
        want = np.asarray(jbh.block_hadamard(xj, b).astype(jnp.float32))
        xt = T(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
        got = tops.block_hadamard(xt, b)
        assert got.dtype == xt.dtype and tuple(got.shape) == shape
        got = N(got.float())
        if dtype == "float32":
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        else:
            assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    with pytest.raises(ValueError, match="not divisible"):
        tops.block_hadamard(T(x[:, :d - 1].copy()), b if b > 1 else 2)


def test_module_wrappers_launch_or_raise():
    """The CPU-to-plain decision lives in `kernels.ops` only: the wrappers
    beside the kernels refuse a tensor that is not on a CUDA device."""
    from repro_torch.kernels import hadamard_quant as thq
    from repro_torch.kernels import int4_matmul as ti4
    x = torch.randn(2, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        thq.hadamard_quant(x, 16)
    codes, s, z = tops.quantize_act(x)
    w = tops.pack_int4_weights(torch.randn(32, 6))
    with pytest.raises(RuntimeError, match="CUDA"):
        ti4.int4_matmul(codes, s, z, w["packed"], w["scale"], w["colsum"])
    kv = {"k": torch.zeros(2, 4, 1, 8), "v": torch.zeros(2, 4, 1, 8)}
    with pytest.raises(RuntimeError, match="CUDA"):
        tpa.paged_attention(torch.zeros(1, 1, 2, 8), kv,
                            torch.zeros(1, 1, dtype=torch.int32),
                            torch.zeros(1, 1, dtype=torch.int32))
    kv9 = {"k": torch.zeros(9, 4, 1, 8), "v": torch.zeros(9, 4, 1, 8)}
    with pytest.raises(RuntimeError, match="CUDA"):      # a split call merges in-kernel
        tpa.paged_attention(torch.zeros(1, 1, 2, 8), kv9,
                            torch.zeros(1, 8, dtype=torch.int32),
                            torch.zeros(1, 1, dtype=torch.int32), kv_splits=2)
    from repro_torch.kernels import block_hadamard as tbh
    with pytest.raises(RuntimeError, match="CUDA"):
        tbh.block_hadamard(x, 16)
    with pytest.raises(ValueError, match="not divisible"):
        tbh.block_hadamard(x, 12)
    assert all(v == 0 for v in tops.kernel_launch_counts().values())


# -------------------- the kernel's launch plan --------------------

def _attention_configs():
    from repro_torch.configs.registry import all_configs
    return {name: (cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)
            for name, cfg in all_configs().items() if cfg.n_heads}


@pytest.mark.parametrize("page_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("t", [8, 16, 32])
@pytest.mark.parametrize("arch", sorted(_attention_configs()))
def test_attention_plan_covers_rows_and_fits(arch, t, page_dtype):
    """For every attention config of the repo: the plan's blocks cover each
    (query head, query position) of a KV head exactly once with warps of 16
    rows, its shared memory fits one H100 block, and a tile holds a page."""
    g, dh = _attention_configs()[arch]
    for s in (1, 8, 32):
        plan = tpa.attention_plan(g, s, dh, t, page_dtype,
                                  group=dh if page_dtype == torch.int8 else None)
        rows = g * plan.q_rows
        assert 1 <= plan.q_rows <= s
        assert plan.warps == -(-rows // 16)
        assert 1 <= plan.key_warps <= -(-plan.pages_per_tile * t // 8)
        assert plan.threads == 32 * max(4, plan.warps * plan.key_warps) <= 256
        assert plan.warps * plan.key_warps <= max(
            tpa.PLAN_DECODE[0], tpa.PLAN_PREFILL[0], plan.warps)
        assert plan.pages_per_tile >= 1
        assert plan.smem_bytes <= 232_448
        seen = []
        for qb in range(-(-s // plan.q_rows)):
            for r in range(plan.warps * 16):
                gi, si = r // plan.q_rows, qb * plan.q_rows + r % plan.q_rows
                if r < rows and si < s:
                    seen.append((gi, si))
        assert sorted(seen) == [(gi, si) for gi in range(g) for si in range(s)]


def test_attention_plan_refuses_what_the_kernel_cannot_run(monkeypatch):
    """A head dim that is no multiple of 8 (or above 128) is a clear
    ValueError from the wrapper, before any device check or launch; the
    plain version still takes it."""
    with pytest.raises(ValueError, match="multiple of 8"):
        tpa.attention_plan(4, 1, 36, 16, torch.int8)
    with pytest.raises(ValueError, match="at most 128"):
        tpa.attention_plan(4, 1, 256, 16, torch.bfloat16)
    kv = {"k": torch.zeros(3, 4, 1, 12), "v": torch.zeros(3, 4, 1, 12)}
    args = (torch.zeros(1, 1, 2, 12), kv, torch.ones(1, 2, dtype=torch.int32),
            torch.zeros(1, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 8"):
        tpa.paged_attention(*args)
    assert tops.kernel_launch_counts()["paged_attention"] == 0
    assert tpa.paged_attention_plain(*args).shape == (1, 1, 2, 12)
    # more rows than a block's 8 warps hold move to fewer query rows per block
    monkeypatch.setattr(tpa, "PLAN_ROWS", 1024)
    plan = tpa.attention_plan(4, 64, 64, 16, torch.bfloat16)
    assert 4 * plan.q_rows <= 128 and plan.warps <= 8


# -------------------- the new kernels' plans and arithmetic --------------------

@pytest.mark.parametrize("m,d,b", [(4, 8192, 16), (32, 8192, 16), (37, 2048, 32),
                                   (1, 2048, 1), (3, 6, 2), (5, 20, 4), (9, 19200, 64),
                                   (32, 8192, 256), (4, 4096, 512), (32, 2048, 2048),
                                   (2, 16384, 16384), (1, 32768, 32768),
                                   (32, 3072, 12), (7, 240, 20), (2, 2304, 768)])
def test_hadamard_plan_covers_and_fits(m, d, b):
    """Every b-block of x [m, d] is covered once by whole threads: the warp
    kernel's b-blocks lie inside one warp, the block kernel gives each its
    own block within 1024 threads and the card's shared memory, the dense
    kernel's threads stay inside one b-block."""
    p = tbh_mod.hadamard_plan(m, d, b)
    chunks = m * d // p.elems
    assert d % p.elems == 0 and p.threads % 32 == 0
    if b & (b - 1):
        assert p.kind == "dense" and b % p.elems == 0
    elif b <= 32 * p.elems:
        assert p.kind == "warp" and p.threads <= 256 and p.smem_bytes == 0
        assert p.elems == min(tbh_mod.PLAN_ELEMS, d & -d)
    else:
        assert p.kind == "block" and p.threads * p.elems == b <= 32 * 1024
        assert p.grid == m * d // b and p.smem_bytes == 4 * b <= 232_448
        return
    assert p.grid * p.threads >= chunks > (p.grid - 1) * p.threads


def test_hadamard_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="not divisible"):
        tbh_mod.hadamard_plan(2, 48, 32)
    with pytest.raises(ValueError, match="shared memory"):
        tbh_mod.hadamard_plan(1, 65536, 65536)


@pytest.fixture(scope="module")
def plan_check_lib(tmp_path_factory):
    """`csrc/plan_check.h` - the checks the C launches run on a plan -
    compiled for the host, with a C entry for each check."""
    import ctypes
    import shutil
    import subprocess
    from repro_torch.kernels import _build
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to compile csrc/plan_check.h"
    d = tmp_path_factory.mktemp("plan_check")
    (d / "shim.cpp").write_text(
        '#include "plan_check.h"\n'
        'extern "C" int bh_ok(long long m, long long d, long long b, int dense, int kind,'
        ' int e, int threads, long long grid, long long smem) {'
        ' return plan::hadamard_plan_ok(m, d, b, dense, kind, e, threads, grid, smem); }\n'
        'extern "C" int i4_ok(long long m, long long n, long long k, int rows,'
        ' long long k_rows, int splits, int threads, long long gx, long long gy,'
        ' long long gz, long long smem, int ws) {'
        ' return plan::int4_plan_ok(m, n, k, rows, k_rows, splits, threads, gx, gy, gz,'
        ' smem, ws); }\n'
        'extern "C" int hq_ok(long long m, long long d, long long b, int dense, int kind,'
        ' int e, int threads, int cluster, long long grid, long long smem) {'
        ' return plan::hadamard_quant_plan_ok(m, d, b, dense, kind, e, threads, cluster,'
        ' grid, smem); }\n'
        'extern "C" int att_ok(long long b, long long kh, long long s, long long q_rows,'
        ' int splits, int partials, long long counters) {'
        ' return plan::attention_merge_ok(b, kh, s, q_rows, splits, partials, counters); }\n')
    so = d / "libplan_check.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{_build.CSRC}",
                    str(d / "shim.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    L, I = ctypes.c_longlong, ctypes.c_int
    lib.bh_ok.argtypes = [L, L, L, I, I, I, I, L, L]
    lib.i4_ok.argtypes = [L, L, L, I, L, I, I, L, L, L, L, I]
    lib.hq_ok.argtypes = [L, L, L, I, I, I, I, I, L, L]
    lib.att_ok.argtypes = [L, L, L, L, I, I, L]
    return lib


_I4_SHAPES = [(m, n, k) for m in (1, 4, 5, 16, 17, 32, 33, 64, 65, 130)
              for n, k in ((2048, 2048), (512, 2048), (8192, 2048), (2048, 8192),
                           (514, 250), (8, 64))]


def test_int4_plans_pass_the_c_launch_check(plan_check_lib):
    """Every plan `int4_plan` makes is one the C launch accepts, and each
    plan with one field off by a step is refused."""
    for m, n, k in _I4_SHAPES:
        p = int4_plan(m, n, k)
        fields = dict(rows=p.rows, k_rows=p.k_rows, splits=p.splits, threads=p.threads,
                      gx=p.grid[0], gy=p.grid[1], gz=p.grid[2],
                      smem=p.smem_bytes, ws=1)
        assert plan_check_lib.i4_ok(m, n, k, *fields.values()) == 1, (m, n, k, p)
        for key in fields:
            if key == "ws" and p.splits == 1:
                continue
            bad = {**fields, key: fields[key] + (1 if key != "ws" else -1)}
            assert plan_check_lib.i4_ok(m, n, k, *bad.values()) == 0, (m, n, k, key)


def test_attention_merge_plans_pass_the_c_launch_check(plan_check_lib):
    """The counters the wrapper sizes for a split launch (`merge_tiles`,
    with the plan's query rows and the resolved split count) are what the C
    launch accepts, and each field off by a step is refused: a tile more
    (batch row, KV head, query block), a counter fewer, no partials."""
    for g, dh in sorted(set(_attention_configs().values())):
        for s in (1, 3, 8, 32, 33):
            for n_cols, kv_splits in ((8, None), (32, None), (256, None), (16, 13),
                                      (5, 2), (1, None)):
                for b, kh in ((1, 1), (4, 8), (3, 2)):
                    q_rows = tpa.attention_plan(g, s, dh, 16, torch.int8, group=dh).q_rows
                    _, splits, _, _ = tpa.resolve_tiling(s, kh, n_cols, kv_splits=kv_splits)
                    f = dict(b=b, kh=kh, s=s, q_rows=q_rows, splits=splits, partials=1,
                             counters=tpa.merge_tiles(b, kh, s, q_rows))
                    assert plan_check_lib.att_ok(*f.values()) == 1, f
                    if splits == 1:
                        continue
                    for key, v in (("b", b + 1), ("kh", kh + 1), ("s", s + q_rows),
                                   ("counters", f["counters"] - 1), ("partials", 0)):
                        assert plan_check_lib.att_ok(*{**f, key: v}.values()) == 0, (f, key)


def test_hadamard_plans_pass_the_c_launch_check(plan_check_lib):
    kinds = {"warp": 0, "block": 1, "dense": 2}
    for m in (1, 4, 37):
        for d, bs in ((8192, (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 2048, 8192)),
                      (240, (12, 20, 4)), (2304, (768,)), (18, (2,)), (32768, (32768,))):
            for b in bs:
                p = tbh_mod.hadamard_plan(m, d, b)
                f = dict(dense=int(p.kind == "dense"), kind=kinds[p.kind], e=p.elems,
                         threads=p.threads, grid=p.grid, smem=p.smem_bytes)
                assert plan_check_lib.bh_ok(m, d, b, *f.values()) == 1, (m, d, b, p)
                for key in ("kind", "e", "threads", "grid", "smem", "dense"):
                    bad = {**f, key: {"e": 3, "dense": 1 - f["dense"]}.get(key, f[key] + 1)}
                    assert plan_check_lib.bh_ok(m, d, b, *bad.values()) == 0, (m, d, b, key)


# -------------------- hadamard_quant's cluster plan and arithmetic --------------------

_HQ_D_B = [(8192, b) for b in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 2048, 8192)] + [
    (240, 12), (240, 20), (240, 4), (2304, 768), (18, 2), (32768, 32768),
    (19200, 64), (19200, 12)]


def _hq_slices(d, b, p):
    """(start, length) of each slice of a row, as the kernel cuts it: the
    units (whole b-blocks and E-chunks) shared out, the first ones one more."""
    unit = b if p.kind == "dense" else max(b, p.elems)
    units = d // unit
    q, extra = divmod(units, p.cluster)
    return [((r * q + min(r, extra)) * unit, (q + (r < extra)) * unit)
            for r in range(p.cluster)]


@pytest.mark.parametrize("d,b", _HQ_D_B)
@pytest.mark.parametrize("m", [1, 4, 37])
def test_hadamard_quant_plan_covers_and_fits(m, d, b):
    """Every element of every row is one thread's, once; each slice holds
    whole b-blocks and whole E-chunks; a b-block of the shuffle kind lies in
    one warp; the cluster is a portable size and tiles the grid by rows; the
    threads and the shared memory fit one block."""
    p = thq_mod.hadamard_quant_plan(m, d, b)
    assert p.cluster in (1, 2, 4, 8) and p.grid == m * p.cluster
    assert p.threads % 32 == 0 and p.threads <= 1024
    assert p.smem_bytes + 4096 <= 232_448    # the static partials take the rest
    assert p.kind == ("dense" if b & (b - 1) else "warp" if b <= 32 * p.elems else "block")
    seen = np.zeros(d, np.int64)
    widest = 0
    for start, length in _hq_slices(d, b, p):
        assert length > 0
        for edge in (start, length):
            assert edge % b == 0 and edge % p.elems == 0
        widest = max(widest, length)
        for t in range(p.threads):
            if t * p.elems < length:
                lo = start + t * p.elems
                seen[lo:lo + p.elems] += 1
                if p.kind == "warp" and b > p.elems:
                    first = t - (lo % b) // p.elems        # the b-block's first thread
                    assert first // 32 == (first + b // p.elems - 1) // 32
    assert (seen == 1).all()
    assert p.threads == -(-widest // p.elems // 32) * 32
    assert p.smem_bytes == (4 * widest if p.kind == "block" else 0)


def test_hadamard_quant_plans_pass_the_c_launch_check(plan_check_lib):
    """Every plan `hadamard_quant_plan` makes is one the C launch accepts,
    and each plan with one field off by a step is refused."""
    kinds = {"warp": 0, "block": 1, "dense": 2}
    for m in (1, 4, 37):
        for d, b in _HQ_D_B:
            p = thq_mod.hadamard_quant_plan(m, d, b)
            f = dict(dense=int(p.kind == "dense"), kind=kinds[p.kind], e=p.elems,
                     threads=p.threads, cluster=p.cluster, grid=p.grid,
                     smem=p.smem_bytes)
            assert plan_check_lib.hq_ok(m, d, b, *f.values()) == 1, (m, d, b, p)
            for key in f:
                bad = {**f, key: {"e": 3, "dense": 1 - f["dense"],
                                  "cluster": 2 * f["cluster"] if f["cluster"] < 8 else 16
                                  }.get(key, f[key] + 1)}
                assert plan_check_lib.hq_ok(m, d, b, *bad.values()) == 0, (m, d, b, key)


def test_hadamard_quant_plan_refuses_what_the_kernel_cannot_run(monkeypatch):
    with pytest.raises(ValueError, match="not divisible"):
        thq_mod.hadamard_quant_plan(2, 48, 32)
    with pytest.raises(ValueError, match="does not fit"):
        thq_mod.hadamard_quant_plan(1, 65536, 65536)      # a b-block past shared memory
    with pytest.raises(ValueError, match="does not fit"):
        thq_mod.hadamard_quant_plan(4, 12 * 4000, 12)     # 8 slices of > 1024 threads
    with pytest.raises(ValueError, match="m >= 1"):
        thq_mod.hadamard_quant_plan(0, 2048, 16)
    monkeypatch.setattr(thq_mod, "PLAN_CLUSTER", 8)        # fewer units than slices
    with pytest.raises(ValueError, match="does not fit"):
        thq_mod.hadamard_quant_plan(4, 8192, 8192)
    monkeypatch.setattr(thq_mod, "PLAN_CLUSTER", 1)        # the sweep's knobs
    monkeypatch.setattr(thq_mod, "PLAN_ELEMS", 16)
    p = thq_mod.hadamard_quant_plan(4, 8192, 16)
    assert (p.cluster, p.elems, p.threads, p.grid) == (1, 16, 512, 4)


def _nmin(a, b):
    return a if (a != a or a < b) else b


def _nmax(a, b):
    return a if (a != a or a > b) else b


def _emulate_hadamard_quant(x, b, bits, rng):
    """`csrc/hadamard_quant.cu`'s arithmetic in numpy float32 for a power-of-
    two b: the butterfly stage by stage (stride 1 first, (a, c) -> (a + c,
    a - c)), one multiply by f32(1 / sqrt(b)), each slice's NaN-propagating
    min / max, the slices' partials merged in a random order, the range
    times f32(1 / levels), true f32 divisions, rint half to even, fmax /
    fmin clipping (a NaN code becomes 0) and int8 storage."""
    m, d = x.shape
    f32 = np.float32
    y = x.astype(f32).copy()
    if b > 1:
        s = 1
        while s < b:
            v = y.reshape(m, d // (2 * s), 2, s)
            a, c = v[:, :, 0, :].copy(), v[:, :, 1, :].copy()
            v[:, :, 0, :] = a + c
            v[:, :, 1, :] = a - c
            s *= 2
        y = y * (f32(1.0) / np.sqrt(f32(b)))
    p = thq_mod.hadamard_quant_plan(m, d, b)
    lv = f32(2 ** bits - 1)
    codes = np.zeros((m, d), np.int8)
    scale = np.zeros((m, 1), f32)
    zero = np.zeros((m, 1), f32)
    for r in range(m):
        parts = [(y[r, lo:lo + n].min(), y[r, lo:lo + n].max())
                 for lo, n in _hq_slices(d, b, p)]
        mn, mx = f32(np.inf), f32(-np.inf)
        for i in rng.permutation(len(parts)):
            mn, mx = _nmin(mn, parts[i][0]), _nmax(mx, parts[i][1])
        s = np.maximum(f32(mx - mn) * (f32(1.0) / lv), np.finfo(f32).tiny)
        z = np.rint(f32(mn / s))
        q = np.rint((y[r] / s).astype(f32)) - z
        q = np.fmin(np.fmin(np.fmax(q, f32(0)), lv), f32(127))
        codes[r] = q.astype(np.int8)
        scale[r, 0], zero[r, 0] = s, z
    return codes, scale, zero


@pytest.mark.parametrize("m,d,b,bits,dtype", [
    (4, 2048, 1, 4, "bfloat16"),       # quantize_act on a decode step
    (4, 8192, 16, 4, "bfloat16"),      # the online rotation on a decode step
    (4, 8192, 16, 8, "float32"),
    (32, 8192, 16, 4, "bfloat16"),     # a prefill chunk
    (37, 2048, 32, 4, "float32"),
    (3, 19200, 64, 4, "float32"),      # uneven slices
    (2, 4096, 512, 4, "float32")])     # shared-memory rounds
def test_hadamard_quant_emulation_matches_jax_kernel(m, d, b, bits, dtype):
    """The kernel's arithmetic, emulated, against the JAX kernel in
    interpret mode, within `test_hadamard_quant_matches_jax_kernel`'s
    tolerance: scale and zero to 1e-5 relative, dequantised values within
    one scale step, codes different at no more than 0.5 % of the entries
    (the butterfly and the reference's dense product sum in other orders)."""
    rng = np.random.default_rng(m * d + b)
    x = (rng.standard_normal((m, d)) * 3).astype(np.float32)
    x[:, ::37] *= 10.0
    xj = jnp.asarray(x, dtype)
    x = np.array(xj.astype(jnp.float32))
    if b == 1:
        jc, js, jz = jops.quantize_act(xj, bits)
    else:
        jc, js, jz = jops.hadamard_quant(xj, b, bits=bits)
    jc, js, jz = (np.asarray(a) for a in (jc, js, jz))
    ec, es, ez = _emulate_hadamard_quant(x, b, bits, rng)
    np.testing.assert_allclose(es, js, rtol=1e-5)
    np.testing.assert_allclose(ez, jz, rtol=1e-5, atol=0)
    deq_e = es * (ec.astype(np.float32) + ez)
    deq_j = js * (jc.astype(np.float32) + jz)
    assert np.all(np.abs(deq_e - deq_j) <= js * 1.0001)
    assert np.mean(ec != jc) <= 5e-3
    # the emulation's butterfly against the port's plain version: the same
    # rotation, quantised by the same rule
    pc, ps, pz = (N(t) for t in thq_mod.hadamard_quant_plain(T(x), b, bits))
    np.testing.assert_allclose(es, ps, rtol=1e-5)
    assert np.mean(ec != pc) <= 5e-3


def test_hadamard_quant_emulation_nan_stays_in_its_row():
    """A NaN makes its own row's scale NaN; the partials of other rows never
    meet it, so their codes, scales and zeros are those of the clean run."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 8192)) * 3).astype(np.float32)
    clean = _emulate_hadamard_quant(x, 16, 4, rng)
    x[2, 5000] = np.nan
    dirty = _emulate_hadamard_quant(x, 16, 4, rng)
    assert np.isnan(dirty[1][2, 0]) and not np.isnan(np.delete(dirty[1], 2, 0)).any()
    for got, want in zip(dirty, clean):
        np.testing.assert_array_equal(np.delete(got, 2, 0), np.delete(want, 2, 0))


# A word-level emulation of `csrc/int4_matmul.cu`'s arithmetic: the byte
# transpose (__byte_perm), the mask-and-xor to offset codes w + 8, the
# even/odd activation words, the -8 * rowsum correction, split by split, and
# the mma.sync m16n8k32 fragment layouts of the PTX ISA with the kernel's
# swizzled shared-memory reads.

def _bp(x, y, sel):
    """__byte_perm(x, y, sel) on uint32 arrays (selector nibbles 0-7)."""
    src = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        sb = np.uint64(8 * ((sel >> (4 * i)) & 7))
        out |= ((src >> sb) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _transpose4(r0, r1, r2, r3):
    t0, t1 = _bp(r0, r1, 0x5140), _bp(r0, r1, 0x7362)
    t2, t3 = _bp(r2, r3, 0x5140), _bp(r2, r3, 0x7362)
    return [_bp(t0, t2, 0x5410), _bp(t0, t2, 0x7632), _bp(t1, t3, 0x5410),
            _bp(t1, t3, 0x7632)]


def _unpack8(u):
    u = np.asarray(u, np.uint32)
    return ((u & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808),
            ((u >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808))


def _s8(word):
    """The four signed bytes of uint32 words -> int64 [..., 4]."""
    b = (np.asarray(word, np.uint32)[..., None] >> np.arange(0, 32, 8, dtype=np.uint32)) & 0xFF
    b = b.astype(np.int64)
    return np.where(b >= 128, b - 256, b)


def _words(byte_rows):
    """uint8 [..., 4j] -> uint32 [..., j] little-endian words."""
    return np.ascontiguousarray(byte_rows).view(np.uint32)


def _act_words(qa, m0, rows, k0):
    """Even and odd activation words of K k0 .. k0+7 for `rows` rows from m0
    (zero past the edges): [rows] uint32 each."""
    m, k = qa.shape
    raw = np.zeros((rows, 8), np.uint8)
    r_hi, k_hi = min(m, m0 + rows), min(k, k0 + 8)
    if r_hi > m0 and k_hi > k0:
        raw[:r_hi - m0, :k_hi - k0] = qa[m0:r_hi, k0:k_hi].view(np.uint8)
    lo, hi = _words(raw[:, :4])[:, 0], _words(raw[:, 4:])[:, 0]
    return _bp(lo, hi, 0x6420), _bp(lo, hi, 0x7531)


def _mma(a_frags, b_frags):
    """mma.sync.m16n8k32.row.col s8: per-lane fragments as the PTX ISA lays
    them out (lane = 4 * groupID + threadID_in_group) -> per-lane C [32, 4]."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for reg in range(4):
            row = g + 8 * (reg % 2)
            col = 4 * t + 16 * (reg // 2)
            A[row, col:col + 4] = _s8(a_frags[lane][reg])
        for reg in range(2):
            B[4 * t + 16 * reg:4 * t + 16 * reg + 4, g] = _s8(b_frags[lane][reg])
    C = A @ B
    return [[C[lane // 4 + 8 * (i // 2), 2 * (lane % 4) + i % 2] for i in range(4)]
            for lane in range(32)]


def _emulate_mma(qa, wp, p):
    """The tensor-core kernel, block by block, warp by warp, lane by lane:
    shared-memory stages as `load_stage` fills them (weight chunks swizzled),
    fragments as the compute loop reads them, C scattered as the epilogue
    stores it (n8 tile j, column i -> 4 i + j)."""
    m, k = qa.shape
    k2, n = wp.shape
    out = np.zeros((m, n), np.int64)
    qa_u8 = qa.view(np.uint8)
    for bz in range(p.grid[2]):
        for bx in range(p.grid[0]):
            m0, nt0 = bz * p.rows, bx * 128
            for y in range(p.splits):
                kr0 = y * p.k_rows
                nrows = min(p.k_rows, k2 - kr0)
                kend = 2 * (kr0 + nrows)
                acc = {}
                for kt in range(-(-nrows // 64)):
                    rbase = kr0 + 64 * kt
                    bs = np.zeros(64 * 128, np.uint8)
                    for r in range(64):
                        for ch in range(8):
                            col = nt0 + 16 * ch
                            valid = max(0, min(16, n - col)) if rbase + r < kr0 + nrows else 0
                            dst = r * 128 + ((ch ^ (((r >> 2) & 3) << 1)) << 4)
                            if valid:
                                bs[dst:dst + valid] = wp[rbase + r, col:col + valid]
                    as_ = np.zeros((p.rows, 160), np.uint8)
                    for r in range(min(p.rows, m - m0)):
                        kk = 2 * rbase
                        valid = max(0, min(128, kend - kk, k - kk))
                        as_[r, :valid] = qa_u8[m0 + r, kk:kk + valid]
                    for wm in range(p.rows // 32):
                        for wn in range(4):
                            for ks in range(4):
                                a_fr, b_fr = {}, {}
                                for lane in range(32):
                                    g, t = lane // 4, lane % 4
                                    grp = 4 * ks + t
                                    for mt in range(2):
                                        r = 32 * wm + 16 * mt + g
                                        lo = _words(as_[r, 8 * grp:8 * grp + 8])
                                        hi = _words(as_[r + 8, 8 * grp:8 * grp + 8])
                                        a_fr[mt, lane] = [_bp(lo[0], lo[1], 0x6420),
                                                          _bp(hi[0], hi[1], 0x6420),
                                                          _bp(lo[0], lo[1], 0x7531),
                                                          _bp(hi[0], hi[1], 0x7531)]
                                    rw = []
                                    for q in range(4):
                                        row, ch = 4 * grp + q, 2 * wn + (g >> 2)
                                        at = row * 128 + ((ch ^ (((row >> 2) & 3) << 1)) << 4) \
                                            + 4 * (g & 3)
                                        rw.append(_words(bs[at:at + 4])[0])
                                    for j, col in enumerate(_transpose4(*rw)):
                                        b_fr[j, lane] = _unpack8(col)
                                ones = [(0x01010101, 0x01010101)] * 32
                                for mt in range(2):
                                    af = [a_fr[mt, lane] for lane in range(32)]
                                    rsum = _mma(af, ones)
                                    for j in range(4):
                                        c = _mma(af, [b_fr[j, lane] for lane in range(32)])
                                        for lane in range(32):
                                            g, t = lane // 4, lane % 4
                                            for h in range(2):
                                                for i in range(2):
                                                    key = (32 * wm + 16 * mt + g + 8 * h,
                                                           32 * wn + 4 * (2 * t + i) + j)
                                                    acc[key] = acc.get(key, 0) + \
                                                        c[lane][2 * h + i] - 8 * rsum[lane][2 * h]
                for (r, c), v in acc.items():
                    if m0 + r < m and nt0 + c < n:
                        out[m0 + r, nt0 + c] += v
    return out


def _jax_integer_part(qa, wp):
    m, n = qa.shape[0], wp.shape[1]
    return np.asarray(jops.int4_matmul(
        jnp.asarray(qa), jnp.ones((m, 1), jnp.float32), jnp.zeros((m, 1), jnp.float32),
        jnp.asarray(wp), jnp.ones((n,), jnp.float32))).astype(np.int64)


def test_int4_byte_transpose_and_offset_codes():
    """The selectors of the unpack: packed rows 4g..4g+3 of a column give the
    offset codes w + 8 of K 8g + (0, 2, 4, 6) and 8g + (1, 3, 5, 7), and the
    activation words hold the codes of the same K."""
    rng = np.random.default_rng(9)
    codes = rng.integers(-8, 8, (8, 12)).astype(np.int8)
    wp = N(tref.int4_pack(T(codes)))                       # [4, 12]
    cols = _transpose4(*[_words(wp[q]) for q in range(4)])
    for c in range(12):
        ev, od = _unpack8(cols[c % 4][c // 4])
        np.testing.assert_array_equal(_s8(ev), codes[0::2, c].astype(np.int64) + 8)
        np.testing.assert_array_equal(_s8(od), codes[1::2, c].astype(np.int64) + 8)
    qa = rng.integers(-128, 128, (3, 8)).astype(np.int8)
    ae, ao = _act_words(qa, 0, 3, 0)
    np.testing.assert_array_equal(_s8(ae), qa[:, 0::2])
    np.testing.assert_array_equal(_s8(ao), qa[:, 1::2])


@pytest.mark.parametrize("m,k,n,splits", [(17, 128, 128, 1), (40, 384, 136, 3),
                                          (33, 250, 130, 2), (4, 128, 64, 1),
                                          (5, 250, 514, 2), (16, 512, 40, 4),
                                          (1, 64, 8, 1), (3, 1024, 16, 2)])
def test_int4_mma_emulation_matches_jax_kernel(m, k, n, splits):
    """The tensor-core kernel's staging, swizzle, fragments and interleaved
    columns, emulated lane by lane on a plan with the given K splits,
    against the JAX kernel's integer part: exact - at decode-sized M too,
    where most of a tile's rows are zero."""
    rng = np.random.default_rng(11)
    qa = rng.integers(0, 16, (m, k)).astype(np.int8)
    qa[0, :] = 15
    wc = rng.integers(-8, 8, (k, n)).astype(np.int8)
    wc[:, 0] = -8
    wp = N(tref.int4_pack(T(wc)))
    p = int4_plan(m, n, k)
    k_rows = -(-(k // 2) // (64 * splits)) * 64
    p = dataclasses.replace(p, k_rows=k_rows, splits=-(-(k // 2) // k_rows),
                            grid=(p.grid[0], -(-(k // 2) // k_rows), p.grid[2]))
    assert p.splits == splits
    np.testing.assert_array_equal(_emulate_mma(qa, wp, p), _jax_integer_part(qa, wp))
