"""Shared layers: norms, RoPE, GQA attention (no cache, dense cache, paged
pool), the SwiGLU / GELU feed-forward, cache construction, the page scatter
and seeded inits.

Everything is a plain function over tensors and explicit parameter
dictionaries. `paged_write_rows`, and `attention` with a cache, update the
cache **in place** (the JAX counterparts return new arrays); every other
function is pure.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..distributed.context import (gather_weights, local_offset,
                                   local_shard, local_to_dtensor,
                                   mesh_axis_size, on_mesh, reduce_over,
                                   shard_act, with_axis)
from ..kernels import ops as kops
from ..kernels.hadamard_quant import _recip_f32
from ..kernels.paged_attention import rope_frequencies as _rope_frequencies

Params = dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.to(torch.float32)).to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.to(torch.float32)
            + beta.to(torch.float32)).to(x.dtype)


def apply_norm(x, p: Params, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    """RoPE inverse frequencies [head_dim / 2] f32: one host-computed table
    shared with the paged-attention kernel, so the rotation of new rows and
    the in-walk rotation of cached rows use the same literal."""
    return _rope_frequencies(head_dim, theta, device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, H, Dh]; positions: [B, S] (absolute). Half-split layout."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs     # [B, S, Dh/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention geometry, caches, page scatter
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    chunk_q: int = 2048    # flash-style chunking thresholds
    chunk_kv: int = 2048


def _dense_attention(q, k, v, *, causal, q_offset=0):
    """Reference attention: q [B,Sq,H,Dh], k/v [B,Sk,KH,Dh] (H = KH*G)."""
    b, sq, h, dh = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * _recip_f32(math.sqrt(dh))
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(b, sq, h, dh).to(q.dtype)


def _chunked_attention(q, k, v, *, causal, chunk_q, chunk_kv, q_offset=0):
    """Flash-style online-softmax attention over KV chunks: memory is
    O(chunk_q * chunk_kv) per head instead of O(S^2)."""
    b, sq, h, dh = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    dev = q.device
    nq = -(-sq // chunk_q)
    nk = -(-sk // chunk_kv)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * chunk_q - sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * chunk_kv - sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * chunk_kv - sk))
    qp = qp.reshape(b, nq, chunk_q, kh, g, dh).to(torch.float32)
    kp = kp.reshape(b, nk, chunk_kv, kh, dh).to(torch.float32)
    vp = vp.reshape(b, nk, chunk_kv, kh, dh).to(torch.float32)
    scale = _recip_f32(math.sqrt(dh))
    outs = []
    for qi in range(nq):
        qc = qp[:, qi]
        m = torch.full((b, kh, g, chunk_q), -math.inf, device=dev)
        l = torch.zeros((b, kh, g, chunk_q), device=dev)
        acc = torch.zeros((b, kh, g, chunk_q, dh), device=dev)
        qpos = qi * chunk_q + torch.arange(chunk_q, device=dev) + q_offset
        for ki in range(nk):
            logits = torch.einsum("bqkgd,bskd->bkgqs", qc, kp[:, ki]) * scale
            kpos = ki * chunk_kv + torch.arange(chunk_kv, device=dev)
            valid = (kpos[None, :] < sk).expand(chunk_q, chunk_kv)
            if causal:
                valid = valid & (kpos[None, :] <= qpos[:, None])
            logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vp[:, ki])
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(torch.einsum("bkgqd->bqkgd", out))
    out = torch.stack(outs, dim=1).reshape(b, nq * chunk_q, h, dh)
    return out[:, :sq].to(q.dtype)


def chunk_positions(b: int, s: int, cache_index, device) -> torch.Tensor:
    """Absolute positions [B, S] of a chunk at fill position `cache_index`:
    None (from 0), an int, or a [B] tensor (per-slot). Computed on the
    device from a tensor index, so a captured decode step reads nothing
    back."""
    steps = torch.arange(s, device=device, dtype=torch.int32)[None, :]
    if torch.is_tensor(cache_index) and cache_index.dim() == 1:
        return cache_index.to(device=device, dtype=torch.int32)[:, None] + steps
    return (steps + int(cache_index or 0)).expand(b, s)


def attention(x: torch.Tensor, p: Params, spec: AttnSpec, *,
              cache: Params | None = None, cache_index=None,
              block_table: torch.Tensor | None = None,
              seq_lengths: torch.Tensor | None = None, act_in=None):
    """GQA attention. Returns (out, cache).

    cache = {"k": [B, S_max, KH, Dh], "v": ...} for decode, updated in
    place; `cache_index` is the fill position (an int, or a [B] tensor of
    per-slot positions with S == 1). With `block_table` [B, P] the cache is
    one layer's page pool ([n_pages, page_size, KH, Dh], float, post-RoPE
    K): the new rows are scattered into their pages and
    `kernels.ops.paged_attention` walks the table (`seq_lengths` [B] end
    each walk). `act_in(x, tag)` is the PTQ hook on every projection input
    (quantise or capture).
    """
    b, s, _ = x.shape
    h, kv, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    p = gather_weights(p)
    if act_in is not None:
        x = act_in(x, "qkv")
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if spec.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if on_mesh(x):
        if block_table is not None:
            raise ValueError("the paged path runs on one device")
        out = _attention_on_mesh(q, k, v, spec, cache, cache_index)
        if act_in is not None:
            out = act_in(out, "wo")
        return shard_act(out @ p["wo"], ("batch", "seq", "embed")), cache
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kv, dh)
    v = v.reshape(b, s, kv, dh)
    per_slot = torch.is_tensor(cache_index) and cache_index.dim() == 1
    positions = chunk_positions(b, s, cache_index, x.device)
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)

    if cache is not None and block_table is not None:
        # block-table-native: K is stored post-RoPE, so the kernel applies
        # no rotation
        paged_write_rows(cache["k"], k, block_table, positions)
        paged_write_rows(cache["v"], v, block_table, positions)
        out = kops.paged_attention(q, cache, block_table, positions,
                                   seq_lengths).to(x.dtype)
    elif cache is not None:
        if per_slot:
            if s != 1:
                raise ValueError("per-slot cache_index requires q_len == 1")
            rows = torch.arange(b, device=x.device)
            idx = cache_index.to(torch.int64)
            cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
        else:
            i = int(cache_index)
            cache["k"][:, i:i + s] = k.to(cache["k"].dtype)
            cache["v"][:, i:i + s] = v.to(cache["v"].dtype)
        k_all, v_all = cache["k"], cache["v"]
        s_k = k_all.shape[1]
        if s == 1:
            # decode: mask positions beyond the (per-row) fill point
            valid = torch.arange(s_k, device=x.device)[None, :] \
                <= positions[:, :1]                               # [B, S_k]
            g = h // kv
            qg = q.reshape(b, 1, kv, g, dh)
            logits = torch.einsum(
                "bqkgd,bskd->bkgqs", qg.to(torch.float32),
                k_all.to(torch.float32)) * _recip_f32(math.sqrt(dh))
            logits = torch.where(valid[:, None, None, None, :], logits,
                                 torch.full_like(logits, -1e30))
            probs = torch.softmax(logits, dim=-1)
            out = torch.einsum("bkgqs,bskd->bqkgd", probs,
                               v_all.to(torch.float32))
            out = out.reshape(b, 1, h, dh).to(x.dtype)
        elif s <= spec.chunk_q and s_k <= spec.chunk_kv:
            # a short chunk: stale rows beyond the fill point sit at
            # positions past every query's, so the causal mask hides them
            out = _dense_attention(q, k_all, v_all, causal=spec.causal,
                                   q_offset=int(cache_index))
        else:
            out = _chunked_attention(q, k_all, v_all, causal=spec.causal,
                                     chunk_q=spec.chunk_q,
                                     chunk_kv=spec.chunk_kv,
                                     q_offset=int(cache_index))
    elif s > spec.chunk_q:
        out = _chunked_attention(q, k, v, causal=spec.causal,
                                 chunk_q=spec.chunk_q, chunk_kv=spec.chunk_kv)
    else:
        out = _dense_attention(q, k, v, causal=spec.causal)

    out = out.reshape(b, s, h * dh)
    if act_in is not None:
        out = act_in(out, "wo")
    return out @ p["wo"], cache


def _attention_on_mesh(q, k, v, spec: AttnSpec, cache, cache_index):
    """`attention` past its projections on a mesh of ranks: q, k, v
    [B, S, H·Dh] DTensors -> out [B, S, H·Dh] DTensor; a dense cache of
    DTensor leaves ([B, S_max, KH, Dh] views) is written in place.

    Each rank runs the one-device code on its shards. When the KV heads
    divide the model axis, attention is head-parallel (q, k, v and the
    cache split by heads; no collective). Otherwise k and v are gathered
    over the model axis and the queries split by sequence (a train or
    prefill chunk; each rank attends its rows to every key) or, for a
    decode step, replicated against a cache split by sequence
    (`distributed.shardings.cache_spec`): flash-decoding, whose partial
    softmax maxima, sums and outputs are all-reduced over the model axis.
    """
    from torch.distributed.tensor import Replicate, Shard
    m = mesh_axis_size("model")
    b, s, _ = q.shape
    dh = spec.head_dim
    decode = cache is not None and s == 1
    heads = spec.n_kv_heads % m == 0
    q_pl = Shard(2) if heads else Replicate() if decode else Shard(1)
    kv_pl = Shard(2) if heads else Replicate()
    q = with_axis(q, "model", q_pl)
    k = with_axis(k, "model", kv_pl)
    v = with_axis(v, "model", kv_pl)
    b0, s0 = local_offset(q, 0), local_offset(q, 1)
    ql, kl, vl = local_shard(q), local_shard(k), local_shard(v)
    bl = ql.shape[0]
    ql = ql.reshape(bl, ql.shape[1], -1, dh)
    kl = kl.reshape(bl, kl.shape[1], -1, dh)
    vl = vl.reshape(bl, vl.shape[1], -1, dh)
    dev = ql.device
    idx = cache_index
    per_slot = torch.is_tensor(idx) and idx.dim() == 1
    if per_slot:
        idx = idx[b0:b0 + bl]
    start = 0 if per_slot else int(idx or 0)
    ql = apply_rope(ql, chunk_positions(bl, ql.shape[1], idx, dev) + s0,
                    spec.rope_theta)
    kl = apply_rope(kl, chunk_positions(bl, kl.shape[1], idx, dev),
                    spec.rope_theta)
    scale = _recip_f32(math.sqrt(dh))
    if cache is None:
        attend = _chunked_attention if ql.shape[1] > spec.chunk_q \
            else _dense_attention
        kw = dict(chunk_q=spec.chunk_q, chunk_kv=spec.chunk_kv) \
            if attend is _chunked_attention else {}
        out = attend(ql, kl, vl, causal=spec.causal, q_offset=s0, **kw)
    else:
        ck, cv = cache["k"], cache["v"]
        c0 = local_offset(ck, 1)
        ckl, cvl = ck.to_local(), cv.to_local()
        sk_l = ckl.shape[1]
        seq_cache = sk_l < ck.shape[1]
        if per_slot:
            # each row's new entry, where it falls in this rank's part
            pos = idx.to(torch.int64) - c0
            inside = ((pos >= 0) & (pos < sk_l))[:, None, None]
            pos = pos.clamp(0, sk_l - 1)
            rows = torch.arange(bl, device=dev)
            for buf, new in ((ckl, kl), (cvl, vl)):
                buf[rows, pos] = torch.where(inside, new[:, 0].to(buf.dtype),
                                             buf[rows, pos])
        else:
            lo, hi = max(start, c0), min(start + s, c0 + sk_l)
            if lo < hi:
                ckl[:, lo - c0:hi - c0] = kl[:, lo - start:hi - start].to(
                    ckl.dtype)
                cvl[:, lo - c0:hi - c0] = vl[:, lo - start:hi - start].to(
                    cvl.dtype)
        if decode:
            qpos = chunk_positions(bl, 1, idx, dev)
            valid = (torch.arange(sk_l, device=dev)[None, :] + c0) \
                <= qpos[:, :1]
            kh = ckl.shape[2]
            qg = ql.reshape(bl, 1, kh, ql.shape[2] // kh, dh)
            logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                                  ckl.to(torch.float32)) * scale
            logits = torch.where(valid[:, None, None, None, :], logits,
                                 torch.full_like(logits, -1e30))
            if seq_cache:
                mx = reduce_over(logits.amax(-1, keepdim=True), q, "model",
                                 "max")
                e = torch.exp(logits - mx)
                den = reduce_over(e.sum(-1, keepdim=True), q, "model")
                out = torch.einsum("bkgqs,bskd->bqkgd", e,
                                   cvl.to(torch.float32))
                out = reduce_over(out, q, "model") \
                    / torch.movedim(den[..., 0], 3, 1)[..., None]
            else:
                out = torch.einsum("bkgqs,bskd->bqkgd",
                                   torch.softmax(logits, dim=-1),
                                   cvl.to(torch.float32))
            out = out.reshape(bl, 1, -1, dh).to(q.dtype)
        else:
            k_all, v_all = ckl, cvl
            if seq_cache and start == 0 and s == ck.shape[1]:
                # the chunk fills the whole cache: its rows, already
                # gathered, are the cache's
                k_all, v_all = kl, vl
            elif seq_cache:
                k_all = with_axis(ck, "model", Replicate()).to_local()
                v_all = with_axis(cv, "model", Replicate()).to_local()
            if ql.shape[1] <= spec.chunk_q and k_all.shape[1] <= spec.chunk_kv:
                out = _dense_attention(ql, k_all, v_all, causal=spec.causal,
                                       q_offset=start + s0)
            else:
                out = _chunked_attention(ql, k_all, v_all, causal=spec.causal,
                                         chunk_q=spec.chunk_q,
                                         chunk_kv=spec.chunk_kv,
                                         q_offset=start + s0)
    out = local_to_dtensor(out.reshape(bl, out.shape[1], -1), q, q.shape)
    # heads over the model axis, as the row-parallel wo takes them (an
    # all-to-all from the sequence split)
    return with_axis(out, "model", Shard(2)) if q_pl == Shard(1) else out


def init_attention_cache(batch: int, max_len: int, spec: AttnSpec,
                         dtype=torch.bfloat16, device="cuda") -> Params:
    kv, dh = spec.n_kv_heads, spec.head_dim
    return {"k": torch.zeros((batch, max_len, kv, dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, max_len, kv, dh), dtype=dtype, device=device)}


def paged_write_rows(buf: torch.Tensor, val: torch.Tensor,
                     block_table: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Scatter new KV rows straight into their pages, in place.

    buf [n_pages, T, ...] pool leaf; val [B, S, ...]; block_table [B, P];
    positions [B, S] absolute positions. Row (b, s) lands at
    (block_table[b, positions // T], positions % T). Padded rows target the
    scratch page (or in-page slots that are overwritten before the causal
    mask ever exposes them), so duplicate writes are harmless. Returns
    `buf`.
    """
    t = buf.shape[1]
    pos = positions.to(torch.int64)
    cols = torch.div(pos, t, rounding_mode="floor")
    page_ids = torch.gather(block_table.to(torch.int64), 1, cols)
    buf.index_put_((page_ids, pos % t), val.to(buf.dtype))
    return buf


def layer_view(tree: Params, i: int) -> Params:
    """Views of layer `i` of a tree of stacked `[n_layers, ...]` leaves."""
    return {k: (layer_view(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def unstack(tree: Params, n: int) -> list[Params]:
    """The views of every layer at once (`torch.unbind` per leaf). Their
    gradients meet in the stacked leaf through one stack per leaf, where
    `n` separate `layer_view`s would each scatter into a zero-filled copy
    of the whole leaf."""
    flat = {k: (unstack(v, n) if isinstance(v, dict) else torch.unbind(v))
            for k, v in tree.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Seeded initialisation
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def init_attention(gen: torch.Generator, d_model: int, spec: AttnSpec,
                   dtype) -> Params:
    h, kv, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    sc = 1.0 / math.sqrt(d_model)
    p = {
        "wq": _normal(gen, (d_model, h * dh), sc, dtype),
        "wk": _normal(gen, (d_model, kv * dh), sc, dtype),
        "wv": _normal(gen, (d_model, kv * dh), sc, dtype),
        "wo": _normal(gen, (h * dh, d_model), 1.0 / math.sqrt(h * dh), dtype),
    }
    if spec.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((h * dh,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv * dh,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv * dh,), dtype=dtype, device=dev)
    return p


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype) -> Params:
    sc_in = 1.0 / math.sqrt(d_model)
    sc_out = 1.0 / math.sqrt(d_ff)
    p = {}
    if act == "silu":  # SwiGLU
        p["w_gate"] = _normal(gen, (d_model, d_ff), sc_in, dtype)
    p["w_up"] = _normal(gen, (d_model, d_ff), sc_in, dtype)
    p["w_down"] = _normal(gen, (d_ff, d_model), sc_out, dtype)
    return p


def mlp(x: torch.Tensor, p: Params, act: str, down_proj_fn=None,
        act_in=None) -> torch.Tensor:
    """SwiGLU (act="silu") or tanh-GELU MLP. `down_proj_fn(h, w_down)`
    overrides the last projection: the PTQ hook where the online block
    rotation R3 and the activation quantiser are injected."""
    p = gather_weights(p)
    if act_in is not None:
        x = act_in(x, "ffn")
    if act == "silu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    h = shard_act(h, ("batch", "seq", "mlp"))
    if down_proj_fn is not None:
        return shard_act(down_proj_fn(h, p["w_down"]),
                         ("batch", "seq", "embed"))
    return shard_act(h @ p["w_down"], ("batch", "seq", "embed"))


def init_norm(d_model: int, kind: str, dtype, device="cuda") -> Params:
    p = {"scale": torch.ones((d_model,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p
