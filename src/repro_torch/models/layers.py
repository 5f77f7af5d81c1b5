"""Layer pieces the integer serving path needs: norms, RoPE, the attention
geometry record, cache construction, the page scatter, and seeded inits.

Everything is a plain function over tensors and explicit parameter
dictionaries. `paged_write_rows` updates its pool **in place** (the JAX
counterpart returns a new array); every other function is pure.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

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


def init_norm(d_model: int, kind: str, dtype, device="cuda") -> Params:
    p = {"scale": torch.ones((d_model,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p
