"""Permutation-equivariant region merging (Def 4.1 / Remark 4.2) and
rotation merging (QuaRot-style R1/R2), at the weight-matrix level.

The walkers that apply these to whole networks live in `core.pipeline`;
everything here is linear algebra on single weights.

Weight convention: ``y = x @ W + b`` with ``W: [d_in, d_out]``. A
permutation ``perm`` follows the `massdiff` convention, ``x[..., perm]``.
A producer emits permuted features with ``W[:, perm]`` (and ``b[perm]``), a
consumer accepts them with ``W[perm, :]``; then
``(x W1)[..., perm] @ W2[perm, :] == x W1 W2``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "permute_producer",
    "permute_consumer",
    "merge_perm_into_ffn",
    "rotate_producer",
    "rotate_consumer",
    "merge_head_rotation",
    "fold_rmsnorm",
    "center_matrix",
    "fold_layernorm_center",
]


def _index(perm, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(perm), dtype=torch.int64,
                           device=device)


# -- permutations -----------------------------------------------------------

def permute_producer(w: torch.Tensor, perm, bias: torch.Tensor | None = None):
    """Producer emits permuted features: W[:, perm] (+ b[perm])."""
    idx = _index(perm, w.device)
    wp = w[..., idx]
    return (wp, bias[..., idx]) if bias is not None else wp


def permute_consumer(w: torch.Tensor, perm) -> torch.Tensor:
    """Consumer accepts permuted features: W[perm, :]."""
    return torch.index_select(w, -2, _index(perm, w.device))


def merge_perm_into_ffn(w_gate, w_up, w_down, perm, b_gate=None, b_up=None):
    """Fig. 6: permute the FFN hidden dim. swish(xW_g) * (xW_u) is
    elementwise, so P merges into W_g, W_u (producers) and W_d
    (consumer)."""
    out = [permute_producer(w_gate, perm), permute_producer(w_up, perm),
           permute_consumer(w_down, perm)]
    for b in (b_gate, b_up):
        if b is not None:
            out.append(b[..., _index(perm, b.device)])
    return tuple(out)


# -- rotations --------------------------------------------------------------

def rotate_producer(w: torch.Tensor, r: torch.Tensor,
                    bias: torch.Tensor | None = None):
    """Producer emits rotated features: W <- W @ R (+ b <- b @ R)."""
    return (w @ r, bias @ r) if bias is not None else w @ r


def rotate_consumer(w: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Consumer accepts rotated features: W <- R^T @ W (orthogonal R)."""
    return r.T @ w


def merge_head_rotation(w_v: torch.Tensor, w_o: torch.Tensor,
                        r: torch.Tensor, n_kv_heads: int, n_q_heads: int):
    """R2, the per-head rotation between the V and O projections.

    w_v: [d, n_kv_heads*h], w_o: [n_q_heads*h, d], r: [h, h]. Each KV
    head's value slice is rotated on output, each query head's o-slice on
    input; query heads of a GQA group share a rotated KV head, so rotating
    every o-slice by the same R is consistent.
    """
    h = r.shape[0]
    d = w_v.shape[0]
    v = w_v.reshape(d, n_kv_heads, h) @ r
    o = torch.einsum("hk,qkd->qhd", r.T, w_o.reshape(n_q_heads, h, -1))
    return v.reshape(w_v.shape), o.reshape(w_o.shape)


# -- norm folding -----------------------------------------------------------

def fold_rmsnorm(gamma: torch.Tensor, consumers: list[torch.Tensor]):
    """Fold the RMSNorm scale into the consuming projections:
    (x*g) @ W == x @ (diag(g) W). Returns (ones_like(g), new consumers)."""
    return torch.ones_like(gamma), [gamma[:, None] * w for w in consumers]


def center_matrix(d: int) -> np.ndarray:
    """M = I - 11^T/d: LN(x) == RMSNorm(x @ M)*g + b, so folding M into
    every producer of the residual stream turns LayerNorm into RMSNorm."""
    return np.eye(d, dtype=np.float32) - np.full((d, d), 1.0 / d, np.float32)


def fold_layernorm_center(w_producer: torch.Tensor) -> torch.Tensor:
    """The centring fold on a residual-stream producer: W <- W @ M, as a
    rank-1 update."""
    return w_producer - w_producer.mean(dim=-1, keepdim=True)
