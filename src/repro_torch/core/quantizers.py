"""Quantizers for the data formats of the paper (Appendix B).

  * INT-q  - Eq. (4): symmetric per-channel weights (MSE-searched scale),
             asymmetric dynamic per-token activations.
  * FP4    - Eq. (5): OCP e2m1 elements, symmetric; per-channel MSE-searched
             weight scale, per-token absmax activation scale.
  * MXFP4  - FP4 elements with a shared power-of-2 scale per group of 32.

All are fake-quant (quantise -> dequantise) functions of tensors, with a
straight-through gradient through the rounding (`ste_round`), so a loss
through them can be differentiated (the Cayley-learned rotations).

Where the reference divides by a constant its compiled form multiplies by
the f32 reciprocal (`quantize_act`, run inside the jitted model); the
weight scale search is the reference's eager form, a true division, as the
pipeline's RTN runs it.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from ..kernels.hadamard_quant import _recip_f32

__all__ = [
    "ste_round",
    "int_quantize",
    "fp4_quantize",
    "mxfp4_quantize",
    "scale_ratios",
    "int_weight_scales_mse",
    "fp4_weight_scales_mse",
    "quantize_weight",
    "quantize_act",
    "QuantSpec",
    "FP4_VALUES",
]

# e2m1 representable magnitudes (OCP MX spec: e=2, m=1, no inf/nan)
FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
FP4_MAX = 6.0
TINY = float(np.finfo(np.float32).tiny)


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest (ties to even) with a straight-through gradient."""
    return _SteRound.apply(x)


# ---------------------------------------------------------------------------
# Element quantizers
# ---------------------------------------------------------------------------

def int_quantize(x: torch.Tensor, scale, zero, bits: int, *,
                 signed: bool = True) -> torch.Tensor:
    """Integer fake-quant per Eq. (4): s*clip(round(x/s) - z, A) + s*z, with
    A = [-2^(q-1)+1, 2^(q-1)-1] (signed) or [0, 2^q - 1]."""
    if signed:
        lo, hi = -(2 ** (bits - 1)) + 1, 2 ** (bits - 1) - 1
    else:
        lo, hi = 0, 2 ** bits - 1
    scale = torch.clamp_min(torch.as_tensor(scale, dtype=x.dtype,
                                            device=x.device), TINY)
    q = torch.clamp(ste_round(x / scale) - zero, lo, hi)
    return scale * (q + zero)


def fp4_quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """FP4 (e2m1) fake-quant per Eq. (5), symmetric: x/s rounds to the
    nearest e2m1 value by exponent/mantissa arithmetic (ties to even on the
    mantissa), clipped to +-6."""
    scale = torch.clamp_min(torch.as_tensor(scale, dtype=x.dtype,
                                            device=x.device), TINY)
    v = x / scale
    a = v.abs()
    # binades [1,2), [2,4), [4,8); below 1 the step is 0.5
    e = torch.clamp(torch.floor(torch.log2(torch.clamp_min(a, 1e-30))),
                    0.0, 2.0)
    step = torch.where(a < 1.0, torch.full_like(a, 0.5),
                       torch.exp2(e - 1.0))
    q = torch.clamp_max(ste_round(a / step) * step, FP4_MAX)
    return scale * torch.sign(v) * q


# ---------------------------------------------------------------------------
# Weight scale search - linear MSE search as in Appendix B
# ---------------------------------------------------------------------------

def scale_ratios(n_grid: int = 80, shrink: float = 0.2,
                 device="cpu") -> torch.Tensor:
    """The search's ratios r in [shrink, 1], the f32 values of the
    reference's `jnp.linspace(shrink, 1.0, n_grid)` as XLA computes it at
    run time: start*(1 - i*c) + i*c with c = f32(1/(n-1)), the last sum
    fused (one rounding)."""
    f32 = np.float32
    c = f32(1) / f32(n_grid - 1)
    i = np.arange(n_grid - 1, dtype=np.float64)
    step = (i * np.float64(c)).astype(f32)
    a = (f32(shrink) * (f32(1) - step)).astype(f32)
    out = (i * np.float64(c) + a.astype(np.float64)).astype(f32)
    out = np.concatenate([out, np.array([1.0], f32)])
    return torch.from_numpy(out).to(device)


def _mse_scale_search(w: torch.Tensor, dim: int, qfun, maxval: float,
                      n_grid: int = 80, shrink: float = 0.2) -> torch.Tensor:
    """Per-channel linear search s = r*absmax/maxval, r in [shrink, 1];
    the first ratio of least squared error wins."""
    absmax = torch.clamp_min(w.abs().amax(dim=dim, keepdim=True), TINY)
    best_err = best_r = None
    for r in scale_ratios(n_grid, shrink, w.device):
        err = qfun(w, r * absmax / maxval) - w
        mse = torch.sum(err * err, dim=dim, keepdim=True)
        if best_err is None:
            best_err, best_r = mse, torch.full_like(mse, float(r))
        else:
            better = mse < best_err
            best_err = torch.where(better, mse, best_err)
            best_r = torch.where(better, r, best_r)
    return best_r * absmax / maxval


def int_weight_scales_mse(w: torch.Tensor, bits: int, *, axis: int = 0,
                          n_grid: int = 80) -> torch.Tensor:
    """Symmetric per-channel INT scale by MSE linear search (z = 0)."""
    maxval = 2 ** (bits - 1) - 1
    return _mse_scale_search(
        w, axis, lambda x, s: int_quantize(x, s, 0.0, bits, signed=True),
        maxval, n_grid=n_grid)


def fp4_weight_scales_mse(w: torch.Tensor, *, axis: int = 0,
                          n_grid: int = 80) -> torch.Tensor:
    """Symmetric per-channel FP4 scale by MSE linear search."""
    return _mse_scale_search(w, axis, fp4_quantize, FP4_MAX, n_grid=n_grid)


# ---------------------------------------------------------------------------
# MX grouping
# ---------------------------------------------------------------------------

def _mx_shared_scale(x: torch.Tensor, group: int, maxval_log2: float):
    """Shared power-of-2 scale per `group` of the last axis (E8M0 style)."""
    g = x.reshape(*x.shape[:-1], x.shape[-1] // group, group)
    absmax = torch.clamp_min(g.abs().amax(dim=-1, keepdim=True), TINY)
    e = torch.floor(torch.log2(absmax)) - maxval_log2
    return torch.exp2(e), g


def mxfp4_quantize(x: torch.Tensor, *, group: int = 32) -> torch.Tensor:
    """MXFP4 fake-quant: e2m1 elements + a shared pow-2 scale per 32."""
    if x.shape[-1] % group:
        raise ValueError(f"last dim {x.shape[-1]} not divisible by group "
                         f"{group}")
    s, g = _mx_shared_scale(x, group, maxval_log2=2.0)
    return fp4_quantize(g, s).reshape(x.shape)


# ---------------------------------------------------------------------------
# Unified spec + entry points
# ---------------------------------------------------------------------------

Format = Literal["int4", "int8", "fp4", "mxfp4", "none"]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """What to quantise and how - one per tensor class (weights / acts)."""
    fmt: Format = "int4"
    bits: int = 4
    mx_group: int = 32
    scale_grid: int = 80

    @property
    def enabled(self) -> bool:
        return self.fmt != "none"


def quantize_weight(w: torch.Tensor, spec: QuantSpec, *, axis: int = 0,
                    precomputed_scale: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Fake-quantise a weight matrix per the spec (scales per output
    channel when `axis` is the input dim)."""
    if not spec.enabled:
        return w
    if spec.fmt in ("int4", "int8"):
        bits = 4 if spec.fmt == "int4" else 8
        s = precomputed_scale if precomputed_scale is not None else \
            int_weight_scales_mse(w, bits, axis=axis, n_grid=spec.scale_grid)
        return int_quantize(w, s, 0.0, bits, signed=True)
    if spec.fmt == "fp4":
        s = precomputed_scale if precomputed_scale is not None else \
            fp4_weight_scales_mse(w, axis=axis, n_grid=spec.scale_grid)
        return fp4_quantize(w, s)
    if spec.fmt == "mxfp4":
        # MX scales are pow-2 per group of the input-dim axis
        w0 = w.transpose(axis, 0) if axis != 0 else w
        q = mxfp4_quantize(w0.transpose(0, -1),
                           group=spec.mx_group).transpose(0, -1)
        return q.transpose(axis, 0) if axis != 0 else q
    raise ValueError(spec.fmt)


def quantize_act(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Dynamic activation fake-quant over the last (feature) axis:
    int4/int8 asymmetric per token, fp4 symmetric per-token absmax,
    mxfp4 a shared pow-2 scale per group of 32."""
    if not spec.enabled:
        return x
    xf = x.to(torch.float32)
    if spec.fmt in ("int4", "int8"):
        bits = 4 if spec.fmt == "int4" else 8
        mn = xf.amin(dim=-1, keepdim=True)
        mx = xf.amax(dim=-1, keepdim=True)
        s = torch.clamp_min((mx - mn) * _recip_f32(2 ** bits - 1), TINY)
        z = torch.round(mn / s)
        q = torch.clamp(ste_round(xf / s) - z, 0, 2 ** bits - 1)
        out = s * (q + z)
    elif spec.fmt == "fp4":
        s = xf.abs().amax(dim=-1, keepdim=True) * _recip_f32(2 ** 3 - 1)
        out = fp4_quantize(xf, s)
    elif spec.fmt == "mxfp4":
        out = mxfp4_quantize(xf, group=spec.mx_group)
    else:
        raise ValueError(spec.fmt)
    return out.to(x.dtype)
