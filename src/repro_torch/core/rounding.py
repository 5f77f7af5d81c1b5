"""Stage-2 rounding algorithms: RTN, GPTQ (OPTQ), Qronos.

Layers compute ``y = x @ W`` with ``W: [d_in, d_out]``; the Hessian is
``H = X^T X : [d_in, d_in]`` over calibration tokens. GPTQ/Qronos quantise
the d_in rows of W one by one and diffuse each row's rounding error into
the rows not yet quantised through the upper Cholesky factor of H^-1 (the
exact OPTQ recursion). Per Appendix B:

  * GPTQ is damped with lambda = damp_frac * mean(diag H) (1 %),
  * Qronos with lambda = 1e-3 * sigma_1(H) (largest singular value),
  * rows go in descending order of diag(H) ("act order"),
  * weight scales come from the full-precision W before the loop.

Qronos first re-fits the weights against the quantised inputs,
W <- (X~^T X~ + lambda I)^-1 X~^T X W, then runs the GPTQ recursion with
H = X~^T X~.

Linear algebra, all in f32 on the tensors' device: H^-1 by
`torch.linalg.inv`, symmetrised, then `torch.linalg.cholesky` (the
reference's `jnp.linalg.inv` + `cholesky`); Qronos' positive-definite solve
by `torch.linalg.cholesky` + `torch.cholesky_solve` (the reference's
`jax.scipy.linalg.solve(assume_a="pos")`). The column loop updates only the
rows after the current one (the reference masks a rank-1 update of all of
W: the same values) and reads nothing back to the host.
"""
from __future__ import annotations

import torch

from .quantizers import (TINY, QuantSpec, fp4_quantize, fp4_weight_scales_mse,
                         int_quantize, int_weight_scales_mse)

__all__ = [
    "hessian_from_activations",
    "cross_from_activations",
    "row_scales",
    "rtn",
    "gptq",
    "qronos",
]


def hessian_from_activations(x: torch.Tensor) -> torch.Tensor:
    """H = X^T X in f32; x is [tokens, d_in] (or any [..., d_in])."""
    x = x.reshape(-1, x.shape[-1]).to(torch.float32)
    return x.T @ x


def cross_from_activations(x_q: torch.Tensor,
                           x_fp: torch.Tensor) -> torch.Tensor:
    """C = X~^T X in f32 for the Qronos re-fit."""
    x_q = x_q.reshape(-1, x_q.shape[-1]).to(torch.float32)
    x_fp = x_fp.reshape(-1, x_fp.shape[-1]).to(torch.float32)
    return x_q.T @ x_fp


def row_scales(w: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Scale of each row of W (broadcastable to W): INT/FP4 per output
    channel [1, d_out]; MXFP4 per (32-row group, output channel)
    [d_in, d_out], power-of-2 scales fixed from the original W."""
    if spec.fmt in ("int4", "int8"):
        bits = 4 if spec.fmt == "int4" else 8
        return int_weight_scales_mse(w, bits, axis=0, n_grid=spec.scale_grid)
    if spec.fmt == "fp4":
        return fp4_weight_scales_mse(w, axis=0, n_grid=spec.scale_grid)
    if spec.fmt == "mxfp4":
        d_in, d_out = w.shape
        g = spec.mx_group
        if d_in % g:
            raise ValueError(f"d_in={d_in} not divisible by MX group {g}")
        wg = w.reshape(d_in // g, g, d_out)
        absmax = torch.clamp_min(wg.abs().amax(dim=1, keepdim=True), TINY)
        e = torch.floor(torch.log2(absmax)) - 2.0    # fp4 emax = 2
        return torch.exp2(e).expand(wg.shape).reshape(d_in, d_out)
    raise ValueError(spec.fmt)


def _quantize_rows(w: torch.Tensor, s: torch.Tensor,
                   spec: QuantSpec) -> torch.Tensor:
    if spec.fmt in ("int4", "int8"):
        bits = 4 if spec.fmt == "int4" else 8
        return int_quantize(w, s, 0.0, bits, signed=True)
    if spec.fmt in ("fp4", "mxfp4"):
        return fp4_quantize(w, s)
    raise ValueError(spec.fmt)


def _row_quantizer(spec: QuantSpec):
    """`_quantize_rows` for scales already clamped, in the fewest kernels
    (the GPTQ loop runs it once per input channel): s*clip(round(w/s)) for
    the INT formats (the value of `int_quantize` with z = 0)."""
    if spec.fmt in ("int4", "int8"):
        hi = 2 ** ((4 if spec.fmt == "int4" else 8) - 1) - 1
        return lambda w, s: s * torch.clamp(torch.round(w / s), -hi, hi)
    return lambda w, s: _quantize_rows(w, s, spec)


def rtn(w: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Round to nearest with the Appendix-B scale policy."""
    if not spec.enabled:
        return w
    wf = w.to(torch.float32)
    return _quantize_rows(wf, row_scales(wf, spec), spec).to(w.dtype)


def _upper_cholesky_inv(h: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor U of H^-1 (H^-1 = U^T U)."""
    hinv = torch.linalg.inv(h)
    hinv = 0.5 * (hinv + hinv.T)
    return torch.linalg.cholesky(hinv).T


def _sigma_max(h: torch.Tensor, iters: int = 32) -> torch.Tensor:
    """Largest singular value of a symmetric PSD h by power iteration."""
    n = h.shape[0]
    v = torch.ones((n,), dtype=torch.float32, device=h.device) \
        / torch.sqrt(torch.tensor(float(n), device=h.device))
    for _ in range(iters):
        v = h @ v
        v = v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-30)
    return torch.linalg.vector_norm(h @ v)


@torch.no_grad()
def gptq(w: torch.Tensor, h: torch.Tensor, spec: QuantSpec, *,
         damp_frac: float = 0.01, act_order: bool = True,
         damp_sigma: float | None = None) -> torch.Tensor:
    """GPTQ/OPTQ error-correcting rounding of w [d_in, d_out] with
    h = X^T X [d_in, d_in]. `damp_sigma` sets the damping to
    damp_sigma * sigma_1(H) (Qronos)."""
    if not spec.enabled:
        return w
    w = w.to(torch.float32).clone()
    h = h.to(torch.float32)
    d = w.shape[0]
    eye = torch.eye(d, dtype=torch.float32, device=h.device)
    # dead input channels (H_ii == 0) are pinned to 1: their weights do not
    # matter
    h = h + torch.diag((torch.diagonal(h) <= 0.0).to(torch.float32))
    if damp_sigma is not None:
        lam = damp_sigma * _sigma_max(h)
    else:
        lam = damp_frac * torch.diagonal(h).mean()
    h = h + lam * eye
    order = None
    if act_order:
        order = torch.argsort(-torch.diagonal(h), stable=True)
        w = w[order]
        h = h[order][:, order]
    scales = torch.clamp_min(row_scales(w, spec), TINY).expand(w.shape)
    quantize = _row_quantizer(spec)
    u = _upper_cholesky_inv(h)
    for i in range(d):
        qi = quantize(w[i], scales[i])
        err = (w[i] - qi) / u[i, i]
        w[i + 1:].addr_(u[i, i + 1:], err, alpha=-1.0)
        w[i] = qi
    if order is not None:
        w = w[torch.argsort(order)]
    return w


@torch.no_grad()
def qronos(w: torch.Tensor, h_q: torch.Tensor, spec: QuantSpec, *,
           c_qx: torch.Tensor | None = None, alpha: float = 1e-3,
           act_order: bool = True) -> torch.Tensor:
    """Qronos: the past-correcting re-fit, then the GPTQ recursion.
    h_q = X~^T X~, c_qx = X~^T X; without c_qx the re-fit is skipped and
    this is GPTQ with Qronos' sigma_1 damping."""
    if not spec.enabled:
        return w
    w = w.to(torch.float32)
    h_q = h_q.to(torch.float32)
    if c_qx is not None:
        lam = alpha * _sigma_max(h_q)
        a = h_q + lam * torch.eye(h_q.shape[0], dtype=torch.float32,
                                  device=h_q.device)
        w = torch.cholesky_solve(c_qx.to(torch.float32) @ w,
                                 torch.linalg.cholesky(a))
    return gptq(w, h_q, spec, act_order=act_order, damp_sigma=alpha)
