"""Executable forms of the paper's theoretical analysis (Section 3).

These are used three ways:
  1. property tests (the bounds must hold for arbitrary inputs),
  2. the Figure 3/4/5 harnesses (`repro_torch.paper.fig3_delta`,
     `fig45_bounds`),
  3. MassDiff diagnostics (the Prop-3.2 bound is the optimization target).

Every function reduces over the last axis of a tensor of any leading shape,
on the tensor's device.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "mass_concentration",
    "energy_concentration",
    "block_mass_concentration",
    "prop31_bound",
    "prop32_bound",
    "zeta",
    "cor33_rhs",
    "prop34_bound",
    "suppression_ratio",
    "sufficient_threshold_full",
    "sufficient_threshold_block",
]

_TINY = torch.finfo(torch.float32).tiny


def _blocks(x: torch.Tensor, b: int) -> torch.Tensor:
    d = x.shape[-1]
    if d % b:
        raise ValueError(f"d={d} not divisible by b={b}")
    return x.reshape(*x.shape[:-1], d // b, b)


def _linf(x: torch.Tensor) -> torch.Tensor:
    return x.abs().amax(dim=-1)


def mass_concentration(x: torch.Tensor) -> torch.Tensor:
    """δ = ‖X‖₁ / (d·‖X‖∞) ∈ [1/d, 1] over the last axis."""
    d = x.shape[-1]
    return x.abs().sum(dim=-1) / (d * torch.clamp_min(_linf(x), _TINY))


def energy_concentration(x: torch.Tensor) -> torch.Tensor:
    """δ' = ‖X‖₂ / (√d·‖X‖∞) ∈ [1/√d, 1] (Remark D.1)."""
    d = x.shape[-1]
    return torch.linalg.vector_norm(x, dim=-1) / (
        math.sqrt(d) * torch.clamp_min(_linf(x), _TINY))


def block_mass_concentration(x: torch.Tensor, b: int) -> torch.Tensor:
    """δ_{j} per block: [..., n]."""
    g = _blocks(x, b)
    return g.abs().sum(dim=-1) / (b * torch.clamp_min(_linf(g), _TINY))


def prop31_bound(x: torch.Tensor) -> torch.Tensor:
    """Prop 3.1 RHS: δ·√d·‖X‖∞ = ‖X‖₁/√d."""
    return x.abs().sum(dim=-1) / math.sqrt(x.shape[-1])


def prop32_bound(x: torch.Tensor, b: int) -> torch.Tensor:
    """Prop 3.2 RHS: max_j δ_{j}·√b·‖X_{j}‖∞ = max_j ‖X_{j}‖₁/√b."""
    return _blocks(x, b).abs().sum(dim=-1).amax(dim=-1) / math.sqrt(b)


def zeta(x: torch.Tensor, b: int) -> torch.Tensor:
    """Z(b; X) of Corollary 3.3 (identical to the Prop-3.2 RHS)."""
    return prop32_bound(x, b)


def cor33_rhs(x: torch.Tensor, b_small: int, k: int) -> torch.Tensor:
    """√k · Z(b'; X) - Corollary 3.3 guarantees Z(k·b'; X) ≤ this."""
    return math.sqrt(k) * zeta(x, b_small)


def prop34_bound(x: torch.Tensor, b: int, eps: float,
                 *, tight: bool = True) -> torch.Tensor:
    """Prop 3.4 RHS at confidence 1−ε.

    tight=True uses the per-block energy form from the proof
    (√(2/b·log(2d/ε)·max_j ‖X_{j}‖₂²)); tight=False uses the looser
    main-text form with ‖X‖₂².
    """
    c = 2.0 / b * math.log(2.0 * x.shape[-1] / eps)
    if tight:
        g = _blocks(x, b)
        e = (g * g).sum(dim=-1).amax(dim=-1)
    else:
        e = (x * x).sum(dim=-1)
    return torch.sqrt(c * e)


def suppression_ratio(x: torch.Tensor, xr: torch.Tensor) -> torch.Tensor:
    """‖XR‖∞ / ‖X‖∞ (< 1 ⇔ outliers suppressed)."""
    return _linf(xr) / torch.clamp_min(_linf(x), _TINY)


def sufficient_threshold_full(d: int) -> float:
    """δ < 1/√d guarantees suppression for full-vector rotations."""
    return 1.0 / math.sqrt(d)


def sufficient_threshold_block(b: int) -> float:
    """max_j δ_{j}‖X_{j}‖∞/‖X‖∞ < 1/√b guarantees suppression (block)."""
    return 1.0 / math.sqrt(b)
