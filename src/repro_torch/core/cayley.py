"""Learned rotations through the Cayley transform (SpinQuant-style, PeRQ+).

R(A) = (I - A)(I + A)^-1 R0 with A skew-symmetric and R0 a Hadamard
start; Adam on the free entries of A keeps R orthogonal at every step.
Gradients flow through the quantisers by the straight-through estimator
(`quantizers.ste_round`); autograd takes the place of the reference's
`jax.value_and_grad`, and Adam is the reference's, step for step.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["cayley", "skew", "learn_rotation"]


def skew(a_free: torch.Tensor, d: int) -> torch.Tensor:
    """A skew-symmetric matrix from d(d-1)/2 free parameters."""
    iu = torch.triu_indices(d, d, offset=1, device=a_free.device)
    a = torch.zeros((d, d), dtype=a_free.dtype, device=a_free.device)
    a = a.index_put((iu[0], iu[1]), a_free)
    return a - a.T


def cayley(a: torch.Tensor) -> torch.Tensor:
    """Cayley transform (I - A)(I + A)^-1, orthogonal for skew A."""
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return torch.linalg.solve(eye + a, (eye - a).T).T


def learn_rotation(loss_fn: Callable[[torch.Tensor], torch.Tensor], d: int,
                   *, r0: torch.Tensor | None = None, steps: int = 100,
                   lr: float = 1e-2, beta1: float = 0.9, beta2: float = 0.999,
                   eps: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimise loss_fn(R) over orthogonal R = cayley(skew(a)) R0 with Adam.
    Returns (R, the loss of every step [steps])."""
    dev = r0.device if r0 is not None else "cpu"
    if r0 is None:
        r0 = torch.eye(d, dtype=torch.float32)
    a = torch.zeros((d * (d - 1) // 2,), dtype=torch.float32, device=dev)
    m = torch.zeros_like(a)
    v = torch.zeros_like(a)
    hist = []
    for t in range(1, steps + 1):
        a_req = a.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(cayley(skew(a_req, d)) @ r0)
            (g,) = torch.autograd.grad(loss, a_req)
        hist.append(loss.detach())
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g * g
        mhat = m / (1 - beta1 ** t)
        vhat = v / (1 - beta2 ** t)
        a = a - lr * mhat / (torch.sqrt(vhat) + eps)
    with torch.no_grad():
        r = cayley(skew(a, d)) @ r0
    return r, torch.stack(hist) if hist else torch.zeros((0,), device=dev)
