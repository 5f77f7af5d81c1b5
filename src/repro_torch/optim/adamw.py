"""AdamW with decoupled weight decay, global-norm clipping, and LR schedules.

The update is computed in f32 and cast back to each parameter's dtype, in
the JAX package's order of operations. Moments are f32, or bf16 with
`moment_dtype="bfloat16"` (halves the optimizer's memory), each laid out
as its parameter: a DTensor parameter's moments are DTensors of its
placements, and the update runs on each rank's shards. The step count,
the learning rate and the clip scale stay tensors on the parameters'
device, so a step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..tree import leaves, tree_map, unflatten

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # "bfloat16" halves optimizer memory
    schedule: str = "cosine"        # "cosine" | "linear" | "constant"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (a tensor), as an f32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 \
            * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    else:
        decay = torch.ones_like(step)
    return cfg.lr * warm * decay


def init_state(cfg: AdamWConfig, params: Params) -> dict:
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    dev = leaves(params)[0].device

    def zeros(p):       # laid out as `p` (a DTensor's moments are too)
        return torch.zeros_like(p, dtype=mdt)

    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in leaves(tree)))


def apply_updates(cfg: AdamWConfig, params: Params, grads: Params,
                  state: dict) -> tuple[Params, dict, dict]:
    """One AdamW step. Returns (params, new_state, metrics); the inputs are
    left as they were."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                            1.0) \
        if cfg.grad_clip > 0 else torch.ones_like(gnorm)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2 and cfg.weight_decay > 0:  # no decay on norms/bias
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        newp = p.to(torch.float32) - lr * delta
        return (newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype))

    out = [upd(*xs) for xs in zip(*(leaves(t) for t in (
        params, grads, state["m"], state["v"])))]
    new_params, new_m, new_v = (unflatten(params, [o[i] for o in out])
                                for i in range(3))
    return new_params, {"step": step, "m": new_m, "v": new_v}, \
        {"grad_norm": gnorm, "lr": lr}
