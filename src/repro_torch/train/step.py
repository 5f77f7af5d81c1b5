"""Training step factory: micro-batched gradient accumulation and remat on
one device.

`train_step(params, opt_state, batch)` takes trees of tensors (the batch's
leaves on the parameters' device) and returns new trees; its inputs are
left as they were. With `num_microbatches > 1` the batch is split along
its first axis and the micro-batches run in a loop that accumulates f32
gradients (the reference's `lax.scan`): the loss is their mean and the
other metrics are the last micro-batch's. Every metric is a tensor on the
device, so a step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..optim import adamw
from ..tree import leaves, tree_map, unflatten

Params = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_microbatches: int = 1
    remat: bool = True
    compress_grads: bool = False   # int8 error-feedback on the DP reduce
    compress_axis: str = "pod"


def make_train_step(model, opt_cfg: adamw.AdamWConfig,
                    train_cfg: TrainConfig) -> Callable:
    if train_cfg.compress_grads:
        raise NotImplementedError(
            "compress_grads (int8 error-feedback on the cross-pod reduce) "
            "needs the distributed seam of ROADMAP Queue A11b")
    n_micro = train_cfg.num_microbatches

    def grads_of(params, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        (loss, metrics) = model.loss_fn(unflatten(params, flat), batch,
                                        remat=train_cfg.remat)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten(params, grads)

    def train_step(params: Params, opt_state: dict, batch: Params):
        if n_micro > 1:
            b = leaves(batch)[0].shape[0]
            if b % n_micro:
                raise ValueError(f"batch {b} does not split into {n_micro} "
                                 "micro-batches")
            micro = [tree_map(lambda x, i=i: x.reshape(
                n_micro, b // n_micro, *x.shape[1:])[i], batch)
                for i in range(n_micro)]
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=leaves(params)[0].device)
            for mb in micro:
                loss, metrics, grads = grads_of(params, mb)
                for a, g in zip(leaves(acc), leaves(grads)):
                    a.add_(g)       # promoted to f32 exactly, in the add
                loss_sum = loss_sum + loss
                del grads
            for a in leaves(acc):
                a.div_(n_micro)
            grads = acc
            loss = loss_sum / n_micro
        else:
            loss, metrics, grads = grads_of(params, batch)
        params, opt_state, om = adamw.apply_updates(opt_cfg, params, grads,
                                                    opt_state)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(model) -> Callable:
    def eval_step(params: Params, batch: Params):
        with torch.no_grad():
            _, metrics = model.loss_fn(params, batch, remat=False)
        return metrics

    return eval_step
