"""Training step factory: micro-batched gradient accumulation, remat,
optional int8 error-feedback gradient compression on the cross-pod reduce.

`train_step(params, opt_state, batch, ef_state=None)` takes trees of
tensors (the batch's leaves on the parameters' device) and returns new
trees; its inputs are left as they were. With `num_microbatches > 1` the
batch is split along its first axis and the micro-batches run in a loop
that accumulates f32 gradients (the reference's `lax.scan`): the loss is
their mean and the other metrics are the last micro-batch's. With
`compress_grads` and an `ef_state` (`distributed.compression.
init_ef_state`), the gradients pass through `ef_compress_grads` before
AdamW and the step returns `(params, opt_state, new_ef, metrics)`; else
`(params, opt_state, metrics)`. Inside a mesh (`distributed.context.
mesh_context`) whose data axes ("pod", "data") span several ranks, each
rank holds the whole parameters and its own share of the batch; the
gradients and the loss are averaged over those axes by all-reduces before
compression, as GSPMD's reduction gives the reference's step its global
gradients. Every metric is a tensor on the device, so a step reads
nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..distributed.compression import ef_compress_grads
from ..distributed.context import current_mesh
from ..optim import adamw
from ..tree import leaves, tree_map, unflatten

Params = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_microbatches: int = 1
    remat: bool = True
    compress_grads: bool = False   # int8 error-feedback on the DP reduce
    compress_axis: str = "pod"


def _data_parallel_mean(grads: Params, loss: torch.Tensor):
    """Average the gradients and the loss over the current mesh's data
    axes, in place (a no-op outside a mesh or on one data rank)."""
    mesh = current_mesh()
    if mesh is None:
        return
    axes = [a for a in ("pod", "data") if mesh.shape.get(a, 1) > 1]
    n = 1
    for a in axes:
        group = mesh.group(a)
        for t in leaves(grads) + [loss]:
            dist.all_reduce(t, group=group)
        n *= mesh.shape[a]
    if n > 1:
        for t in leaves(grads) + [loss]:
            t.div_(n)


def grads_of(model, params: Params, batch: Params, *, remat: bool):
    """One (micro-)batch's loss, metrics and gradients (a tree like
    `params`; zeros where a leaf does not reach the loss)."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    (loss, metrics) = model.loss_fn(unflatten(params, flat), batch,
                                    remat=remat)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(params, grads)


def make_train_step(model, opt_cfg: adamw.AdamWConfig,
                    train_cfg: TrainConfig) -> Callable:
    n_micro = train_cfg.num_microbatches
    remat = train_cfg.remat

    def train_step(params: Params, opt_state: dict, batch: Params,
                   ef_state: Params | None = None):
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
                loss, metrics, grads = grads_of(model, params, mb,
                                                remat=remat)
                for a, g in zip(leaves(acc), leaves(grads)):
                    a.add_(g)       # promoted to f32 exactly, in the add
                loss_sum = loss_sum + loss
                del grads
            for a in leaves(acc):
                a.div_(n_micro)
            grads = acc
            loss = loss_sum / n_micro
        else:
            loss, metrics, grads = grads_of(model, params, batch,
                                                remat=remat)
        _data_parallel_mean(grads, loss)

        compress = train_cfg.compress_grads and ef_state is not None
        new_ef = ef_state
        if compress:
            grads, new_ef = ef_compress_grads(grads, ef_state,
                                              axis=train_cfg.compress_axis)

        params, opt_state, om = adamw.apply_updates(opt_cfg, params, grads,
                                                    opt_state)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        if compress:
            return params, opt_state, new_ef, metrics
        return params, opt_state, metrics

    return train_step


def make_eval_step(model) -> Callable:
    def eval_step(params: Params, batch: Params):
        with torch.no_grad():
            _, metrics = model.loss_fn(params, batch, remat=False)
        return metrics

    return eval_step
