"""Meta-tensor stand-ins for every model input: the dry-run contract.

`input_specs(model, plan)` returns meta tensors (shape and dtype, no
storage) of the inputs of the step that the cell counts (train step,
prefill, decode step), as the reference's `jax.ShapeDtypeStruct`s. The
micro-batch factors are the reference's, chosen there so that the
per-device memory fits 16 GiB of TPU HBM; the dry run's records show what
they leave of an H100's 80 GB rather than plan again.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models.config import ArchConfig, ShapeCell
from ..models.transformer import FRONTEND_DIMS, Model

Abstract = Any


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, batch: int, seq: int, *,
                with_labels: bool) -> dict:
    out: dict[str, Abstract] = {}
    if cfg.frontend == "audio_frames":
        out["frames"] = sds((batch, seq, FRONTEND_DIMS["audio_frames"]),
                            torch.bfloat16)
        if with_labels:
            out["labels"] = sds((batch, seq), torch.int32)
        return out
    if cfg.frontend == "vision_patches":
        npatch = cfg.frontend_tokens
        out["patches"] = sds((batch, npatch, FRONTEND_DIMS["vision_patches"]),
                             torch.bfloat16)
        out["tokens"] = sds((batch, seq - npatch), torch.int32)
        if with_labels:
            out["labels"] = sds((batch, seq - npatch), torch.int32)
        return out
    out["tokens"] = sds((batch, seq), torch.int32)
    if with_labels:
        out["labels"] = sds((batch, seq), torch.int32)
    return out


def params_specs(model: Model) -> Abstract:
    return model.init_shapes()


def cache_specs(model: Model, batch: int, max_len: int,
                dtype=torch.bfloat16) -> Abstract:
    return model.init_cache(batch, max_len, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class CellPlan:
    """Everything the dry run needs to count one (arch x shape) cell."""
    arch: str
    cell: ShapeCell
    kind: str                    # train | prefill | decode
    num_microbatches: int = 1    # train only

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.cell.name}"


# Per-arch micro-batch factors for train_4k (global batch 256), the
# reference's: chosen so that the per-device live activations fit 16 GiB
# of TPU HBM with the params and optimizer state; larger models take more.
TRAIN_MICROBATCHES = {
    "deepseek-coder-33b": 16,
    # 8 (not 16): ZeRO-3 weight gathers scale with the micro-batch count
    "llama4-maverick-400b-a17b": 8,
    "phi3-mini-3.8b": 8,
    "deepseek-moe-16b": 8,
    "hubert-xlarge": 8,
    "zamba2-1.2b": 8,
    "mamba2-1.3b": 8,
}
DEFAULT_TRAIN_MICROBATCHES = 4


def plan_for(cfg: ArchConfig, cell: ShapeCell) -> CellPlan:
    n_micro = TRAIN_MICROBATCHES.get(cfg.name, DEFAULT_TRAIN_MICROBATCHES) \
        if cell.kind == "train" else 1
    return CellPlan(arch=cfg.name, cell=cell, kind=cell.kind,
                    num_microbatches=n_micro)


def input_specs(model: Model, plan: CellPlan) -> dict:
    """Meta inputs of the step this cell counts, leaf for leaf the
    reference's. A decode step's `index` is a scalar, as the reference's
    traced one; the dry run hands the port's decode step its [B] per-row
    form (every row at that fill position)."""
    cfg = model.cfg
    cell = plan.cell
    if plan.kind == "train":
        return {"batch": batch_specs(cfg, cell.global_batch, cell.seq_len,
                                     with_labels=True)}
    if plan.kind == "prefill":
        if cfg.family == "encoder":
            # encoder "prefill" = full forward, no cache
            return {"batch": batch_specs(cfg, cell.global_batch,
                                         cell.seq_len, with_labels=False)}
        return {
            "batch": batch_specs(cfg, cell.global_batch, cell.seq_len,
                                 with_labels=False),
            "cache": cache_specs(model, cell.global_batch, cell.seq_len),
        }
    if plan.kind == "decode":
        return {
            "tokens": sds((cell.global_batch, 1), torch.int32),
            "cache": cache_specs(model, cell.global_batch, cell.seq_len),
            "index": sds((), torch.int32),
        }
    raise ValueError(plan.kind)
