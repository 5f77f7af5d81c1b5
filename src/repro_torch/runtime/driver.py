"""Fault-tolerant training driver: retries, checkpoint/restart, straggler
detection, elastic rescale.

  * **Failures** — every step runs under a retry guard; transient device
    errors re-execute the step, persistent ones trigger restore-from-last-
    checkpoint (a step is only "committed" once its effects are reproducible
    from the checkpoint lineage). The restore rewinds the step count but
    not the batch iterator, as the JAX package's driver does, so a restored
    run trains on the batches that come next (ROADMAP Queue C, R9).
  * **Stragglers** — per-step wall times feed an EWMA; steps slower than
    `straggler_factor ×` the EWMA are recorded and, past a threshold rate,
    the driver requests a rescale (in a real deployment this feeds the
    cluster scheduler; here it flips the mesh to the next smaller data
    extent).
  * **Elastic rescale** — `ElasticMesh.make()` recomputes a mesh from the
    surviving rank count; parameters are restored with the new shardings
    via `CheckpointManager.restore_sharded`.

Under a process group every rank takes the same branch:
after each attempt of a step one all-reduce (MAX) of a failure flag over
the world says whether any rank failed, and then every rank retries (its
own result, if it had one, is dropped), or after the last retry every
rank restores from the same checkpoint; the counts are the same on every
rank. A failure that leaves the step's collectives unmatched (a rank that
dies inside one) hangs the others there: that needs the communicator
aborted, which this driver does not do.

A step is committed once its loss is ready on the device: on a card the
driver waits for the loss's stream, so a step's wall time includes its
device time, and an error the device raises asynchronously surfaces inside
the retry guard. The guard catches any `Exception`, as the reference's
does. A sticky CUDA error (an illegal address, a device-side assert)
poisons the process's CUDA context, though: every later call fails too, so
no retry or restore within the process can clear it, and the run ends with
that error after its retries.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..distributed.context import Mesh, in_group, rank_and_world
from ..tree import leaves

Params = Any


@dataclasses.dataclass
class RuntimeConfig:
    checkpoint_every: int = 50
    max_retries: int = 2
    straggler_factor: float = 2.5
    straggler_window: int = 20
    ewma_alpha: float = 0.1


@dataclasses.dataclass
class StepStats:
    ewma: float = 0.0
    count: int = 0
    stragglers: list[int] = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float, factor: float, alpha: float) -> bool:
        is_straggler = self.count > 5 and dt > factor * self.ewma
        self.ewma = dt if self.count == 0 else \
            (1 - alpha) * self.ewma + alpha * dt
        self.count += 1
        if is_straggler:
            self.stragglers.append(step)
        return is_straggler


class ElasticMesh:
    """Mesh sizing policy: given n ranks, the largest (data, model) grid
    with the model extent fixed (TP degree is architecture-bound; DP is the
    elastic dimension)."""

    def __init__(self, model_parallel: int):
        self.model_parallel = model_parallel

    def shape_for(self, n_devices: int) -> tuple[int, int]:
        data = max(1, n_devices // self.model_parallel)
        # largest power-of-2 data extent (keeps batch divisible on rescale)
        p = 1
        while p * 2 <= data:
            p *= 2
        return (p, self.model_parallel)

    def make(self, devices=None, device_type: str = "cuda") -> Mesh:
        """A ("data", "model") mesh over `devices` (ranks; by default every
        rank of the initialised process group, else this process alone)."""
        if devices is None:
            devices = list(range(rank_and_world()[1]))
        shape = self.shape_for(len(devices))
        n = shape[0] * shape[1]
        dev = np.asarray(devices[:n]).reshape(shape)
        return Mesh(dev, ("data", "model"), device_type)


def _any_rank(failed: bool, like) -> bool:
    """Whether this rank or any other failed (an all-reduce MAX over the
    world, on `like`'s device); `failed` itself outside a process group."""
    if not in_group():
        return failed
    if not torch.is_tensor(like):
        like = leaves(like)[0]
    flag = torch.tensor([int(failed)], dtype=torch.int32, device=like.device)
    torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
    return bool(flag.item())


def _wait_ready(t) -> None:
    """Block until the device has produced `t` (a tensor, or a tree whose
    first leaf stands for it): a sync of its CUDA stream, nothing on the
    CPU."""
    if not torch.is_tensor(t):
        t = leaves(t)[0]
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


class TrainDriver:
    def __init__(self, train_step: Callable, ckpt: CheckpointManager,
                 cfg: RuntimeConfig):
        self.train_step = train_step
        self.ckpt = ckpt
        self.cfg = cfg
        self.stats = StepStats()
        self.failures = 0
        self.restores = 0

    def run(self, params: Params, opt_state: Params,
            batches: Iterator, *, start_step: int = 0, num_steps: int = 100,
            on_metrics: Callable | None = None):
        step = start_step
        state = (params, opt_state)
        committed = start_step
        while step < start_step + num_steps:
            batch = next(batches)
            t0 = time.perf_counter()
            try:
                state = self._guarded_step(state, batch)
            except Exception:
                # persistent failure: restore last committed checkpoint
                self.restores += 1
                target = {"params": state[0], "opt": state[1]}
                restored = self.ckpt.restore(target=target)
                state = (restored["params"], restored["opt"])
                step = committed
                continue
            dt = time.perf_counter() - t0
            self.stats.record(step, dt, self.cfg.straggler_factor,
                              self.cfg.ewma_alpha)
            step += 1
            if step % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step, {"params": state[0], "opt": state[1]})
                committed = step
            if on_metrics:
                on_metrics(step, state)
        self.ckpt.save(step, {"params": state[0], "opt": state[1]},
                       blocking=True)
        return state, step

    def _guarded_step(self, state, batch):
        last = None
        for _ in range(self.cfg.max_retries + 1):
            out, err = None, None
            try:
                params, opt_state, metrics = self.train_step(
                    state[0], state[1], batch)
                # commit: block until the step really finished
                _wait_ready(metrics.get("loss", params))
                out = (params, opt_state)
            except Exception as e:  # noqa: BLE001 — retry any device error
                err = e
            if not _any_rank(err is not None, state[0]):
                return out
            self.failures += 1
            last = err or RuntimeError("the step failed on another rank")
        raise last

    @property
    def straggler_rate(self) -> float:
        if not self.stats.count:
            return 0.0
        return len(self.stats.stragglers) / self.stats.count

    def should_rescale(self) -> bool:
        recent = [s for s in self.stats.stragglers
                  if s >= self.stats.count - self.cfg.straggler_window]
        return len(recent) > self.cfg.straggler_window // 4
