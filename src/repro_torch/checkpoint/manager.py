"""Checkpointing: atomic, async snapshots of tensor trees, in the JAX
package's file format.

Layout (one directory per step):
    <dir>/step_000000100.tmp/...   -> atomic rename -> <dir>/step_000000100/
        manifest.json           tree structure + shapes + dtypes
        arrays.npz              leaf arrays, keyed by their paths joined by "::"

Either package reads the other's checkpoints. bfloat16 leaves are stored
as the reference stores them: 2-byte void arrays in the npz, "bfloat16" in
the manifest; the port reads them back by that dtype, bit for bit (the
reference itself cannot cast them into a target, so only its flat
`restore()` reads them).

  * `restore(dir)` returns the latest snapshot as a flat {path: tensor}
    dict on the CPU; with `target` (a like-structured tree of tensors) it
    returns that tree, each leaf in the target leaf's dtype and on its
    device.
  * saves are asynchronous (background thread) with `wait()` barriers, and
    a keep-last-k retention policy; under a process group of several ranks
    rank 0 writes and every rank reads.
  * `restore_sharded(target, shardings)` restores onto a new layout (an
    elastic restart on a mesh of another shape): each leaf placed by its
    `distributed.context.NamedSharding`.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..distributed.context import rank_and_world
from ..tree import flatten_with_paths, leaves, unflatten

Params = Any

_SEP = "::"


def _key(path: tuple) -> str:
    return _SEP.join(str(k) for k in path)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.array(arr, order="C")          # an owned copy, 0-d kept
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _structure(tree) -> str:
    """The tree's shape in the reference's `PyTreeDef` notation."""
    def show(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {show(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, (list, tuple)):
            inner = ", ".join(show(v) for v in node)
            return f"[{inner}]" if isinstance(node, list) else f"({inner})"
        return "*"
    return f"PyTreeDef({show(tree)})"


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def _write(self, step: int, flat: dict[str, np.ndarray],
               dtypes: dict[str, str], structure: str):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "structure": structure,
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)      # atomic publish
        self._gc()

    def _gc(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def save(self, step: int, tree: Params, *, blocking: bool = False):
        """Snapshot `tree`. The device-to-host copy happens now (so the
        caller may change the tensors afterwards); the file write runs in
        the background, and its error is raised by the next `wait()`.
        Under a process group of several ranks, whose replicas hold the
        same state, only rank 0 writes."""
        self.wait()
        if rank_and_world()[0] != 0:
            return
        pairs = flatten_with_paths(tree)
        flat = {_key(p): _to_numpy(t) for p, t in pairs}
        dtypes = {_key(p): _dtype_name(t) for p, t in pairs}
        structure = _structure(tree)

        def work():
            try:
                self._write(step, flat, dtypes, structure)
            except Exception as e:      # surfaced on next wait()
                self._error = e

        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def restore(self, step: int | None = None,
                target: Params | None = None) -> Params:
        """Load a checkpoint: a flat {path: CPU tensor} dict, or with
        `target` the target's tree, each leaf cast to the target leaf's
        dtype and placed on its device."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            dtypes = {k: v["dtype"]
                      for k, v in json.load(f)["leaves"].items()}
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: _to_tensor(z[k], dtypes[k]) for k in z.files}
        if target is None:
            return flat
        out = []
        for path, leaf in flatten_with_paths(target):
            key = _key(path)
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key}")
            t = flat[key]
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
            out.append(t.to(device=leaf.device, dtype=leaf.dtype))
        return unflatten(target, out)

    def restore_sharded(self, target: Params, shardings: Params,
                        step: int | None = None) -> Params:
        """Restore and place with NEW shardings (elastic restart across a
        different mesh shape): on a one-device mesh each leaf moves to the
        device, on a mesh of ranks it becomes a DTensor with the placements
        its spec names."""
        host = self.restore(step, target=target)
        return unflatten(host, [s.place(t) for t, s in
                                zip(leaves(host), leaves(shardings))])
