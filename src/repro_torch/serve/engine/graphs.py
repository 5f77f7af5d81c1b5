"""Captured CUDA graphs: the port's counterpart of the reference's fused
dispatch.

The reference compiles each engine phase into one jitted device call
(`ServeEngine._fused`), so a decode step costs the host one dispatch
whatever the model's depth. PyTorch runs eagerly: a decode step of the
16-layer model issues about two thousand kernels from Python and leaves
the card idle most of the step. A `torch.cuda.CUDAGraph` of the step
replays all of them for the price of one launch.

`CapturedCall` is one variant of such a dispatch. It holds

- static input buffers, which the caller fills (`copy_`) on every call -
  a graph reads the addresses it was captured with; `load` fills them and
  `run` dispatches, so a caller can time the two apart (`__call__` does
  both);
- the captured graph and its static outputs, the same tensors on every
  replay (read them before the next call);
- the kernel-launch and dispatch-tally deltas of one call: the wrappers of
  `kernels.ops` count in Python, so they count at capture and never at
  replay; the capture's counts are taken back and each replay adds them
  (`kops.add_counts`).

On a CUDA device the first call runs the function eagerly on the static
buffers, and that run is the call's result. It settles everything that
allocates lazily before the capture: `int4_matmul`'s split workspace and
attention's merge counters (`kernels._scratch`: grown only outside a
capture, and a grown array is retired, never freed, so a graph keeps its
own), the RoPE frequencies and rotation operands cached per device, the
kernel library itself. Then the function is captured into the pool the
caller shares between its variants (replays run one at a time on one
stream, so the variants' intermediates may share memory; their inputs and
outputs stay referenced here), with Python's cycle collector run just
before and held off during it: a dead engine's graph freed inside a
capture would invalidate it. Every later call replays. A capture or a
replay that fails raises; there is no eager fallback on the card. Each call
runs the function's device work once - the first eagerly, the rest by
replay - so in-place writes (the KV pages) happen once per call and the
tallies read what an eager run of the same calls reads.

Where the function must not be captured - CPU tensors (the tests) or a
`use_kernels(False)` scope, whose plain versions read the device on the
host - the same object calls the function directly on the same buffers.
"""
from __future__ import annotations

import gc
import time
from typing import Callable

import torch

from ...kernels import ops as kops


class CapturedCall:
    """One captured variant of `fn(**inputs)`; see the module docstring.

    `example` names the inputs and gives their shapes and dtypes (its
    values are not kept); the static buffers live on `device`. `pool` is
    the graph memory pool (`torch.cuda.graph_pool_handle()`) to capture
    into, or None to call `fn` directly every time."""

    def __init__(self, fn: Callable, example: dict[str, torch.Tensor],
                 device: torch.device, *, pool=None):
        self.fn = fn
        self.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                       for k, v in example.items()}
        self.pool = pool
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs = None
        self.counts: tuple[dict, dict] | None = None
        self.capture_s: float | None = None

    def __call__(self, **values: torch.Tensor):
        self.load(**values)
        return self.run()

    def load(self, **values: torch.Tensor):
        """Copy `values` into the static input buffers, without waiting: a
        caller that rewrites a (pinned) host value must first wait for the
        copies queued here, as a later transfer on the stream does."""
        if values.keys() != self.inputs.keys():
            raise ValueError(f"inputs {sorted(values)}, captured with "
                             f"{sorted(self.inputs)}")
        for name, buf in self.inputs.items():
            # copy_ would broadcast a narrower value silently
            if values[name].shape != buf.shape:
                raise ValueError(f"input {name!r} has shape "
                                 f"{tuple(values[name].shape)}, its buffer "
                                 f"{tuple(buf.shape)}")
            buf.copy_(values[name], non_blocking=True)

    def run(self):
        """Run the call on the loaded buffers: the first time eagerly, then
        capture; later, replay."""
        if self.pool is None:
            return self.fn(**self.inputs)
        if self.graph is None:
            out = self.fn(**self.inputs)
            self._capture()
            return out
        self.graph.replay()
        kops.add_counts(self.counts)
        return self.outputs

    def _capture(self):
        before = kops.count_snapshot()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # A graph destroyed while another is being captured (a dead
        # engine's, freed by Python's cycle collector: an engine and its
        # captured calls refer to each other) resets inside the capture,
        # which invalidates it. Collect first, and not during the capture.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                outputs = self.fn(**self.inputs)
        finally:
            if collecting:
                gc.enable()
            delta = kops.counts_since(before)
            kops.add_counts(delta, -1)      # a capture launches nothing
        self.capture_s = time.perf_counter() - t0
        self.graph, self.outputs, self.counts = graph, outputs, delta


def pool_bytes(pool) -> int:
    """Device bytes the caching allocator holds for the graph memory pool
    `pool` (its segments, used or free)."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == tuple(pool))
