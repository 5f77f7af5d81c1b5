"""Per-device int32 arrays that a kernel's every launch leaves zero.

`int4_matmul`'s split workspace with its tile counters and
`paged_attention`'s merge counters are such arrays: a launch finds them
zero and leaves them zero, so one launch does a call and the call can be
captured in a CUDA graph and replayed. One set per kernel and device is
current; calls on a device must not run concurrently on two streams. A set,
once handed to a launch, lives as long as the process: a call that needs
more allocates a larger set and retires the old one to `_RETIRED`, never to
the allocator, because a CUDA graph captured earlier still launches into
the old pointers. The old set stays zero (every launch leaves it so), so
the graph's replays and the new eager calls each have a valid set. A set
cannot grow during a capture (the allocation would belong to it): run the
call once, at its largest shape, before capturing it.
"""
from __future__ import annotations

import torch

_RETIRED: list = []


def zeroed(current: dict, dev: torch.device, sizes: tuple, owner: str) -> tuple:
    """The int32 arrays of `owner` on `dev`, at least `sizes` long and all
    zero. `current` is the owner's dict of the set in use per device index."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    have = current.get(key)
    if have is None or any(a.numel() < n for a, n in zip(have, sizes)):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{owner}: its int32 scratch must be allocated before CUDA-graph "
                "capture; run the call once outside the capture")
        if have is not None:
            _RETIRED.append(have)
            sizes = tuple(max(n, a.numel()) for a, n in zip(have, sizes))
        have = current[key] = tuple(
            torch.zeros(n, dtype=torch.int32, device=dev) for n in sizes)
    return have
