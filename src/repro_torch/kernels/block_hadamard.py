"""Online block-Hadamard rotation  X (I_n (x) H_b) / sqrt(b)  over the last axis.

Replaces the TPU kernel `repro/kernels/block_hadamard.py::block_hadamard`
(body `_kernel`, operand `rotation_operand`, tile `_column_tile`). The
serving path reaches it only through the rotation-quality probe
(`serve/quantized.py`, `forward_chunk(probe=True)`), which recomputes the
rotated activation that the fused `hadamard_quant` never writes out.

Bound on an H100: bytes. The function reads M·D elements and writes M·D
elements in x's dtype; the rotation adds `log2(b)` add/sub stages per
element (a b-wide dot product for the Paley orders), far below the card's
f32 rate. At the probe's shapes (0.1-1 MB) what remains is latency, so the
design (`csrc/block_hadamard.cu`) keeps each element in registers from its
one load to its one store and spreads x over the grid as one flat array of
b-blocks: for a power-of-two b up to 32·E (E elements per thread, 16-byte
vector loads) the butterfly runs in registers and then by warp shuffles,
with no shared memory and no barrier; a larger power-of-two b gives each
b-block a thread block, whose remaining stages go through shared memory in
rounds of log2(E) stages; other orders (Paley: 12, 20, ...) take E outputs
a thread as dot products against the dense operand. `hadamard_plan` is the
launch plan; the C launch checks it (`csrc/plan_check.h`).

Why not a library call: PyTorch has no Hadamard transform. The one call
that computes the same function, `torch.matmul` against the block-diagonal
operand (what the plain version does), reads a [TD, TD] operand and spends
TD multiply-adds per element where the butterfly spends log2(b) adds;
`chip_smoke.py` times it as the yardstick, and the port never calls it on a
CUDA tensor.

`block_hadamard` is the wrapper: it launches the kernel on a CUDA tensor and
raises on anything else. The plain PyTorch version is below; `kernels.ops`
alone sends a CPU tensor to it.
"""
from __future__ import annotations

import dataclasses

import torch

from . import _build
from .hadamard_quant import rotate_plain, rotation_operand

__all__ = ["block_hadamard", "block_hadamard_plain", "hadamard_plan",
           "HadamardPlan", "LAUNCHES"]

# launches of the CUDA kernel (incremented only where it is launched)
LAUNCHES = {"block_hadamard": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# What the plan aims at (`chip_smoke.py --sweep` times other values): E
# elements per thread (16 bytes of bf16, two 16-byte loads of f32), and as
# many warps per block as keep about `PLAN_BLOCKS` blocks in the grid.
PLAN_ELEMS = 8
PLAN_BLOCKS = 132
MAX_WARPS = 8             # warp and dense kernels: 256 threads per block
SMEM_LIMIT = 232_448      # shared memory one block may use on an H100
_KINDS = {"warp": 0, "block": 1, "dense": 2}


@dataclasses.dataclass(frozen=True)
class HadamardPlan:
    kind: str             # "warp", "block" or "dense" (csrc/plan_check.h)
    elems: int            # E: contiguous elements per thread
    threads: int          # per block
    grid: int             # blocks
    smem_bytes: int


def hadamard_plan(m: int, d: int, b: int) -> HadamardPlan:
    """How the kernel cuts x [m, d] for block size b. Power-of-two b: E =
    `PLAN_ELEMS` (fewer where D has fewer factors of two, which then means
    b <= E); the warp kernel takes b <= 32·E, thread blocks of one to
    `MAX_WARPS` warps, about `PLAN_BLOCKS` of them; a larger b gets one
    thread block of b / E threads (E at least 8, raised to keep the block
    within 1024 threads) and b floats of shared memory. Other orders (the
    Paley ones are multiples of 4): 4 outputs per thread, 256 threads a
    block. Raises ValueError where the kernel cannot run: b that does not
    divide d, or a b-block that does not fit in one block's shared
    memory."""
    if b < 1 or d % b:
        raise ValueError(f"feature dim {d} not divisible by block size {b}")
    if b & (b - 1):
        elems = 4 if b % 4 == 0 else (2 if b % 2 == 0 else 1)
        chunks = m * d // elems
        threads = 32 * MAX_WARPS
        return HadamardPlan("dense", elems, threads, max(1, -(-chunks // threads)), 0)
    low = d & -d                       # largest power of two dividing d
    elems = min(PLAN_ELEMS, low)
    if b <= 32 * elems:
        chunks = m * d // elems
        warps = -(-chunks // 32)
        per_block = max(1, min(MAX_WARPS, warps // PLAN_BLOCKS))
        threads = 32 * per_block
        return HadamardPlan("warp", elems, threads, max(1, -(-chunks // threads)), 0)
    elems = max(8, elems, b // 1024)
    if 4 * b > SMEM_LIMIT:
        raise ValueError(f"block_hadamard: a block of {b} floats does not fit "
                         f"in shared memory ({SMEM_LIMIT} bytes)")
    return HadamardPlan("block", elems, b // elems, m * d // b, 4 * b)


def block_hadamard_plain(x: torch.Tensor, b: int) -> torch.Tensor:
    """Plain PyTorch version: the product against the block-diagonal operand
    in f32 (the TPU kernel's arithmetic), cast back to x's dtype."""
    return rotate_plain(x, b).to(x.dtype)


def block_hadamard(x: torch.Tensor, b: int) -> torch.Tensor:
    """Rotate x [..., D] (float32 or bfloat16) by (I (x) H_b)/sqrt(b) over
    its last axis; returns a tensor of x's shape and dtype."""
    d = x.shape[-1]
    if d % b:
        raise ValueError(f"feature dim {d} not divisible by block size {b}")
    if x.device.type != "cuda":
        raise RuntimeError(f"block_hadamard launches a CUDA kernel; got a "
                           f"tensor on {x.device} (kernels.ops dispatches)")
    if x.dtype not in _DTYPES:
        raise TypeError(f"block_hadamard: unsupported dtype {x.dtype}")
    x2 = x.reshape(-1, d).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()                # the kernel loads 16-byte vectors
    m = x2.shape[0]
    plan = hadamard_plan(m, d, b)
    h = rotation_operand(b, b, x.device) if plan.kind == "dense" else None
    y = torch.empty_like(x2)
    code = _build.load().block_hadamard_launch(
        x2.data_ptr(), _DTYPES[x.dtype],
        h.data_ptr() if h is not None else None, y.data_ptr(),
        m, d, b, _KINDS[plan.kind], plan.elems, plan.threads, plan.grid,
        plan.smem_bytes, _build.stream_ptr(x.device))
    _build.check(code, "block_hadamard")
    LAUNCHES["block_hadamard"] += 1
    return y.reshape(x.shape)
