"""W4A4 integer GEMM with in-kernel nibble unpack.

Replaces the TPU kernel `repro/kernels/int4_matmul.py::int4_matmul` (body
`_kernel`, tiling `_tile_or_pad`, column-sum prologue).

    out = (s_a * s_w) * (q_a @ q_w + z_a * colsum(q_w))

with `q_a` per-token asymmetric int4 activation codes (int8 storage), `q_w`
symmetric int4 weights packed two rows per byte, an exact int32 accumulator
and a float epilogue.

Bound on an H100: bytes, at decode (the packed weight, half a byte per
element, is read once and dwarfs everything else) and at the serve path's
32-row prefill chunks alike, against the int8 tensor cores' rate. Design
(`csrc/int4_matmul.cu`): one kernel for every M on the int8 tensor cores
(`mma.sync` m16n8k32 over `cp.async`-staged tiles of 32 or 64 rows x 128
columns). K is taken in groups of 8 whose nibbles a byte transpose turns
into two words of offset codes w + 8 (K 0,2,4,6 and 1,3,5,7), the
activation codes being read in the same order, and the product is
corrected by -8 · rowsum(q_a), exact in int32. K is split over the grid
until about `PLAN_BLOCKS` blocks spread the weight stream over the SMs; the
splits meet in an int32 workspace by `atomicAdd`, and the last split of
each tile runs the epilogue and leaves the workspace and its counter zero,
so one launch does the call and the call can be replayed from a CUDA graph
(the workspace: `_scratch`).
`int4_plan` is the launch plan; the C launch checks it
(`csrc/plan_check.h`). Ragged edges are masked in the kernel; nothing is
padded. The column sums come from pack time (`ops.pack_int4_weights`), not
from a pass over the weights on every call.

`int4_matmul` is the wrapper: it launches the kernel on CUDA tensors and
raises on anything else. The plain PyTorch version is below; `kernels.ops`
alone sends a CPU tensor to it.
"""
from __future__ import annotations

import dataclasses

import torch

from . import _build, _scratch

__all__ = ["int4_matmul", "int4_matmul_plain", "int4_pack", "int4_unpack",
           "int4_colsum", "int4_plan", "Int4Plan", "LAUNCHES"]

LAUNCHES = {"int4_matmul": 0}

# Geometry of csrc/int4_matmul.cu (csrc/plan_check.h holds the same numbers)
MMA_COLS = 128         # output columns per block: 4 warps of 32
MMA_K_ROWS = 64        # packed rows (128 K) per pipeline stage
MMA_A_PITCH = 2 * MMA_K_ROWS + 32   # bytes per staged activation row
MMA_STAGES = 4         # cp.async ring depth

# What the plan aims at (`chip_smoke.py --sweep` times other values): tiles
# of 32 rows up to M = 32, else 64 (`PLAN_ROWS` overrides); K split until
# the grid holds about `PLAN_BLOCKS` blocks.
PLAN_ROWS = None
PLAN_BLOCKS = 264


@dataclasses.dataclass(frozen=True)
class Int4Plan:
    rows: int             # activation rows per block (32 or 64)
    k_rows: int           # packed weight rows (2 K each) per K split
    splits: int           # K splits (grid.y); > 1 uses the workspace
    threads: int          # 4 warps per 32 rows
    grid: tuple           # (column tiles, splits, row tiles)
    smem_bytes: int       # dynamic shared memory


def int4_pack(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (values in [-8, 7], int8) pairwise along axis 0: rows
    2k (low nibble) and 2k+1 (high nibble) -> uint8 [K/2, N]."""
    if codes.shape[0] % 2:
        raise ValueError("K must be even to pack nibbles")
    u = (codes.to(torch.int32) & 0xF).to(torch.uint8)
    return u[0::2] | (u[1::2] << 4)


def int4_unpack(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `int4_pack` -> int8 codes in [-8, 7], shape [K, N]."""
    p = packed.to(torch.int16)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    k2, n = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * k2, n).to(torch.int8)


def int4_colsum(packed: torch.Tensor) -> torch.Tensor:
    """int32 [N] column sums of the unpacked weight codes."""
    return int4_unpack(packed).to(torch.int32).sum(dim=0, dtype=torch.int32)


def _int_product(qa: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product q_a @ q_w -> int32, through a float matmul whose
    every partial sum is an exactly representable integer."""
    k = qa.shape[-1]
    # |q_a| <= 128, |q_w| <= 8: partial sums stay below 2^24 for K < 16384
    dt = torch.float32 if k * 128 * 8 < 2 ** 24 else torch.float64
    return (qa.to(dt) @ w.to(dt)).to(torch.int32)


def int4_matmul_plain(act_codes: torch.Tensor, act_scale: torch.Tensor,
                      act_zero: torch.Tensor, w_packed: torch.Tensor,
                      w_scale: torch.Tensor,
                      colsum: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: [M, K] codes, [M, 1] scale/zero, [K/2, N]
    packed weights, [N] or [1, N] weight scales -> f32 [M, N]."""
    if 2 * w_packed.shape[0] != act_codes.shape[-1]:
        raise ValueError(f"packed K mismatch: acts K={act_codes.shape[-1]}, "
                         f"weights K={2 * w_packed.shape[0]}")
    w = int4_unpack(w_packed)
    acc = _int_product(act_codes, w)
    if colsum is None:
        colsum = w.to(torch.int32).sum(dim=0, dtype=torch.int32)
    cs = colsum.reshape(1, -1).to(torch.float32)
    sw = w_scale.reshape(1, -1).to(torch.float32)
    sa = act_scale.reshape(-1, 1).to(torch.float32)
    za = act_zero.reshape(-1, 1).to(torch.float32)
    return (sa * sw) * (acc.to(torch.float32) + za * cs)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def int4_plan(m: int, n: int, k: int) -> Int4Plan:
    """How the kernel cuts q_a [m, k] x packed w [k/2, n]: tiles of `rows`
    x 128 columns; K cut into splits of whole 64-row stages, as many as
    bring the grid near `PLAN_BLOCKS` blocks; a 4-stage ring of shared
    memory. Raises ValueError where the kernel cannot run: an odd K,
    or a grid past CUDA's limits."""
    if k <= 0 or k % 2 or m <= 0 or n <= 0:
        raise ValueError(f"int4_matmul: needs M, N > 0 and an even K > 0; got "
                         f"M={m}, N={n}, K={k}")
    rows = PLAN_ROWS or (32 if m <= 32 else 64)
    gx, gz = _cdiv(n, MMA_COLS), _cdiv(m, rows)
    stages_k = _cdiv(k // 2, MMA_K_ROWS)
    splits = min(stages_k, max(1, _cdiv(PLAN_BLOCKS, gx * gz)))
    k_rows = _cdiv(stages_k, splits) * MMA_K_ROWS
    splits = _cdiv(k // 2, k_rows)
    if gx > 2 ** 31 - 1 or gz > 65535 or splits > 65535:
        raise ValueError(f"int4_matmul: grid {(gx, splits, gz)} past CUDA's limits")
    return Int4Plan(rows, k_rows, splits, 4 * rows, (gx, splits, gz),
                    MMA_STAGES * (MMA_K_ROWS * MMA_COLS + rows * MMA_A_PITCH))


# Per device: the int32 split workspace and its tile counters (`_scratch`)
_WORKSPACE: dict = {}


def int4_matmul(act_codes: torch.Tensor, act_scale: torch.Tensor,
                act_zero: torch.Tensor, w_packed: torch.Tensor,
                w_scale: torch.Tensor,
                colsum: torch.Tensor | None = None) -> torch.Tensor:
    """act_codes [M, K] int8; act_scale/zero [M, 1] f32; w_packed [K/2, N]
    uint8; w_scale [N] or [1, N] f32; colsum int32 [N] (computed here when
    absent) -> f32 [M, N]."""
    m, k = act_codes.shape
    k2, n = w_packed.shape
    if 2 * k2 != k:
        raise ValueError(f"packed K mismatch: acts K={k}, weights K={2 * k2}")
    dev = act_codes.device
    if dev.type != "cuda":
        raise RuntimeError(f"int4_matmul launches a CUDA kernel; got a "
                           f"tensor on {dev} (kernels.ops dispatches)")
    if act_codes.dtype != torch.int8 or w_packed.dtype != torch.uint8:
        raise TypeError("int4_matmul takes int8 codes and uint8 packed weights")
    if colsum is None:
        colsum = int4_colsum(w_packed)
    qa = act_codes.contiguous()
    w = w_packed.contiguous()
    sa = act_scale.reshape(-1).to(torch.float32).contiguous()
    za = act_zero.reshape(-1).to(torch.float32).contiguous()
    sw = w_scale.reshape(-1).to(torch.float32).contiguous()
    cs = colsum.reshape(-1).to(torch.int32).contiguous()
    if sa.numel() != m or za.numel() != m or sw.numel() != n or cs.numel() != n:
        raise ValueError("scale / zero / colsum shapes do not match [M, K] x [K, N]")
    for t in (w, sa, za, sw, cs):
        if t.device != dev:
            raise RuntimeError("int4_matmul: operands on different devices")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if qa.data_ptr() % 16:
        qa = qa.clone()                 # the kernel reads 16-byte vectors
    if w.data_ptr() % 16:
        w = w.clone()
    plan = int4_plan(m, n, k)
    ws = cnt = None
    if plan.splits > 1:
        ws, cnt = _scratch.zeroed(_WORKSPACE, dev, (m * n, plan.grid[0] * plan.grid[2]),
                                  "int4_matmul")
    lib = _build.load()
    code = lib.int4_matmul_launch(
        qa.data_ptr(), w.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        cnt.data_ptr() if cnt is not None else None,
        sa.data_ptr(), za.data_ptr(), sw.data_ptr(), cs.data_ptr(),
        out.data_ptr(), m, n, k, plan.rows, plan.k_rows, plan.splits,
        plan.threads, *plan.grid, plan.smem_bytes, _build.stream_ptr(dev))
    _build.check(code, "int4_matmul")
    LAUNCHES["int4_matmul"] += 1
    return out
