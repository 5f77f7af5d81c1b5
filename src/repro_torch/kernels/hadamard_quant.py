"""Fused block-Hadamard rotation + per-token asymmetric integer quantisation.

Replaces the TPU kernel `repro/kernels/hadamard_quant.py::hadamard_quant`
(body `_kernel`); with block size 1 it is also `ops.quantize_act`.

Bound on an H100: bytes. Per row the function reads D activations (2 or 4
bytes each) and writes D one-byte codes plus two floats; the rotation adds
only `log2(b)` add/sub stages per element, far below the card's f32 rate.
At the serve path's sizes (4-32 rows of 2048-8192) what remains is latency.
Design (`csrc/hadamard_quant.cu`): each row is cut into `c` slices of whole
b-blocks (c in 1, 2, 4, 8), one thread block each, the row's blocks one
thread-block cluster; every element stays in registers from its one
16-byte-vector load to its one code store, rotated by the butterfly that
`block_hadamard` runs (`csrc/hadamard_stages.h`: registers, warp shuffles,
shared-memory rounds for b > 32·E; the Paley orders take E outputs a thread
against a dense `H_b/sqrt(b)` operand); the row's min/max meets across the
cluster through distributed shared memory, so every block computes the same
scale and zero. The rotated row never goes to device memory.
`hadamard_quant_plan` is the launch plan; the C launch checks it
(`csrc/plan_check.h`).

`hadamard_quant` is the wrapper: it launches the kernel on a CUDA tensor
and raises on anything else. The plain PyTorch version is below;
`kernels.ops` alone sends a CPU tensor to it.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..core.hadamard import hadamard
from . import _build

__all__ = ["hadamard_quant", "hadamard_quant_plain", "quantize_act_plain",
           "rotate_plain", "rotation_operand", "column_tile",
           "hadamard_quant_plan", "HadamardQuantPlan", "LAUNCHES"]

# launches of the CUDA kernel (incremented only where it is launched)
LAUNCHES = {"hadamard_quant": 0}

_LANE = 128
_F32_TINY = float(np.finfo(np.float32).tiny)


def _recip_f32(v: float) -> float:
    """1 / v rounded to float32 (as a Python float)."""
    return float(np.float32(1.0) / np.float32(v))


def column_tile(b: int, d: int) -> int:
    """Smallest multiple of b that divides d and is >= 128 (capped at 2048):
    the width of the block-diagonal operand the plain rotation multiplies by,
    chosen as the reference does so both sum in the same order."""
    n = d // b
    best = b
    for m in range(1, n + 1):
        if n % m:
            continue
        td = b * m
        if td > 2048:
            break
        best = td
        if td >= _LANE:
            break
    return best


@functools.lru_cache(maxsize=None)
def _rotation_operand_np(b: int, td: int) -> np.ndarray:
    hb = hadamard(b).astype(np.float32) / math.sqrt(b)
    reps = td // b
    if reps == 1:
        return hb
    return np.kron(np.eye(reps, dtype=np.float32), hb)


_OPERANDS: dict = {}


def rotation_operand(b: int, td: int, device) -> torch.Tensor:
    """I_{td/b} (x) H_b / sqrt(b) as float32 on `device` (cached)."""
    key = (b, td, str(device))
    op = _OPERANDS.get(key)
    if op is None:
        op = _OPERANDS[key] = torch.from_numpy(
            _rotation_operand_np(b, td)).to(device)
    return op


def rotate_plain(x: torch.Tensor, b: int) -> torch.Tensor:
    """X (I (x) H_b) / sqrt(b) over the last axis, in f32, as a product
    against the block-diagonal operand."""
    d = x.shape[-1]
    if d % b:
        raise ValueError(f"feature dim {d} not divisible by block size {b}")
    xf = x.to(torch.float32)
    if b == 1:
        return xf
    td = column_tile(b, d)
    h = rotation_operand(b, td, x.device)
    lead = x.shape[:-1]
    return (xf.reshape(-1, d // td, td) @ h).reshape(*lead, d)


def quantize_act_plain(x: torch.Tensor, bits: int = 4):
    """Per-token (last axis) asymmetric quantisation -> (codes int8 in the
    unsigned range, scale f32 [..., 1], zero f32 [..., 1]); dequant is
    scale * (codes + zero)."""
    xf = x.to(torch.float32)
    levels = float(2 ** bits - 1)
    mn = xf.amin(dim=-1, keepdim=True)
    mx = xf.amax(dim=-1, keepdim=True)
    # range * f32(1 / levels): the compiled reference divides by this
    # constant as a multiply by its reciprocal, one ulp away from a true
    # division - and with bf16 inputs exact rounding ties are common enough
    # for that ulp to flip codes. `x / s` below is a true division there too.
    s = torch.clamp_min((mx - mn) * _recip_f32(levels), _F32_TINY)
    z = torch.round(mn / s)
    codes = torch.clamp(torch.round(xf / s) - z, 0, levels)
    # int8 storage: the conversion saturates at 127 (only bits = 8 reaches it)
    return torch.clamp_max(codes, 127.0).to(torch.int8), s, z


def hadamard_quant_plain(x: torch.Tensor, b: int, bits: int = 4):
    """Plain PyTorch version of the kernel: rotate, then quantise."""
    return quantize_act_plain(rotate_plain(x, b), bits)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"warp": 0, "block": 1, "dense": 2}     # csrc/plan_check.h

# What the plan aims at (`chip_smoke.py --sweep` times other values): E
# elements per thread (16 bytes of bf16); as many slices a row as keep at
# least `PLAN_SLICE` elements in each, but no more than put about
# `PLAN_BLOCKS` blocks on the card (so 1 where the rows alone fill it);
# `PLAN_CLUSTER` fixes the number instead.
PLAN_ELEMS = 8
PLAN_BLOCKS = 132
PLAN_SLICE = 1024
PLAN_CLUSTER = None
CLUSTERS = (1, 2, 4, 8)    # the portable cluster sizes
MAX_THREADS = 1024
SMEM_LIMIT = 232_448 - 4096   # dynamic bytes; the static partials need the rest


@dataclasses.dataclass(frozen=True)
class HadamardQuantPlan:
    kind: str             # "warp", "block" or "dense" (csrc/plan_check.h)
    elems: int            # E: contiguous elements per thread
    threads: int          # per block: the widest slice's chunks, whole warps
    cluster: int          # slices (thread blocks) per row
    grid: int             # m * cluster blocks
    smem_bytes: int       # dynamic: the widest slice in f32 for "block"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _geometry(d: int, b: int, elems: int, cluster: int):
    """(kind, threads, smem bytes) of one candidate, or None where the
    kernel cannot run it."""
    kind = ("dense" if b & (b - 1) else "warp" if b <= 32 * elems else "block")
    if kind == "block" and elems not in (8, 16, 32):
        return None
    unit = b if kind == "dense" else max(b, elems)
    if unit % elems or d % unit or d // unit < cluster:
        return None
    slice_ = _cdiv(d // unit, cluster) * unit          # the widest slice
    threads = _cdiv(slice_ // elems, 32) * 32
    smem = 4 * slice_ if kind == "block" else 0
    if threads > MAX_THREADS or smem > SMEM_LIMIT:
        return None
    return kind, threads, smem


def hadamard_quant_plan(m: int, d: int, b: int) -> HadamardQuantPlan:
    """How the kernel cuts x [m, d] for block size b. E = `PLAN_ELEMS`
    (fewer where d has fewer factors of two; 4, 2 or 1 for the Paley orders,
    which must divide b; at least 8 where b > 32·E takes shared-memory
    rounds); the slices a row c, of 1, 2, 4, 8, the most that leave
    `PLAN_SLICE` elements in each, at most the fewest with m·c ≥
    `PLAN_BLOCKS` (`PLAN_CLUSTER` fixes it). A row that does not fit moves
    to a larger c, then a larger E; a row of fewer than c units (whole
    b-blocks and E-chunks) to a smaller c. Raises ValueError where the
    kernel cannot run: b that does not divide d, or a row too wide for 8
    slices of 1024 threads (or a b-block too large for shared memory)."""
    if b < 1 or d % b:
        raise ValueError(f"feature dim {d} not divisible by block size {b}")
    if m < 1:
        raise ValueError(f"hadamard_quant_plan: needs m >= 1, got {m}")
    if b & (b - 1):
        elems = [4 if b % 4 == 0 else (2 if b % 2 == 0 else 1)]
    else:
        low = d & -d                     # largest power of two dividing d
        e0 = min(PLAN_ELEMS, low)
        if b > 32 * e0:
            e0 = max(e0, 8)
        elems = [e for e in (1, 2, 4, 8, 16, 32) if e0 <= e <= low]
    if PLAN_CLUSTER is not None:
        clusters = [PLAN_CLUSTER]
    else:
        c0 = min(next((c for c in CLUSTERS if m * c >= PLAN_BLOCKS), CLUSTERS[-1]),
                 max([c for c in CLUSTERS if d >= c * PLAN_SLICE], default=1))
        clusters = ([c for c in CLUSTERS if c >= c0]
                    + [c for c in reversed(CLUSTERS) if c < c0])
    for e in elems:
        for c in clusters:
            geo = _geometry(d, b, e, c)
            if geo is not None:
                kind, threads, smem = geo
                return HadamardQuantPlan(kind, e, threads, c, m * c, smem)
    raise ValueError(f"hadamard_quant: a row of {d} with block size {b} does not "
                     f"fit {CLUSTERS[-1]} slices of {MAX_THREADS} threads and "
                     f"{SMEM_LIMIT} bytes of shared memory")


def hadamard_quant(x: torch.Tensor, b: int, *, bits: int = 4):
    """Rotate by (I (x) H_b)/sqrt(b) and quantise per token.

    x [..., D] float32 or bfloat16. Returns (codes int8 [..., D] in
    [0, 2^bits - 1], scale f32 [..., 1], zero f32 [..., 1]).
    """
    d = x.shape[-1]
    if d % b:
        raise ValueError(f"feature dim {d} not divisible by block size {b}")
    if x.device.type != "cuda":
        raise RuntimeError(f"hadamard_quant launches a CUDA kernel; got a "
                           f"tensor on {x.device} (kernels.ops dispatches)")
    if x.dtype not in _DTYPES:
        raise TypeError(f"hadamard_quant: unsupported dtype {x.dtype}")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d).contiguous()
    m = x2.shape[0]
    codes = torch.empty((m, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    zero = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m and d:
        if x2.data_ptr() % 16:
            x2 = x2.clone()                # the kernel loads 16-byte vectors
        plan = hadamard_quant_plan(m, d, b)
        h = rotation_operand(b, b, x.device) if plan.kind == "dense" else None
        code = _build.load().hadamard_quant_launch(
            x2.data_ptr(), _DTYPES[x.dtype],
            h.data_ptr() if h is not None else None,
            codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
            m, d, b, bits, _KINDS[plan.kind], plan.elems, plan.threads,
            plan.cluster, plan.grid, plan.smem_bytes, _build.stream_ptr(x.device))
        _build.check(code, "hadamard_quant")
        LAUNCHES["hadamard_quant"] += 1
    return (codes.reshape(*lead, d), scale.reshape(*lead, 1),
            zero.reshape(*lead, 1))
