"""Fused block-Hadamard rotation + per-token asymmetric integer quantisation.

Replaces the TPU kernel `repro/kernels/hadamard_quant.py::hadamard_quant`
(body `_kernel`); with block size 1 it is also `ops.quantize_act`.

Bound on an H100: bytes. Per row the function reads D activations (2 or 4
bytes each) and writes D one-byte codes plus two floats; the rotation adds
only `log2(b)` add/sub stages per element, far below the card's f32 rate.
Design (`csrc/hadamard_quant.cu`): one thread block per row, the row staged
once in shared memory as f32, rotated there (butterfly for power-of-two
orders, a dense `H_b/sqrt(b)` operand for the Paley orders), reduced to its
min/max, quantised and written out - the rotated row never goes to device
memory, so the kernel moves exactly the bytes the bound counts. At decode
sizes (a handful of rows) the launch, not the bytes, is what remains.

`hadamard_quant` is the wrapper: it launches the kernel on a CUDA tensor
and raises on anything else. The plain PyTorch version is below;
`kernels.ops` alone sends a CPU tensor to it.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.hadamard import hadamard
from . import _build

__all__ = ["hadamard_quant", "hadamard_quant_plain", "quantize_act_plain",
           "rotate_plain", "rotation_operand", "column_tile", "LAUNCHES"]

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
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"hadamard_quant: unsupported dtype {x.dtype}")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d).contiguous()
    m = x2.shape[0]
    pow2 = b & (b - 1) == 0
    h = None if pow2 else rotation_operand(b, b, x.device)
    smem = d * 4 * (1 if pow2 else 2)
    if smem > 227 * 1024:
        raise ValueError(f"row of {d} floats does not fit in shared memory")
    codes = torch.empty((m, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    zero = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    lib = _build.load()
    code = lib.hadamard_quant_launch(
        x2.data_ptr(), 0 if x.dtype == torch.float32 else 1,
        h.data_ptr() if h is not None else None,
        codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        m, d, b, bits, _build.stream_ptr(x.device))
    _build.check(code, "hadamard_quant")
    LAUNCHES["hadamard_quant"] += 1
    return (codes.reshape(*lead, d), scale.reshape(*lead, 1),
            zero.reshape(*lead, 1))
