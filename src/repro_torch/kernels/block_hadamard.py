"""Online block-Hadamard rotation  X (I_n (x) H_b) / sqrt(b)  over the last axis.

Replaces the TPU kernel `repro/kernels/block_hadamard.py::block_hadamard`
(body `_kernel`, operand `rotation_operand`, tile `_column_tile`). The
serving path reaches it only through the rotation-quality probe
(`serve/quantized.py`, `forward_chunk(probe=True)`), which recomputes the
rotated activation that the fused `hadamard_quant` never writes out.

Bound on an H100: bytes. The function reads M·D elements and writes M·D
elements in x's dtype; the rotation adds `log2(b)` add/sub stages per
element (a b-wide dot product for the Paley orders), far below the card's
f32 rate. Design (`csrc/block_hadamard.cu`): `hadamard_quant`'s rotation
without its quantiser - one thread block per row, the row staged once in
shared memory as f32, rotated there (butterfly for power-of-two orders, a
dense `H_b/sqrt(b)` operand for the others) and written once, so the kernel
moves the bytes the bound counts and no more. At the probe's shapes (a
handful of rows) the launch, not the bytes, is what remains.

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

import torch

from . import _build
from .hadamard_quant import rotate_plain, rotation_operand

__all__ = ["block_hadamard", "block_hadamard_plain", "LAUNCHES"]

# launches of the CUDA kernel (incremented only where it is launched)
LAUNCHES = {"block_hadamard": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    if d * 4 > 227 * 1024:
        raise ValueError(f"row of {d} floats does not fit in shared memory")
    x2 = x.reshape(-1, d).contiguous()
    pow2 = b & (b - 1) == 0
    h = None if pow2 else rotation_operand(b, b, x.device)
    y = torch.empty_like(x2)
    code = _build.load().block_hadamard_launch(
        x2.data_ptr(), _DTYPES[x.dtype],
        h.data_ptr() if h is not None else None, y.data_ptr(),
        x2.shape[0], d, b, _build.stream_ptr(x.device))
    _build.check(code, "block_hadamard")
    LAUNCHES["block_hadamard"] += 1
    return y.reshape(x.shape)
