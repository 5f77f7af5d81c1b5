"""W4A4 integer GEMM with in-kernel nibble unpack.

Replaces the TPU kernel `repro/kernels/int4_matmul.py::int4_matmul` (body
`_kernel`, tiling `_tile_or_pad`, column-sum prologue).

    out = (s_a * s_w) * (q_a @ q_w + z_a * colsum(q_w))

with `q_a` per-token asymmetric int4 activation codes (int8 storage), `q_w`
symmetric int4 weights packed two rows per byte, an exact int32 accumulator
and a float epilogue.

Bound on an H100: bytes at decode (M <= 16: the packed weight, half a byte
per element, is read once and dwarfs everything else), operations at large
prefill chunks. Design (`csrc/int4_matmul.cu`): nibbles are unpacked to int8
in registers and accumulated with `__dp4a`; each thread owns four output
columns so a warp reads 128 contiguous bytes of a packed row; the K axis is
cut into slices so a decode-sized call still spreads the weight stream over
every SM, the slices' int32 partials being summed by a small second kernel
before the epilogue. Ragged edges are masked in the kernel; nothing is
padded. The column sums come from pack time (`ops.pack_int4_weights`), not
from a pass over the weights on every call.

`int4_matmul` is the wrapper: it launches the kernel on CUDA tensors and
raises on anything else. The plain PyTorch version is below; `kernels.ops`
alone sends a CPU tensor to it.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["int4_matmul", "int4_matmul_plain", "int4_pack", "int4_unpack",
           "int4_colsum", "split_plan", "LAUNCHES"]

LAUNCHES = {"int4_matmul": 0}

# geometry of csrc/int4_matmul.cu
_BN = 256          # output columns per block
_K_STAGE = 256     # K entries staged per pass
_TARGET_BLOCKS = 264   # two blocks per SM on a 132-SM card


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


def split_plan(m: int, n: int, k: int) -> tuple[int, int]:
    """(K extent of one slice, number of slices) for the kernel's grid: as
    many slices as it takes to reach about two blocks per SM, each a
    multiple of the staged K width."""
    bm = 4 if m <= 4 else (8 if m <= 8 else 16)
    blocks = -(-n // _BN) * -(-m // bm)
    want = max(1, -(-_TARGET_BLOCKS // blocks))
    stages = -(-k // _K_STAGE)
    splits = min(want, stages)
    kc = -(-stages // splits) * _K_STAGE
    return kc, -(-k // kc)


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
    if qa.data_ptr() % 4 or w.data_ptr() % 4:
        qa, w = qa.clone(), w.clone()   # the kernel reads 32-bit words
    kc, splits = split_plan(m, n, k)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    part = (torch.empty((splits, m, n), dtype=torch.int32, device=dev)
            if splits > 1 else None)
    lib = _build.load()
    code = lib.int4_matmul_launch(
        qa.data_ptr(), w.data_ptr(),
        part.data_ptr() if part is not None else None,
        sa.data_ptr(), za.data_ptr(), sw.data_ptr(), cs.data_ptr(),
        out.data_ptr(), m, n, k, kc, splits,
        _build.stream_ptr(dev))
    _build.check(code, "int4_matmul")
    LAUNCHES["int4_matmul"] += 1
    return out
