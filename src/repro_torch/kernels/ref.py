"""The plain PyTorch versions of every kernel, under the reference's names.

Each function lives beside its kernel (`block_hadamard.py`,
`hadamard_quant.py`, `int4_matmul.py`, `paged_attention.py`); this module
gathers them, with the int4 pack/unpack helpers, under the names
`repro.kernels.ref` uses, so a test or a comparison script finds the oracle
of a kernel where it expects it.
"""
from __future__ import annotations

from .block_hadamard import block_hadamard_plain as block_hadamard_ref
from .hadamard_quant import hadamard_quant_plain, quantize_act_plain
from .int4_matmul import int4_matmul_plain as int4_matmul_ref
from .int4_matmul import int4_pack, int4_unpack
from .paged_attention import combine_partials_plain as combine_partials_ref
from .paged_attention import paged_attention_plain as paged_attention_ref

__all__ = [
    "block_hadamard_ref",
    "hadamard_quant_ref",
    "int4_pack",
    "int4_unpack",
    "int4_matmul_ref",
    "quantize_act_int_ref",
    "paged_attention_ref",
    "combine_partials_ref",
]

quantize_act_int_ref = quantize_act_plain


def hadamard_quant_ref(x, b: int, bits: int = 4):
    """Block-Hadamard rotate, then per-token asymmetric quantisation."""
    return hadamard_quant_plain(x, b, bits)
