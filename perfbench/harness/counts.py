"""The yardstick: the card's peaks and the work of a step, counted from the
model's shapes and the step's rows and contexts, never from launches. A
family (`perfbench/families/<family>.py::step_work`) says which of these a
step of its model does, in which layers.

Peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity), at the 700 W
power limit: HBM 3.35 TB/s, int8 1979 TOP/s, bf16 989 TFLOP/s.

What is counted, per layer that has it:

  * projections (int4 x int4, held against the int8 peak): 2 M K N
    operations; bytes: the int4 weight codes (K N / 2) and their f32
    per-column scales, the int4 activation codes of each distinct input
    with their f32 scale and zero, and the outputs in the compute dtype
    (bf16). Projections that read one input are one item (K, N); all the
    rows of a step (decode rows and prefill chunks) read each weight once.
  * attention (held against the bf16 peak): 4 H Dh per query and visible
    key (QK^T and PV; masked keys and padded queries do not count); bytes:
    the visible KV rows each read once, as the configuration stores them
    (int4 codes, an f32 scale and zero per position and head, for K and for
    V), the queries read and the outputs written in bf16.
  * the head (bf16): 2 d V per row whose logits are used: every decode row,
    and the last row of a prefill chunk that completes its prompt.

A work item's bound is the larger of its operations over the peak and its
bytes over the bandwidth; a kernel's roofline share is the sum of its items'
bounds over its measured device time.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12

ACT_BYTES = 2          # bf16 activations in and out
KV_CODE_BYTES = 0.5    # int4 codes
KV_AUX_BYTES = 8       # f32 scale + f32 zero per position and head


def _bound(ops: float, nbytes: float, peak: float) -> float:
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


def projection_work(items: list[tuple[int, int]], rows: int,
                    layers: int) -> tuple[float, float, float]:
    """(ops, bytes, bound seconds) of projection items (K, N), each in each
    of `layers` layers, for `rows` token rows."""
    ops = nbytes = bound = 0.0
    for k, n in items:
        o = 2.0 * rows * k * n
        b = k * n / 2 + 4 * n + rows * (k / 2 + 8) + rows * n * ACT_BYTES
        ops += o
        nbytes += b
        bound += _bound(o, b, INT8_OPS_PER_S)
    return ops * layers, nbytes * layers, bound * layers


def attention_work(dims: dict, start: int, rows: int,
                   layers: int) -> tuple[float, float, float]:
    """(ops, bytes, bound seconds) of the attention of `layers` layers for
    `rows` queries at positions start .. start + rows - 1 of one sequence
    (a decode row: rows = 1, start = context - 1); `dims` gives
    `n_heads`, `n_kv_heads` and `head_dim`."""
    h, kv, dh = dims["n_heads"], dims["n_kv_heads"], dims["head_dim"]
    keys = rows * start + rows * (rows + 1) // 2     # visible (query, key)
    ctx = start + rows
    ops = 4.0 * h * dh * keys
    kv_bytes = 2 * ctx * kv * (dh * KV_CODE_BYTES + KV_AUX_BYTES)
    nbytes = kv_bytes + 2 * rows * h * dh * ACT_BYTES
    return (ops * layers, nbytes * layers,
            _bound(ops, nbytes, BF16_FLOPS_PER_S) * layers)


def head_work(dims: dict, rows: int) -> tuple[float, float, float]:
    ops = 2.0 * rows * dims["d_model"] * dims["vocab"]
    nbytes = dims["d_model"] * dims["vocab"] * ACT_BYTES \
        + rows * (dims["d_model"] + dims["vocab"]) * ACT_BYTES
    return ops, nbytes, _bound(ops, nbytes, BF16_FLOPS_PER_S)


def next_pow2(n: int) -> int:
    """The engine pads a prefill chunk of n rows to this many."""
    return 1 << max(0, (n - 1).bit_length())
