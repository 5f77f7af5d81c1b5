"""Public entry points of the kernels, with device dispatch.

This module is the only kernel API the serving path uses. The rule: a
tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel or raises - there is no fallback from a
failed build or launch to the plain version; a meta tensor takes a
shape-only path that builds and launches nothing (`_on_meta`: the dry
run's count). `use_kernels(False)` is an
explicit scope that forces the plain versions on any device; the tests and
the on-card comparison phases of `chip_smoke.py` use it, nothing else does.

Entry points accept serving-path shapes directly: activations may carry
leading batch/seq dims ([..., K] codes with [..., 1] per-token scale/zero),
and the packed-weight layout of `pack_int4_weights` is what
`serve.quantized` stores per layer.
"""
from __future__ import annotations

import contextlib

import torch

from . import block_hadamard as _bh
from . import hadamard_quant as _hq
from . import int4_matmul as _i4
from . import paged_attention as _pa

__all__ = [
    "use_kernels",
    "kernels_enabled",
    "block_hadamard",
    "hadamard_quant",
    "quantize_act",
    "int4_matmul",
    "pack_int4_weights",
    "infer_int4_scales",
    "paged_attention",
    "dispatch_counts",
    "reset_dispatch_counts",
    "kernel_launch_counts",
    "reset_kernel_launch_counts",
    "count_snapshot",
    "counts_since",
    "add_counts",
]

_STATE = {"enabled": True}

# Per-(entry point, path) call tallies: path is "kernels" when the call
# launched a CUDA kernel and "ref" when it ran the plain PyTorch version (the
# reference's path tags, so the engine mirrors them into its metrics as
# `kernels.dispatch.<entry>.<kernels|ref>`).
_DISPATCH: dict[tuple[str, str], int] = {}


def _record_dispatch(entry: str, on_kernel: bool):
    key = (entry, "kernels" if on_kernel else "ref")
    _DISPATCH[key] = _DISPATCH.get(key, 0) + 1


def dispatch_counts() -> dict[tuple[str, str], int]:
    """Snapshot of the per-entry-point call tallies (copy)."""
    return dict(_DISPATCH)


def reset_dispatch_counts():
    _DISPATCH.clear()


def kernel_launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel, counted where it is launched."""
    return {**_bh.LAUNCHES, **_hq.LAUNCHES, **_i4.LAUNCHES, **_pa.LAUNCHES}


def reset_kernel_launch_counts():
    for counts in (_bh.LAUNCHES, _hq.LAUNCHES, _i4.LAUNCHES, _pa.LAUNCHES):
        for k in counts:
            counts[k] = 0


def count_snapshot() -> tuple[dict, dict]:
    """Both tallies at once: (kernel launch counts, dispatch tallies)."""
    return kernel_launch_counts(), dispatch_counts()


def counts_since(before: tuple[dict, dict]) -> tuple[dict, dict]:
    """What both tallies counted since `before` (a `count_snapshot()`)."""
    return tuple({k: n - old.get(k, 0) for k, n in now.items()
                  if n != old.get(k, 0)}
                 for now, old in zip(count_snapshot(), before))


def add_counts(delta: tuple[dict, dict], times: int = 1):
    """Advance both tallies by `times` x `delta` (a `counts_since` result).
    The wrappers count in Python, so a call captured in a CUDA graph counts
    once, at capture, and nothing when the graph replays: the graph's owner
    takes the capture's counts back (`times=-1`) and adds them per replay."""
    launches, dispatch = delta
    for counts in (_bh.LAUNCHES, _hq.LAUNCHES, _i4.LAUNCHES, _pa.LAUNCHES):
        for k in counts:
            counts[k] += times * launches.get(k, 0)
    for k, n in dispatch.items():
        _DISPATCH[k] = _DISPATCH.get(k, 0) + times * n


def kernels_enabled() -> bool:
    return _STATE["enabled"]


@contextlib.contextmanager
def use_kernels(enabled: bool):
    prev = _STATE["enabled"]
    _STATE["enabled"] = enabled
    try:
        yield
    finally:
        _STATE["enabled"] = prev


def _on_kernel(t: torch.Tensor) -> bool:
    """Whether a call on `t` launches the kernel: always for a tensor that
    lies on a card, unless a `use_kernels(False)` scope is open."""
    return kernels_enabled() and t.device.type not in ("cpu", "meta")


def _on_meta(t: torch.Tensor) -> bool:
    """Whether a call on `t` takes the shape-only path: a meta tensor (or a
    DTensor of meta shards) outside a `use_kernels(False)` scope. It
    returns meta outputs of the kernel's shapes, builds and launches
    nothing, and inside `launch.hlo_analysis.analyze_step` counts as one op
    with the kernel's FLOPs and bytes. Under `use_kernels(False)` a meta
    call runs the plain version, op by op."""
    return kernels_enabled() and t.device.type == "meta"


def _nbytes(*ts) -> int:
    """Bytes of these tensors on this rank (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in ts if t is not None)


def _kernel_op(name: str, plain, in_bytes: int, *args, **kwargs):
    from ..launch.hlo_analysis import kernel_op
    return kernel_op(name, plain, in_bytes, *args, **kwargs)


def block_hadamard(x: torch.Tensor, b: int) -> torch.Tensor:
    """Online block rotation X (I (x) H_b) / sqrt(b) over the last axis, in
    x's dtype; x may be [..., D]."""
    if _on_meta(x):
        return _kernel_op("block_hadamard", _bh.block_hadamard_plain,
                          _nbytes(x) + (0 if b & (b - 1) == 0 else 4 * b * b),
                          x, b)
    on_kernel = _on_kernel(x)
    _record_dispatch("block_hadamard", on_kernel)
    if not on_kernel:
        return _bh.block_hadamard_plain(x, b)
    return _bh.block_hadamard(x, b)


def hadamard_quant(x: torch.Tensor, b: int, *, bits: int = 4):
    """Fused rotate + quantise -> (codes, scale, zero); x may be [..., D]."""
    if _on_meta(x):
        return _kernel_op("hadamard_quant", _hq.hadamard_quant_plain,
                          _nbytes(x), x, b, bits)
    on_kernel = _on_kernel(x)
    _record_dispatch("hadamard_quant", on_kernel)
    if not on_kernel:
        return _hq.hadamard_quant_plain(x, b, bits)
    return _hq.hadamard_quant(x, b, bits=bits)


def quantize_act(x: torch.Tensor, bits: int = 4):
    """Per-token asymmetric activation quantisation -> (codes, scale, zero):
    the fused kernel at block size 1 (identity rotation)."""
    if _on_meta(x):
        return _kernel_op("quantize_act", _hq.quantize_act_plain,
                          _nbytes(x), x, bits)
    on_kernel = _on_kernel(x)
    _record_dispatch("quantize_act", on_kernel)
    if not on_kernel:
        return _hq.quantize_act_plain(x, bits)
    return _hq.hadamard_quant(x, 1, bits=bits)


def int4_matmul(act_codes, act_scale, act_zero, w_packed, w_scale,
                colsum=None) -> torch.Tensor:
    """True-integer W4A4 GEMM; activations may carry leading dims.

    act_codes [..., K] int8 with per-token act_scale/act_zero [..., 1];
    w_packed [K/2, N] uint8 nibbles, w_scale [N] (or [1, N]); `colsum` int32
    [N] as stored by `pack_int4_weights` (recomputed when absent). Returns
    [..., N] float32.
    """
    lead = act_codes.shape[:-1]
    k = act_codes.shape[-1]
    qa = act_codes.reshape(-1, k)
    sa = act_scale.reshape(-1, 1)
    za = act_zero.reshape(-1, 1)
    if _on_meta(act_codes):
        out = _kernel_op("int4_matmul", _i4.int4_matmul_plain,
                         _nbytes(qa, sa, za, w_packed, w_scale, colsum),
                         qa, sa, za, w_packed, w_scale, colsum)
        return out.reshape(*lead, out.shape[-1])
    on_kernel = _on_kernel(act_codes)
    _record_dispatch("int4_matmul", on_kernel)
    fn = _i4.int4_matmul if on_kernel else _i4.int4_matmul_plain
    out = fn(qa, sa, za, w_packed, w_scale, colsum)
    return out.reshape(*lead, out.shape[-1])


def paged_attention(q, kv, block_tables, q_positions, seq_lengths=None, *,
                    rope_theta=None, kv_bits=None, kv_group=None,
                    q_block=None, kv_splits=None, head_block=None):
    """Block-table-native causal attention over one layer's KV page pool;
    see `kernels.paged_attention.paged_attention`. Returns [B, S, H, Dh]
    f32."""
    kw = dict(rope_theta=rope_theta, kv_bits=kv_bits, kv_group=kv_group,
              q_block=q_block, kv_splits=kv_splits, head_block=head_block)
    if _on_meta(q):
        # the walk's length is data-dependent: count every page the table
        # names (each K and V row with its scale and zero; the products of
        # q against all their rows)
        pages = sum(_nbytes(t) // t.shape[0] for t in kv.values())
        b, s, h, dh = q.shape
        rows = block_tables.shape[1] * kv["k"].shape[1]
        return _kernel_op("paged_attention",
                          lambda: q.new_empty(q.shape, dtype=torch.float32),
                          _nbytes(q, block_tables, q_positions, seq_lengths)
                          + block_tables.numel() * pages,
                          flops=4.0 * b * s * h * dh * rows)
    on_kernel = _on_kernel(q)
    _record_dispatch("paged_attention", on_kernel)
    fn = _pa.paged_attention if on_kernel else _pa.paged_attention_plain
    return fn(q, kv, block_tables, q_positions, seq_lengths, **kw)


def infer_int4_scales(w: torch.Tensor) -> torch.Tensor:
    """Recover per-output-channel symmetric int4 scales from a [K, N] weight.

    Weights that were already rounded to a symmetric int4 grid k*s
    (k in [-7, 7]) do not carry s. `absmax / 7` recovers it only when some
    code hits +-7; searching s in {absmax / m, m = 7..1} for the smallest
    round-trip error recovers the exact grid of every on-grid channel and
    degrades to absmax / 7 for channels that were never on a grid.
    """
    wf = w.to(torch.float32)
    absmax = torch.clamp_min(wf.abs().amax(dim=0), 1e-12)           # [N]
    best_s = None
    best_err = None
    for m in range(7, 0, -1):                                       # prefer 7
        s = absmax / float(m)
        q = torch.clamp(torch.round(wf / s[None]), -7, 7) * s[None]
        err = torch.square(q - wf).sum(dim=0)
        if best_s is None:
            best_s, best_err = s, err
        else:
            better = err < best_err                                 # first min
            best_s = torch.where(better, s, best_s)
            best_err = torch.where(better, err, best_err)
    return best_s


def pack_int4_weights(w: torch.Tensor, scale: torch.Tensor | None = None):
    """Quantise a [K, N] float weight symmetrically to int4 and pack.

    `scale` is per output channel ([N] or [1, N]); when None the grid is
    recovered from the weights by `infer_int4_scales`. Returns {"packed":
    uint8 [K/2, N], "scale": f32 [N], "colsum": int32 [N]} - the column sums
    of the codes feed the asymmetric-activation correction of `int4_matmul`
    and are integers, so storing them at pack time changes no result.
    """
    wf = w.to(torch.float32)
    if scale is None:
        scale = infer_int4_scales(wf)
    scale = scale.reshape(-1).to(torch.float32)
    codes = torch.clamp(torch.round(wf / scale[None]), -7, 7).to(torch.int8)
    return {"packed": _i4.int4_pack(codes), "scale": scale,
            "colsum": codes.to(torch.int32).sum(dim=0, dtype=torch.int32)}
