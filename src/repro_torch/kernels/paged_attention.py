"""Block-table-native paged causal attention, split merge included.

Replaces the TPU kernels `repro/kernels/paged_attention.py::paged_attention`
(body `_kernel`, helpers `dequant_page`, `rope_page`, `page_update`,
`finalize`) and `::_combine_kernel` (arithmetic `combine_partials`).

Three KV page formats go through one walk: float pages holding post-RoPE K,
and int8 / int4 code pages (one code per byte, stored offset by 2^(bits-1))
with per-(row, head, group) scale and zero pages riding along - dequantised,
and K rotated at the absolute position of each page row, inside the walk.

Bound on an H100: bytes. Each live page row of K and V is read once per
query group; at decode the queries and outputs are a few kilobytes beside
them, and even a 32-token prefill chunk's products are far below the TF32
tensor cores' rate. Design (`csrc/paged_attention.cu`): one thread block per
(batch row, KV head, query block, split) holds `q_rows` query positions of
the G heads of its KV head and walks only its split's live table columns -
page ids are read from the block table and nothing past
`ceil(len / page_size)` is touched, so the bytes moved are the bytes the
data needs. The walk goes in tiles of several pages (64 keys at decode, 128
at prefill): `cp.async` copies stage a tile's raw K/V rows (and scale/zero
rows) into a two-slot ring while the previous tile is computed, one pass
dequantises, rotates or widens the tile to f32, and each warp takes 16
query rows and a share of the tile's keys, whose Q·Kᵀ and P·V products run
on the tensor cores (`mma.sync` m16n8k8 TF32 in the 3xTF32 split, which
keeps f32 accuracy) with the online softmax on the fragments; the warps
sharing rows merge their states once at the end. `attention_plan` decides
rows per block, warps, pages per tile and shared-memory bytes; the C launch
checks the plan. Decode steps cut the
walk into fixed-width splits (4 table columns, at most 8 splits) for
parallelism over the context - at T = 16 one split is one tile. The splits'
`(m, l, acc)` partials are merged in the same launch: each split block of a
(batch row, KV head, query block) tile arrives at an int32 counter of the
tile, and the last to arrive merges the tile's rows by log-sum-exp, reading
the partials in split order so the output does not depend on which block
came last. So a call is one launch at any split count. The counters are
zero between calls (every launch leaves them so) and live in a per-device
array that is grown outside any CUDA-graph capture and never freed
(`_scratch`, the rule `int4_matmul`'s workspace follows): run a split call
once before capturing it. `merge_tiles` is the counter count a launch
needs; the C launch checks it (`csrc/plan_check.h`).

`paged_attention` is the wrapper: it launches the kernel on CUDA tensors and
raises on anything else. `LAUNCHES["combine_partials"]` counts its launches
that merged splits (the reference's second kernel, `_combine_kernel`, is
folded into them); `LAUNCHES["paged_attention"]` counts every launch. The
plain PyTorch versions are below, `combine_partials_plain` among them;
`kernels.ops` alone sends a CPU tensor to them. The plain walk visits the
same columns in the same split order.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import _build, _scratch

__all__ = ["paged_attention", "paged_attention_plain", "combine_partials_plain",
           "merge_tiles", "resolve_tiling", "used_page_counts",
           "rope_frequencies", "dequant_page", "rope_page", "page_update",
           "finalize", "attention_plan", "AttentionPlan", "SPLIT_PAGE_COLS",
           "MAX_KV_SPLITS", "MASK_VALUE", "LAUNCHES"]

LAUNCHES = {"paged_attention": 0, "combine_partials": 0}

MASK_VALUE = -1e30

# Decode split-K: fixed-width partitions (4 table columns per split, up to 8
# splits). The width is pinned and the count derived from it, so partition
# boundaries stay put when the table widens: widening only appends splits
# past every used-page count, which carry m = -inf and weigh exactly zero.
SPLIT_PAGE_COLS = 4
MAX_KV_SPLITS = 8


@functools.lru_cache(maxsize=None)
def _rope_frequencies_np(head_dim: int, theta: float) -> np.ndarray:
    return (1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                             / np.float32(head_dim)))).astype(np.float32)


_FREQS: dict = {}


def rope_frequencies(head_dim: int, theta: float,
                     device="cpu") -> torch.Tensor:
    """RoPE inverse frequencies [head_dim / 2] f32, computed on the host in
    numpy so every caller on every device embeds the same literal."""
    key = (head_dim, float(theta), str(device))
    f = _FREQS.get(key)
    if f is None:
        f = _FREQS[key] = torch.from_numpy(
            _rope_frequencies_np(head_dim, float(theta))).to(device)
    return f


# ---------------------------------------------------------------------------
# Shared arithmetic of the plain walk (batched over sequences)
# ---------------------------------------------------------------------------

def dequant_page(codes, scale, zero, *, bits: int, group: int):
    """codes [..., T, KH, Dh] int8 (stored offset by 2^(bits-1)), scale/zero
    [..., T, KH, Dh/group] -> f32 scale * (code + offset + zero)."""
    off = float(2 ** (bits - 1))
    shp = codes.shape
    cg = (codes.to(torch.float32) + off).reshape(
        *shp[:-1], shp[-1] // group, group)
    return (scale[..., None] * (cg + zero[..., None])).reshape(shp)


def rope_page(k, kpos, freqs):
    """RoPE at absolute positions `kpos` [T] on K pages [..., T, KH, Dh]
    (f32), half-split layout."""
    ang = kpos[:, None].to(torch.float32) * freqs           # [T, Dh/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(k.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def page_update(m, l, acc, q, k, v, qpos, kpos, scale):
    """One online-softmax step over one page per sequence.

    q [B, S, KH, G, Dh], k/v [B, T, KH, Dh] f32, qpos [B, S], kpos [T];
    m/l [B, KH, G, S], acc [B, KH, G, S, Dh].
    """
    logits = torch.einsum("bskgd,btkd->bkgst", q, k) * scale
    valid = kpos[None, None, :] <= qpos[:, :, None]          # [B, S, T]
    logits = torch.where(valid[:, None, None], logits,
                         torch.full_like(logits, MASK_VALUE))
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, v)
    return m_new, l_new, acc_new


def finalize(l, acc):
    """acc / l -> [B, S, H, Dh] f32."""
    b, kh, g, s, dh = acc.shape
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, kh * g, dh)


def combine_partials_plain(m, l, acc):
    """Log-sum-exp merge of split partials: m/l [B, KS, H, S], acc
    [B, KS, H, S, Dh] -> [B, S, H, Dh] f32. A split that saw no live page
    (m = -inf) gets weight exactly zero."""
    mx = m.amax(dim=1, keepdim=True)
    w = torch.where(torch.isneginf(m), torch.zeros_like(m), torch.exp(m - mx))
    l_tot = (l * w).sum(dim=1)                               # [B, H, S]
    acc_tot = (acc * w[..., None]).sum(dim=1)                # [B, H, S, Dh]
    out = acc_tot / torch.clamp_min(l_tot[..., None], 1e-30)
    return out.permute(0, 2, 1, 3).contiguous()


# ---------------------------------------------------------------------------
# Tiling resolution (shared by the kernel launch and the plain walk)
# ---------------------------------------------------------------------------

def _largest_divisor(n: int, cap: int) -> int:
    for t in range(min(cap, n), 0, -1):
        if n % t == 0:
            return t
    return 1


def resolve_tiling(s: int, kh: int, n_cols: int, q_block: int | None = None,
                   kv_splits: int | None = None, head_block: int | None = None
                   ) -> tuple[int, int, int, int]:
    """(q_block, kv_splits, head_block, split_cols): at most 8 query rows
    per block, one KV head per block, and - for decode steps (S == 1) over a
    table wider than 4 columns - fixed 4-column splits, up to 8 of them.
    An explicit `kv_splits` gets equal-width `ceil(n_cols / kv_splits)`
    partitions instead."""
    if q_block is None:
        q_block = _largest_divisor(s, min(s, 8))
    if head_block is None:
        head_block = 1
    if kv_splits is None:
        if s == 1 and n_cols > SPLIT_PAGE_COLS:
            split_cols = max(SPLIT_PAGE_COLS, -(-n_cols // MAX_KV_SPLITS))
            kv_splits = -(-n_cols // split_cols)
        else:
            kv_splits, split_cols = 1, n_cols
    else:
        kv_splits = max(1, min(kv_splits, n_cols))
        split_cols = -(-n_cols // kv_splits)
    if s % q_block:
        raise ValueError(f"q_block {q_block} does not divide q_len {s}")
    if kh % head_block:
        raise ValueError(f"head_block {head_block} does not divide "
                         f"n_kv_heads {kh}")
    return q_block, kv_splits, head_block, split_cols


def merge_tiles(b: int, kh: int, s: int, q_rows: int) -> int:
    """Tiles of a split launch - (batch row, KV head, query block of
    `q_rows` positions) - each with one int32 merge counter."""
    return b * kh * -(-s // q_rows)


def used_page_counts(q_positions: torch.Tensor,
                     seq_lengths: torch.Tensor | None,
                     page_size: int, n_cols: int) -> torch.Tensor:
    """[B] int32 live table columns per sequence: ceil(len / page_size),
    clipped to the table. Without `seq_lengths` the length is taken from the
    query positions (the causal mask hides everything past them anyway)."""
    if seq_lengths is None:
        lens = q_positions.amax(dim=1) + 1
    else:
        lens = seq_lengths
    used = torch.div(lens + (page_size - 1), page_size, rounding_mode="floor")
    return torch.clamp(used, 0, n_cols).to(torch.int32)


# ---------------------------------------------------------------------------
# Launch plan of the kernel (how the work is cut; it changes no number)
# ---------------------------------------------------------------------------

# What the plan aims at, from `chip_smoke.py --sweep` on an H100 (PERF.md):
# more query rows per block cut the dequant + RoPE pass that every query
# block repeats; at prefill more warps per block shorten each warp's product
# chain and longer tiles halve the round trips, while at decode (a split is 4
# pages) neither pays.
PLAN_ROWS = 32              # block rows (G * q_rows)
PLAN_DECODE = (4, 64)       # (warps per block, keys per tile) at S == 1
PLAN_PREFILL = (8, 128)     # the same at S > 1
MAX_HEAD_DIM = 128      # the kernel holds a warp's O rows in registers
MAX_ROW_WARPS = 8       # 256 threads per block
SMEM_LIMIT = 232_448    # shared memory one block may use on an H100


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    q_rows: int           # query positions per block; G * q_rows block
                          # rows, row r: head r // q_rows
    warps: int            # row warps: 16 rows each
    key_warps: int        # warps sharing one row warp's rows, each taking
                          # every key_warps-th 8-key n-tile of a tile
    threads: int          # all copy and convert the tiles
    pages_per_tile: int
    smem_bytes: int


def _al16(n: int) -> int:
    return -(-n // 16) * 16


def _smem_bytes(dh: int, t: int, ppt: int, warps: int, key_warps: int,
                esize: int, ng: int) -> int:
    """Shared memory of one block; the same layout as `make_layout` in
    `csrc/paged_attention.cu`, which refuses a plan whose count differs."""
    keys = ppt * t
    kpad = -(-keys // 8) * 8
    ks = dh + 4                                  # f32 K tile and Q rows
    vs = dh + (8 if (dh // 8) % 2 == 0 else 0)   # f32 V tile
    ps = min(kpad, 64) + 4                       # per-warp P scratch
    rows_pad = 16 * warps
    cwarps = warps * key_warps
    stage = 2 * _al16(keys * dh * esize) + 4 * _al16(keys * ng * 4)
    tiles = 2 * stage + _al16(kpad * ks * 4) + _al16(kpad * vs * 4)
    merge = _al16(cwarps * 16 * ks * 4)          # reuses the tile area
    return (max(tiles, merge) + _al16(rows_pad * ks * 4)
            + _al16(cwarps * 16 * ps * 4) + _al16(dh // 2 * 4)
            + _al16(rows_pad * 4) + 16)


def attention_plan(g: int, s: int, dh: int, t: int, page_dtype: torch.dtype,
                   *, group: int | None = None) -> AttentionPlan:
    """How `paged_attention`'s kernel cuts the work for G query heads per KV
    head, S query positions, head dim `dh`, page size `t` and pages of
    `page_dtype` (int8 means code pages with scale/zero per `group`).

    Query positions per block: as many as keep G * q_rows near
    `PLAN_ROWS`; row warps of 16 rows, each joined by key warps up to the
    warps per block of `PLAN_DECODE` (S = 1) or `PLAN_PREFILL` (at most one
    per 8-key n-tile of a tile); pages per tile: their keys per tile // t
    (at least 1), fewer while the block's shared memory would exceed an
    H100's 232,448 bytes. Raises ValueError where the kernel cannot run: a
    head dim that is not a multiple of 8 (the products take 8 at a time) or
    above 128, more than 128 rows for one query position, or a tile of one
    page that does not fit."""
    if dh % 8 or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: head_dim {dh} must be a multiple "
                         f"of 8 and at most {MAX_HEAD_DIM}")
    if g > 16 * MAX_ROW_WARPS:
        raise ValueError(f"paged_attention: {g} query heads per KV head; the "
                         f"kernel takes at most {16 * MAX_ROW_WARPS}")
    q_rows = min(s, max(1, PLAN_ROWS // g))
    while g * q_rows > 16 * MAX_ROW_WARPS:
        q_rows -= 1
    warps = -(-(g * q_rows) // 16)
    quant = page_dtype == torch.int8
    ng = dh // (group or dh) if quant else 0
    esize = torch.empty((), dtype=page_dtype).element_size()
    target_warps, tile_keys = PLAN_DECODE if s == 1 else PLAN_PREFILL
    ppt = max(1, tile_keys // t)

    def key_warps(ppt):
        return max(1, min(target_warps // warps, -(-(ppt * t) // 8)))

    def smem(ppt):
        return _smem_bytes(dh, t, ppt, warps, key_warps(ppt), esize, ng)

    while ppt > 1 and smem(ppt) > SMEM_LIMIT:
        ppt -= 1
    if smem(ppt) > SMEM_LIMIT:
        raise ValueError(f"paged_attention: one page of {t} rows needs "
                         f"{smem(ppt)} bytes of shared memory (limit "
                         f"{SMEM_LIMIT})")
    kw = key_warps(ppt)
    return AttentionPlan(q_rows=q_rows, warps=warps, key_warps=kw,
                         threads=32 * max(4, warps * kw),
                         pages_per_tile=ppt, smem_bytes=smem(ppt))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _partials_plain(q, kv, block_tables, q_positions, seq_lengths, *,
                    rope_theta, kv_bits, kv_group, kv_splits, split_cols):
    """Per-split (m, l, acc) of the page walk: lists of [B, KH, G, S(, Dh)]."""
    b, s, h, dh = q.shape
    t, kh = kv["k"].shape[1], kv["k"].shape[2]
    g = h // kh
    n_cols = block_tables.shape[1]
    quant = kv_bits is not None
    dev = q.device
    used = used_page_counts(q_positions, seq_lengths, t, n_cols)
    max_used = int(used.max()) if b else 0
    freqs = (rope_frequencies(dh, rope_theta, dev)
             if quant and rope_theta is not None else None)
    qf = q.to(torch.float32).reshape(b, s, kh, g, dh)
    qpos = q_positions.to(torch.int64)
    bt = block_tables.to(torch.int64)
    scale = 1.0 / math.sqrt(dh)
    row = torch.arange(t, device=dev)
    parts = []
    for split in range(kv_splits):
        m = torch.full((b, kh, g, s), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kh, g, s), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kh, g, s, dh), dtype=torch.float32, device=dev)
        lo = split * split_cols
        for col in range(lo, min(lo + split_cols, n_cols, max_used)):
            page = bt[:, col]
            kpos = col * t + row
            if quant:
                k = dequant_page(kv["k"][page], kv["k_scale"][page],
                                 kv["k_zero"][page], bits=kv_bits,
                                 group=kv_group)
                v = dequant_page(kv["v"][page], kv["v_scale"][page],
                                 kv["v_zero"][page], bits=kv_bits,
                                 group=kv_group)
                if freqs is not None:
                    k = rope_page(k, kpos, freqs)
            else:
                k = kv["k"][page].to(torch.float32)
                v = kv["v"][page].to(torch.float32)
            new = page_update(m, l, acc, qf, k, v, qpos, kpos, scale)
            # the kernel never touches a dead column: keep the old carry
            keep = (col < used)
            m = torch.where(keep[:, None, None, None], new[0], m)
            l = torch.where(keep[:, None, None, None], new[1], l)
            acc = torch.where(keep[:, None, None, None, None], new[2], acc)
        parts.append((m, l, acc))
    return parts


def paged_attention_plain(q, kv, block_tables, q_positions, seq_lengths=None,
                          *, rope_theta=None, kv_bits=None, kv_group=None,
                          q_block=None, kv_splits=None, head_block=None):
    """Plain PyTorch version of the kernel: a Python loop over table
    columns, split by split, then the combine. Same arguments and result as
    `paged_attention`."""
    b, s, h, dh = q.shape
    kh = kv["k"].shape[2]
    n_cols = block_tables.shape[1]
    if kv_bits is not None and dh % kv_group:
        raise ValueError(f"head_dim {dh} not divisible by kv_group {kv_group}")
    _, kv_splits, _, split_cols = resolve_tiling(
        s, kh, n_cols, q_block, kv_splits, head_block)
    parts = _partials_plain(q, kv, block_tables, q_positions, seq_lengths,
                            rope_theta=rope_theta, kv_bits=kv_bits,
                            kv_group=kv_group, kv_splits=kv_splits,
                            split_cols=split_cols)
    if kv_splits == 1:
        _, l, acc = parts[0]
        return finalize(l, acc)
    m_p = torch.stack([p[0].reshape(b, h, s) for p in parts], dim=1)
    l_p = torch.stack([p[1].reshape(b, h, s) for p in parts], dim=1)
    acc_p = torch.stack([p[2].reshape(b, h, s, dh) for p in parts], dim=1)
    return combine_partials_plain(m_p, l_p, acc_p)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

# Per device: the int32 merge counters of split launches (`_scratch`)
_COUNTERS: dict = {}

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def paged_attention(q: torch.Tensor, kv: dict, block_tables: torch.Tensor,
                    q_positions: torch.Tensor,
                    seq_lengths: torch.Tensor | None = None, *,
                    rope_theta: float | None = None,
                    kv_bits: int | None = None, kv_group: int | None = None,
                    q_block: int | None = None, kv_splits: int | None = None,
                    head_block: int | None = None) -> torch.Tensor:
    """Causal attention of `q` against one layer's KV page pool.

    q [B, S, H, Dh] (already rotated); kv {"k", "v"} pages
    [n_pages, T, KH, Dh] (+ "{k,v}_{scale,zero}" [n_pages, T, KH, Dh/group]
    when `kv_bits` is set); block_tables [B, P] int32 (pad entries point at
    the scratch page); q_positions [B, S] int32 absolute positions;
    seq_lengths [B] optional true context lengths (pages past ceil(len/T)
    are skipped, 0 skips the row). `rope_theta` rotates dequantised K pages
    inside the walk (integer pools store K before RoPE). Returns
    [B, S, H, Dh] float32. The head dim must be a multiple of 8, at most
    128 (`attention_plan`); the plain version takes any even one.
    """
    dev = q.device
    b, s, h, dh = q.shape
    kp, vp = kv["k"], kv["v"]
    t, kh = kp.shape[1], kp.shape[2]
    n_cols = block_tables.shape[1]
    quant = kv_bits is not None
    if q.dtype not in _Q_DTYPES or kp.dtype not in _PAGE_DTYPES \
            or vp.dtype != kp.dtype:
        raise TypeError(f"paged_attention: unsupported dtypes q={q.dtype} "
                        f"pages={kp.dtype}/{vp.dtype}")
    if quant != (kp.dtype == torch.int8):
        raise TypeError("kv_bits must be set exactly for int8 code pages")
    if quant and dh % kv_group:
        raise ValueError(f"head_dim {dh} not divisible by kv_group {kv_group}")
    q_block, kv_splits, _, split_cols = resolve_tiling(
        s, kh, n_cols, q_block, kv_splits, head_block)
    plan = attention_plan(h // kh, s, dh, t, kp.dtype,
                          group=kv_group if quant else None)
    if dev.type != "cuda":
        raise RuntimeError(f"paged_attention launches a CUDA kernel; got a "
                           f"tensor on {dev} (kernels.ops dispatches)")
    aux = [None] * 4
    if quant:
        aux = [kv[n] for n in ("k_scale", "k_zero", "v_scale", "v_zero")]
        for a in aux:
            if a.dtype != torch.float32 or not a.is_contiguous() \
                    or a.device != dev:
                raise TypeError("scale/zero pages must be contiguous float32 "
                                "on the query's device")
    for name, a in (("k pages", kp), ("v pages", vp)):
        if not a.is_contiguous() or a.device != dev:
            raise TypeError(f"{name} must be contiguous on the query's device")
    qc = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    qpos = q_positions.to(torch.int32).contiguous()
    lens = (seq_lengths.to(torch.int32).contiguous()
            if seq_lengths is not None else None)
    freqs = (rope_frequencies(dh, rope_theta, dev)
             if quant and rope_theta is not None else None)
    out = torch.empty((b, s, h, dh), dtype=torch.float32, device=dev)
    m_p = l_p = acc_p = cnt = None
    if kv_splits > 1:
        m_p = torch.empty((b, kv_splits, h, s), dtype=torch.float32, device=dev)
        l_p = torch.empty_like(m_p)
        acc_p = torch.empty((b, kv_splits, h, s, dh), dtype=torch.float32,
                            device=dev)
        (cnt,) = _scratch.zeroed(_COUNTERS, dev,
                                 (merge_tiles(b, kh, s, plan.q_rows),),
                                 "paged_attention")

    def ptr(a):
        return a.data_ptr() if a is not None else None

    lib = _build.load()
    code = lib.paged_attention_launch(
        qc.data_ptr(), _Q_DTYPES[q.dtype], kp.data_ptr(), vp.data_ptr(),
        _PAGE_DTYPES[kp.dtype], ptr(aux[0]), ptr(aux[1]), ptr(aux[2]),
        ptr(aux[3]), ptr(freqs), bt.data_ptr(), qpos.data_ptr(), ptr(lens),
        out.data_ptr(), ptr(m_p), ptr(l_p), ptr(acc_p), ptr(cnt),
        cnt.numel() if cnt is not None else 0, b, s, h, kh, dh, t, n_cols, q_block, kv_splits, split_cols,
        kv_group if quant else 0, kv_bits if quant else 0,
        plan.q_rows, plan.warps, plan.key_warps, plan.threads,
        plan.pages_per_tile, plan.smem_bytes,
        _build.stream_ptr(dev))
    _build.check(code, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    if kv_splits > 1:
        LAUNCHES["combine_partials"] += 1
    return out
