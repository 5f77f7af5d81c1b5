"""Mamba2 (SSD - state-space duality) block.

Chunked SSD for prefill (quadratic within a chunk, a linear state
recurrence across chunks) and an O(1)-per-token recurrent step for decode,
after Dao & Gu 2024 (arXiv:2405.21060): a scalar A per head, grouped B/C
(n_groups = 1), a depthwise causal conv over (x, B, C) and a gated RMSNorm
on the output.

The three-operand contractions of the SSD are written as an elementwise
product and one batched matmul each, so no `[b, c, h, q, k, p]` product is
ever built whatever einsum's contraction order would be. Chunks are padded
to `chunk` tokens as in the reference.

Caches are updated in place (the JAX counterpart returns new arrays): the
native per-batch cache `{"conv": [B, W-1, C], "state": [B, H, N, P]}`, or,
with `register_index` [B], the engine's register slot pools (`[n_slots,
...]` leaves), gathered by slot on entry and written back once at the end.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..distributed.context import (local_offset, local_shard,
                                   local_to_dtensor, on_mesh, reduce_over,
                                   with_axis)
from .layers import _normal, rmsnorm

Params = dict[str, Any]


def ssm_dims(d_model: int, expand: int, head_dim: int, state: int):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * state  # x plus B, C (n_groups = 1)
    return d_inner, n_heads, conv_dim


def init_ssm(gen: torch.Generator, d_model: int, *, expand: int,
             head_dim: int, state: int, conv_width: int, dtype) -> Params:
    d_inner, n_heads, conv_dim = ssm_dims(d_model, expand, head_dim, state)
    dev = gen.device
    in_dim = 2 * d_inner + 2 * state + n_heads  # z, x, B, C, dt
    return {
        "in_proj": _normal(gen, (d_model, in_dim), 1.0 / math.sqrt(d_model),
                           dtype),
        "conv_w": _normal(gen, (conv_width, conv_dim),
                          1.0 / math.sqrt(conv_width), dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          device=dev)).to(torch.float32),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": _normal(gen, (d_inner, d_model),
                            1.0 / math.sqrt(d_inner), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: torch.Tensor | None = None,
                 valid_len: torch.Tensor | None = None):
    """Depthwise causal conv over the sequence axis.

    x: [B, S, C]; w: [W, C]. Returns (out [B, S, C], tail [B, W-1, C]), the
    tail being the conv state to carry into decode. With `valid_len` [B]
    (a right-padded serving chunk) the tail is taken at each row's true
    end, so the carried state equals an unpadded run's."""
    width = w.shape[0]
    if init_state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = init_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    if width > 1:
        if valid_len is None:
            tail = xp[:, -(width - 1):]
        else:
            # the window ending at valid_len: xp rows valid_len ..
            # valid_len + W - 2
            idx = valid_len.to(torch.int64)[:, None] \
                + torch.arange(width - 1, device=x.device)[None, :]
            tail = torch.gather(
                xp, 1, idx[..., None].expand(-1, -1, xp.shape[2]))
    else:
        tail = xp[:, :0]
    return out + b, tail


def _segsum_decay(da_cs: torch.Tensor) -> torch.Tensor:
    """Lower-triangular decay matrix exp(da_cs[q] - da_cs[k]) for k <= q.
    da_cs: [..., Q, H] -> [..., H, Q, Q]."""
    q = da_cs.shape[-2]
    diff = da_cs[..., :, None, :] - da_cs[..., None, :, :]    # [.., Q, Q, H]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=da_cs.device))
    diff = torch.where(mask[..., None], diff,
                       torch.full_like(diff, -math.inf))
    return torch.exp(torch.movedim(diff, -1, -3))              # [.., H, Q, Q]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None):
    """SSD scan. x: [B, S, H, P], dt: [B, S, H] (post-softplus), a: [H]
    (< 0), bmat / cmat: [B, S, N]. Returns (y [B, S, H, P] f32,
    final_state [B, H, N, P] f32)."""
    b, s, h, p_dim = x.shape
    n = bmat.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    sp = s + pad
    nc = sp // chunk

    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, h, p_dim).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    bc = bmat.reshape(b, nc, chunk, n).to(f32)
    cc = cmat.reshape(b, nc, chunk, n).to(f32)

    da = dtc * a                                   # [b, nc, q, h]
    da_cs = torch.cumsum(da, dim=2)
    da_sum = da_cs[:, :, -1]                       # [b, nc, h]

    # intra-chunk (quadratic)
    decay = _segsum_decay(da_cs)                   # [b, nc, h, q, k]
    scores = torch.einsum("bcqn,bckn->bcqk", cc, bc)
    m = scores[:, :, None] * decay                 # [b, nc, h, q, k]
    u = dtc[..., None] * xc                        # [b, nc, k, h, p]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", m, u)

    # chunk-local states
    state_decay = torch.exp(da_sum[:, :, None] - da_cs)        # [b, nc, q, h]
    u = (dtc * state_decay)[..., None] * xc                    # [b, nc, q, h, p]
    sloc = torch.einsum("bcqn,bcqhp->bchnp", bc, u)

    # inter-chunk recurrence: the state entering each chunk
    if init_state is None:
        state = xc.new_zeros((b, h, n, p_dim))
    else:
        state = init_state.to(f32)
    chunk_gain = torch.exp(da_sum)                 # [b, nc, h]
    entering = []
    for ci in range(nc):
        entering.append(state)
        state = state * chunk_gain[:, ci, :, None, None] + sloc[:, ci]
    h_prev = torch.stack(entering, dim=1)          # [b, nc, h, n, p]

    y_inter = torch.einsum("bcqn,bchnp->bcqhp", cc, h_prev) \
        * torch.exp(da_cs)[..., None]

    y = (y_intra + y_inter).reshape(b, sp, h, p_dim)[:, :s]
    return y, state


def ssm_block(x: torch.Tensor, p: Params, *, head_dim: int, state: int,
              chunk: int, cache: Params | None = None,
              register_index: torch.Tensor | None = None,
              valid_len: torch.Tensor | None = None,
              act_in=None, out_proj_fn=None, norm_fn=None,
              zxbcdt: torch.Tensor | None = None) -> torch.Tensor:
    """The Mamba2 block: in_proj -> causal conv -> SSD -> gated RMSNorm ->
    out_proj. Returns the output [B, S, d]; `cache` is updated in place.

    `cache` is the native per-batch cache, or - with `register_index` [B]
    - the register slot pools, gathered by slot on entry and written back
    once (padded rows target the scratch slot). A cached call with S == 1
    is the recurrent decode step. `valid_len` [B] masks a right-padded
    chunk tail out of the recurrence (decay 1, update 0), so the state
    carried past it equals the unpadded run's. `act_in(x, "ssm_in")` and
    `out_proj_fn(y, w)` are the PTQ hooks; `norm_fn(y, scale)` replaces
    the gated RMSNorm's and `zxbcdt` the in-projection's output (a mesh's
    heads-split block). On a mesh of ranks the block is head-parallel
    (`_ssm_on_mesh`)."""
    if on_mesh(x):
        if register_index is not None or act_in is not None \
                or out_proj_fn is not None:
            raise ValueError("on a mesh of ranks the SSM block takes a "
                             "native cache and no hooks")
        return _ssm_on_mesh(x, p, head_dim=head_dim, state=state,
                            chunk=chunk, cache=cache)
    b, s, _ = x.shape
    d_inner = p["out_proj"].shape[0]
    n_heads = p["A_log"].shape[0]
    f32 = torch.float32

    pools = None
    if register_index is not None and cache is not None:
        pools = cache
        slot = register_index.to(torch.int64)
        cache = {"conv": pools["conv"].index_select(0, slot),
                 "state": pools["state"].index_select(0, slot)}

    if act_in is not None:
        x = act_in(x, "ssm_in")
    if zxbcdt is None:
        zxbcdt = x @ p["in_proj"]
    z, xbc, dt = torch.split(
        zxbcdt, [d_inner, d_inner + 2 * state, n_heads], dim=-1)

    decode = cache is not None and s == 1
    conv_in = cache["conv"] if cache is not None else None
    if decode:
        # roll the conv window by one step
        window = torch.cat([conv_in.to(xbc.dtype), xbc], dim=1)
        conv_out = torch.sum(window * p["conv_w"][None], dim=1,
                             keepdim=True) + p["conv_b"]
        new_conv = window[:, 1:]
    else:
        conv_out, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                          init_state=conv_in,
                                          valid_len=valid_len)
    xbc = F.silu(conv_out)

    xs, bmat, cmat = torch.split(xbc, [d_inner, state, state], dim=-1)
    xs = xs.reshape(b, s, n_heads, head_dim)
    dtv = F.softplus(dt.to(f32) + p["dt_bias"])
    if valid_len is not None and not decode:
        # the padded tail decays by exp(0) = 1 and adds nothing
        live = torch.arange(s, device=x.device)[None, :] \
            < valid_len.to(x.device)[:, None]
        dtv = torch.where(live[..., None], dtv, torch.zeros_like(dtv))
    a = -torch.exp(p["A_log"])

    if decode:
        prev = cache["state"]                                  # [b, h, n, p]
        da = torch.exp(dtv[:, 0] * a)                          # [b, h]
        upd = bmat[:, 0].to(f32)[:, None, :, None] \
            * (dtv[:, 0][..., None] * xs[:, 0].to(f32))[:, :, None, :]
        new_state = prev * da[:, :, None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].to(f32),
                         new_state)[:, None]                   # [b, 1, h, p]
    else:
        init = cache["state"] if cache is not None else None
        y, new_state = ssd_chunked(xs, dtv, a, bmat, cmat, chunk,
                                   init_state=init)

    y = y + p["D"][None, None, :, None] * xs.to(f32)
    y = y.reshape(b, s, d_inner).to(x.dtype)
    # gated RMSNorm (Mamba2: norm(y * silu(z)))
    y = (norm_fn or rmsnorm)(y * F.silu(z), p["norm_scale"])
    if out_proj_fn is not None:
        out = out_proj_fn(y, p["out_proj"])
    else:
        out = y @ p["out_proj"]

    if pools is not None:
        # each row's state back to its slot; padded rows all write the
        # scratch slot (dead writes, in no defined order)
        pools["conv"].index_copy_(0, slot, new_conv.to(pools["conv"].dtype))
        pools["state"].index_copy_(0, slot,
                                   new_state.to(pools["state"].dtype))
    elif cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(new_state)
    return out


def _ssm_on_mesh(x, p: Params, *, head_dim: int, state: int, chunk: int,
                 cache: Params | None):
    """`ssm_block` on a mesh of ranks, head-parallel over the model axis
    (Mamba2's tensor parallelism with one B/C group): each rank runs the
    one-device block on its heads - its columns of z, x and dt, the B and C
    columns whole (the in-projection's output or weight gathered, whichever
    is smaller - its split over the model axis does not follow the heads -
    and the conv weights), its A, D,
    dt bias, norm scale and out-projection rows - with the gated RMSNorm's
    sum of squares all-reduced over the axis. The conv cache is split by
    channels without regard to the heads too: its rows are gathered on
    entry and this rank's share of the new ones written back. -> [B, S, d]
    DTensor, partial over the model axis."""
    from torch.distributed.tensor import Partial, Replicate

    def whole(w):
        for ax in ("pod", "data", "model"):
            w = with_axis(w, ax, Replicate())
        return local_shard(w)

    def own(w):                          # split by heads over the model axis
        for ax in ("pod", "data"):
            w = with_axis(w, ax, Replicate())
        return w

    own_data = own                       # whole over the data axes

    d_inner, n_heads = p["out_proj"].shape[0], p["A_log"].shape[0]
    a_log = own(p["A_log"])
    h0, hl = local_offset(a_log, 0), a_log.to_local().shape[0]
    c0, cl = h0 * head_dim, hl * head_dim
    bc = slice(2 * d_inner, 2 * d_inner + 2 * state)

    def own_columns(t):                  # z, x, B, C, dt of this rank's heads
        return torch.cat([t[..., c0:c0 + cl],
                          t[..., d_inner + c0:d_inner + c0 + cl], t[..., bc],
                          t[..., bc.stop + h0:bc.stop + h0 + hl]], -1)

    b_l, s_l = x.to_local().shape[:2]
    zxbcdt = None
    if b_l * s_l < p["in_proj"].shape[0]:
        # fewer tokens than d_model (decode): gather the output
        zxbcdt = own_columns(local_shard(with_axis(
            x @ own_data(p["in_proj"]), "model", Replicate())))
        w_in = None
    else:
        w_in = own_columns(whole(p["in_proj"]))
    w_conv, b_conv = whole(p["conv_w"]), whole(p["conv_b"])
    conv_cols = torch.cat([torch.arange(d_inner + c0, d_inner + c0 + cl),
                           torch.arange(bc.start, bc.stop)]) - d_inner
    local = {
        "in_proj": w_in,
        "conv_w": w_conv[:, conv_cols.to(w_conv.device)],
        "conv_b": b_conv[conv_cols.to(b_conv.device)],
        "A_log": local_shard(a_log), "D": local_shard(own(p["D"])),
        "dt_bias": local_shard(own(p["dt_bias"])),
        "norm_scale": local_shard(own(p["norm_scale"])),
        "out_proj": local_shard(own(p["out_proj"])),
    }
    x = with_axis(x, "model", Replicate())

    def norm(y, scale, eps: float = 1e-6):
        yf = y.to(torch.float32)
        ss = reduce_over(torch.sum(yf * yf, dim=-1, keepdim=True), x,
                         "model", split_consumers=True)
        out = yf * torch.rsqrt(ss / d_inner + eps)
        return (out * scale.to(torch.float32)).to(y.dtype)

    lcache = None
    if cache is not None:
        conv = cache["conv"]
        lcache = {"conv": with_axis(conv, "model", Replicate()).to_local()[
                      ..., conv_cols.to(conv.device)].clone(),
                  "state": cache["state"].to_local()}
    out = ssm_block(local_shard(x), local, head_dim=head_dim, state=state,
                    chunk=chunk, cache=lcache, norm_fn=norm, zxbcdt=zxbcdt)
    if cache is not None:
        # the new conv rows of every channel: this rank's x channels
        # gathered over the axis, the B and C channels its own
        new = lcache["conv"]
        xs = local_to_dtensor(new[..., :cl], x, (*new.shape[:-1], d_inner),
                              [p_ for p_ in _model_split(x, new.dim() - 1)])
        full = torch.cat([with_axis(xs, "model", Replicate()).to_local(),
                          new[..., cl:]], -1)
        dst = conv.to_local()
        k0 = local_offset(conv, conv.dim() - 1)
        dst.copy_(full[..., k0:k0 + dst.shape[-1]].to(dst.dtype))
    names = x.device_mesh.mesh_dim_names
    return local_to_dtensor(out, x, x.shape,
                            [Partial() if a == "model" else pl
                             for a, pl in zip(names, x.placements)])


def _model_split(like, dim: int):
    """`like`'s placements with the model axis split along `dim`."""
    from torch.distributed.tensor import Shard
    names = like.device_mesh.mesh_dim_names
    return [Shard(dim) if a == "model" else pl
            for a, pl in zip(names, like.placements)]


def init_ssm_cache(batch: int, d_model: int, *, expand: int, head_dim: int,
                   state: int, conv_width: int, dtype=torch.bfloat16,
                   device="cuda") -> Params:
    d_inner, n_heads, conv_dim = ssm_dims(d_model, expand, head_dim, state)
    return {
        "conv": torch.zeros((batch, conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, n_heads, state, head_dim),
                             dtype=torch.float32, device=device),
    }
