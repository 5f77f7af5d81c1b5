"""Mixture-of-Experts feed-forward: shared (always-on) + routed fine-grained
experts (DeepSeekMoE / Llama4) with capacity-bounded top-k routing.

Dispatch is sort/gather-based, as in the reference: each token's `k` slots
are sorted by expert (stable), each expert keeps its first `c` slots
(`c = max(1, ceil(s * k / E * capacity_factor))`, a host int from shapes)
and the kept tokens are gathered into an expert-major `[B, E, c, d]` grid.
Routing is per batch row, so a padded row never takes capacity from a
live one.

The combine differs from the reference's scatter-add, whose float order
on a CUDA device (`index_add_` / `scatter_add_` are atomics) changes from
run to run: each token gathers the outputs of its own `k` slots from the
grid (their positions come from the dispatch) and sums them in rank
order; a dropped slot reads a zero row. So two calls are bit-equal, and a
decode step captured in a CUDA graph replays the eager step's bits.
Nothing here reads the device on the host (no `nonzero`, boolean indexing
or `.item()`), so a decode step can be captured.

`moe_ffn_dense_oracle` evaluates every expert for every token (no
capacity): the exact reference of the tests.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..distributed.context import (gather_weights, local_offset,
                                   local_shard, local_to_dtensor, on_mesh,
                                   with_axis)
from .layers import _normal

Params = dict[str, Any]


def init_moe(gen: torch.Generator, d_model: int, n_experts: int,
             moe_d_ff: int, n_shared: int, act: str, dtype) -> Params:
    sc_in = 1.0 / math.sqrt(d_model)
    sc_out = 1.0 / math.sqrt(moe_d_ff)
    p = {
        "router": _normal(gen, (d_model, n_experts), sc_in, torch.float32),
        "w_gate": _normal(gen, (n_experts, d_model, moe_d_ff), sc_in, dtype),
        "w_up": _normal(gen, (n_experts, d_model, moe_d_ff), sc_in, dtype),
        "w_down": _normal(gen, (n_experts, moe_d_ff, d_model), sc_out, dtype),
    }
    if n_shared:
        sf = n_shared * moe_d_ff
        p["shared_gate"] = _normal(gen, (d_model, sf), sc_in, dtype)
        p["shared_up"] = _normal(gen, (d_model, sf), sc_in, dtype)
        p["shared_down"] = _normal(gen, (sf, d_model), 1.0 / math.sqrt(sf),
                                   dtype)
    return p


def capacity(s: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert and batch row for a chunk of `s` tokens."""
    return max(1, int(math.ceil(s * top_k / n_experts * capacity_factor)))


def _route(xt: torch.Tensor, router: torch.Tensor, top_k: int):
    """xt: [B, S, d] -> (gates [B, S, k] renormalised, idx [B, S, k]). The
    router runs in f32 whatever the parameters' dtype (the reference's
    type promotion of a bf16 router)."""
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    gates = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(gates, top_k, dim=-1)
    vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    return vals, idx


def _expert_ffn(expert_in: torch.Tensor, p: Params, act: str,
                down_proj_fn=None, act_in=None) -> torch.Tensor:
    """expert_in: [B, E, C, d] -> [B, E, C, d] through per-expert SwiGLU
    (or GELU)."""
    if act_in is not None:
        expert_in = act_in(expert_in, "expert_in")
    if act == "silu":
        h = F.silu(torch.einsum("becd,edf->becf", expert_in, p["w_gate"])) \
            * torch.einsum("becd,edf->becf", expert_in, p["w_up"])
    else:
        h = F.gelu(torch.einsum("becd,edf->becf", expert_in, p["w_up"]),
                   approximate="tanh")
    if down_proj_fn is not None:
        return down_proj_fn(h, p["w_down"])
    return torch.einsum("becf,efd->becd", h, p["w_down"])


def dispatch(idx: torch.Tensor, gates: torch.Tensor, n_experts: int,
             c: int):
    """Per-row slot -> (expert, capacity) assignment.

    idx, gates: [B, S, k]. Returns (tok_grid [B, E*c] int64 token of each
    grid cell (0 where empty), gate_grid [B, E*c] f32 (0 where empty or
    dropped), slot_cell [B, S*k] int64 grid cell of each slot, E*c for a
    dropped one)."""
    b, s, k = idx.shape
    e, sk = n_experts, s * k
    flat_e = idx.reshape(b, sk).to(torch.int64)
    flat_g = gates.reshape(b, sk).to(torch.float32)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    sg = torch.gather(flat_g, 1, order)
    stok = torch.div(order, k, rounding_mode="floor")      # token of slot
    counts = F.one_hot(se, e).sum(dim=1)                     # [B, E]
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(sk, device=idx.device)[None, :] \
        - torch.gather(starts, 1, se)
    keep = pos < c
    dest = torch.where(keep, se * c + pos, torch.full_like(se, e * c))
    # one overflow cell past the grid takes every dropped slot; cut off
    tok_grid = torch.zeros((b, e * c + 1), dtype=torch.int64,
                           device=idx.device).scatter_(1, dest, stok)
    gate_grid = torch.zeros((b, e * c + 1), dtype=torch.float32,
                            device=idx.device).scatter_(
        1, dest, torch.where(keep, sg, torch.zeros_like(sg)))
    slot_cell = torch.empty_like(dest).scatter_(1, order, dest)
    return tok_grid[:, :e * c], gate_grid[:, :e * c], slot_cell


def moe_ffn(x: torch.Tensor, p: Params, *, n_experts: int, top_k: int,
            capacity_factor: float, act: str,
            down_proj_fn=None, act_in=None,
            shared_down_proj_fn=None) -> torch.Tensor:
    """Gather-dispatch MoE. x: [B, S, d] -> [B, S, d]."""
    if act_in is not None:
        x = act_in(x, "ffn")
    if on_mesh(x):
        return _moe_on_mesh(x, p, n_experts=n_experts, top_k=top_k,
                            capacity_factor=capacity_factor, act=act,
                            down_proj_fn=down_proj_fn,
                            shared_down_proj_fn=shared_down_proj_fn)
    b, s, d = x.shape
    e = n_experts
    c = capacity(s, e, top_k, capacity_factor)

    gates, idx = _route(x, p["router"], top_k)               # [B, S, k]
    tok_grid, gate_grid, slot_cell = dispatch(idx, gates, e, c)

    # gather token features into the expert-major layout
    expert_in = torch.gather(x, 1, tok_grid[..., None].expand(b, e * c, d))
    expert_in = expert_in.reshape(b, e, c, d) \
        * (gate_grid.reshape(b, e, c, 1) != 0).to(x.dtype)

    expert_out = _expert_ffn(expert_in, p, act, down_proj_fn, act_in)

    # combine: each token gathers its k weighted slot outputs (a zero row
    # for a dropped slot) and sums them in rank order
    weighted = expert_out.reshape(b, e * c, d) \
        * gate_grid[..., None].to(expert_out.dtype)
    weighted = torch.cat([weighted, weighted.new_zeros((b, 1, d))], dim=1)
    picked = torch.gather(weighted, 1,
                          slot_cell[..., None].expand(b, s * top_k, d))
    picked = picked.reshape(b, s, top_k, d).to(x.dtype)
    out = picked[:, :, 0]
    for j in range(1, top_k):
        out = out + picked[:, :, j]

    if "shared_gate" in p:
        sh = F.silu(x @ p["shared_gate"]) * (x @ p["shared_up"])
        if shared_down_proj_fn is not None:
            out = out + shared_down_proj_fn(sh, p["shared_down"])
        else:
            out = out + sh @ p["shared_down"]
    return out


def _moe_on_mesh(x, p: Params, *, n_experts: int, top_k: int,
                 capacity_factor: float, act: str, down_proj_fn=None,
                 shared_down_proj_fn=None):
    """`moe_ffn` on a mesh of ranks, expert-parallel over the model axis.
    Every rank routes and dispatches its batch rows (the router gathered),
    runs its own experts' FFNs on their cells of the grid (weights split
    over the data axes, ZeRO-3, gathered first) and gathers, for each
    token, the outputs of its slots that landed on those experts (a zero
    row for the others); the partial sums add up over the model axis where
    the residual needs them, as do the shared experts' row-parallel
    outputs. -> [B, S, d] DTensor, partial over the model axis."""
    from torch.distributed.tensor import Partial, Replicate

    def full(w):
        """`w` whole except for its split over the model axis."""
        for ax in ("pod", "data"):
            w = with_axis(w, ax, Replicate())
        return w

    x = with_axis(x, "model", Replicate())
    xl = local_shard(x)
    b, s, d = xl.shape
    e = n_experts
    c = capacity(s, e, top_k, capacity_factor)
    router = local_shard(with_axis(full(p["router"]), "model", Replicate()))
    gates, idx = _route(xl, router, top_k)
    tok_grid, gate_grid, slot_cell = dispatch(idx, gates, e, c)
    w = {k: full(p[k]) for k in ("w_gate", "w_up", "w_down") if k in p}
    e0, el = local_offset(w["w_up"], 0), w["w_up"].to_local().shape[0]
    lo, hi = e0 * c, (e0 + el) * c
    cells, gcells = tok_grid[:, lo:hi], gate_grid[:, lo:hi]
    expert_in = torch.gather(xl, 1, cells[..., None].expand(b, el * c, d))
    expert_in = expert_in.reshape(b, el, c, d) \
        * (gcells.reshape(b, el, c, 1) != 0).to(xl.dtype)
    expert_out = _expert_ffn(expert_in, {k: local_shard(v)
                                         for k, v in w.items()},
                             act, down_proj_fn)
    weighted = expert_out.reshape(b, el * c, d) \
        * gcells[..., None].to(expert_out.dtype)
    weighted = torch.cat([weighted, weighted.new_zeros((b, 1, d))], dim=1)
    cell = slot_cell - lo
    cell = torch.where((cell < 0) | (cell >= el * c),
                       torch.full_like(cell, el * c), cell)
    picked = torch.gather(weighted, 1,
                          cell[..., None].expand(b, s * top_k, d))
    picked = picked.reshape(b, s, top_k, d).to(xl.dtype)
    out = picked[:, :, 0]
    for j in range(1, top_k):
        out = out + picked[:, :, j]
    names = x.device_mesh.mesh_dim_names
    out = local_to_dtensor(out, x, x.shape,
                           [Partial() if a == "model" else pl
                            for a, pl in zip(names, x.placements)])
    if "shared_gate" in p:
        sp = gather_weights({k: p[k] for k in ("shared_gate", "shared_up",
                                               "shared_down")})
        sh = F.silu(x @ sp["shared_gate"]) * (x @ sp["shared_up"])
        if shared_down_proj_fn is not None:
            out = out + shared_down_proj_fn(sh, sp["shared_down"])
        else:
            out = out + sh @ sp["shared_down"]
    return out


def moe_ffn_dense_oracle(x: torch.Tensor, p: Params, *, n_experts: int,
                         top_k: int, act: str,
                         down_proj_fn=None, act_in=None,
                         shared_down_proj_fn=None) -> torch.Tensor:
    """Every expert for every token, mixed by the top-k gates (no capacity
    drops): per-token exact and therefore chunking-invariant - the parity
    oracle of the serving tests. Takes the same PTQ hooks as `moe_ffn`."""
    if act_in is not None:
        x = act_in(x, "ffn")
    gates, idx = _route(x, p["router"], top_k)
    xe = x[:, None].expand(-1, n_experts, -1, -1)             # [B, E, S, d]
    if act_in is not None:
        xe = act_in(xe, "expert_in")
    if act == "silu":
        h = F.silu(torch.einsum("besd,edf->besf", xe, p["w_gate"])) \
            * torch.einsum("besd,edf->besf", xe, p["w_up"])
    else:
        h = F.gelu(torch.einsum("besd,edf->besf", xe, p["w_up"]),
                   approximate="tanh")
    if down_proj_fn is not None:
        allout = down_proj_fn(h, p["w_down"])                 # [B, E, S, d]
    else:
        allout = torch.einsum("besf,efd->besd", h, p["w_down"])
    onehot = F.one_hot(idx, n_experts).to(x.dtype)            # [B, S, k, E]
    mix = torch.einsum("bske,bsk->bse", onehot, gates.to(x.dtype))
    out = torch.einsum("bse,besd->bsd", mix, allout)
    if "shared_gate" in p:
        sh = F.silu(x @ p["shared_gate"]) * (x @ p["shared_up"])
        if shared_down_proj_fn is not None:
            out = out + shared_down_proj_fn(sh, p["shared_down"])
        else:
            out = out + sh @ p["shared_down"]
    return out
