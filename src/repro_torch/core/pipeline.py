"""PeRQ end-to-end PTQ pipeline (Figure 2 / Figure 7 of the paper).

Order of operations (function-preserving until rounding):
  1. fold       - absorb the RMSNorm scales into the adjacent projections.
  2. calibrate  - capture every projection's input, layer by layer, through
                  the folded bf16 `Model` (so Hessians live in the runtime
                  space).
  3. rotate     - merge R1 (stream) and R2 (per head) per Remark 4.2; R1 a
                  full-vector Hadamard (QuaRot), a Cayley-learned rotation
                  (SpinQuant) or a block Hadamard (MR-GPTQ / BRQ).
  4. permute    - calibrate P3 with MassDiff (Alg. 1) on the R3-site
                  activations and merge it into the FFN's weights.
  5. round      - RTN / GPTQ / Qronos per projection with Hessians of the
                  transformed (and quantised) activations (Appendix B).
Runtime hooks: dynamic per-token activation quantisation on every
projection input and the online block Hadamard R3 before `w_down` - the
only op left online.

Presets (Table 2):
    perq_star    MassDiff + QuaRot R1/R2 + block R3 + Qronos
    perq_dagger  MassDiff + SpinQuant (Cayley) R1 + block R3 + RTN
    mr_rtn/gptq/qronos   identity P + merged block R1/R2 + block R3
    brq_spin     identity P + learned block R1 + block R3 + GPTQ
    quarot       identity P + full-vector rotations + Qronos (R3 full)
    rtn_only     fold + RTN, nothing else

Family scope (as the reference): dense / vlm / moe get the full graph
(MoE: R1 merged into the router, every expert and the shared experts, and
each expert's own P3 and rounding on the tokens routed to it); encoder
(LayerNorm stream) gets R3 + P3 only; SSM gets R1 on the stream and R3 at
out_proj with a head-preserving MassDiff permutation absorbed into the
Mamba2 inner channels; hybrid adds its shared attention + FFN block,
calibrated on every call of it. The pipeline runs on the parameters'
device and streams the layers: weights, captures and Hessians stay f32
tensors there, one layer's at a time (`quantize_model`).
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Any

import numpy as np
import torch

from ..models.transformer import Model, build_model
from ..tree import tree_map
from . import massdiff as MD
from . import rounding as RD
from .cayley import learn_rotation
from .equivariance import (merge_head_rotation, permute_consumer,
                           permute_producer)
from .hadamard import (block_hadamard_matrix, block_hadamard_transform,
                       constructible, hadamard, hadamard_transform,
                       random_orthogonal)
from .quantizers import QuantSpec, quantize_act

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PTQConfig:
    weight_spec: QuantSpec = QuantSpec(fmt="int4")
    act_spec: QuantSpec = QuantSpec(fmt="int4")
    block_size: int = 32                 # b of the online R3
    full_vector_r3: bool = False         # QuaRot reference (R3 = full)
    permutation: str = "massdiff"        # identity|random|absmax|zigzag|massdiff
    rotation: str = "quarot"             # quarot|spinquant|mr|mr_learned|none
    rounding: str = "qronos"             # rtn|gptq|qronos
    cayley_steps: int = 24
    cayley_lr: float = 5e-3
    seed: int = 0


PRESETS: dict[str, PTQConfig] = {
    "perq_star": PTQConfig(permutation="massdiff", rotation="quarot",
                           rounding="qronos"),
    "perq_dagger": PTQConfig(permutation="massdiff", rotation="spinquant",
                             rounding="rtn"),
    "mr_rtn": PTQConfig(permutation="identity", rotation="mr",
                        rounding="rtn"),
    "mr_gptq": PTQConfig(permutation="identity", rotation="mr",
                         rounding="gptq"),
    "mr_qronos": PTQConfig(permutation="identity", rotation="mr",
                           rounding="qronos"),
    "brq_spin": PTQConfig(permutation="identity", rotation="mr_learned",
                          rounding="gptq"),
    "quarot": PTQConfig(permutation="identity", rotation="quarot",
                        rounding="qronos", full_vector_r3=True),
    "rtn_only": PTQConfig(permutation="identity", rotation="none",
                          rounding="rtn"),
}


def preset(name: str, **overrides) -> PTQConfig:
    return dataclasses.replace(PRESETS[name], **overrides)


# ---------------------------------------------------------------------------
# Calibration capture
# ---------------------------------------------------------------------------

class _Capture:
    """Records projection inputs by (tag, occurrence within a forward), as
    f32 [tokens, features] tensors on the model's device."""

    def __init__(self):
        self.data: dict[tuple[str, int], list[torch.Tensor]] = \
            defaultdict(list)
        self._count: dict[str, int] = defaultdict(int)
        self._counts: dict[int, dict[str, int]] = {}

    def reset_forward(self):
        self._count = defaultdict(int)

    def resume(self, b: int):
        """Go on numbering the records of calibration batch `b`'s forward:
        run one layer at a time over every batch, the model's records are
        numbered as one whole forward of each batch numbers them."""
        self._count = self._counts.setdefault(b, defaultdict(int))

    def _record(self, x, tag: str, keep_dims: int = 1):
        occ = self._count[tag]
        self._count[tag] += 1
        x = x.detach().to(torch.float32)
        if keep_dims == 1:
            x = x.reshape(-1, x.shape[-1])
        self.data[(tag, occ)].append(x)

    def hooks(self) -> dict:
        def act_in(x, tag):
            self._record(x, tag)
            return x

        def down_proj_fn(h, w):
            self._record(h, "down")
            return h @ w

        def moe_down_proj_fn(h, w):
            self._record(h, "moe_down", keep_dims=3)      # [B, E, C, f]
            return torch.einsum("becf,efd->becd", h, w)

        def ssm_out_proj_fn(y, w):
            self._record(y, "ssm_out")
            return y @ w

        return {"act_in": act_in, "down_proj_fn": down_proj_fn,
                "moe_down_proj_fn": moe_down_proj_fn,
                "ssm_out_proj_fn": ssm_out_proj_fn}

    def pop(self, tag: str, occ: int) -> torch.Tensor:
        """The (tag, occ) captures of every batch, concatenated; they are
        dropped from the record."""
        return torch.cat(self.data.pop((tag, occ)), dim=0)

    def get(self, tag: str, occ: int) -> torch.Tensor:
        return torch.cat(self.data[(tag, occ)], dim=0)

    def pop_all(self, tag: str) -> torch.Tensor:
        """Every occurrence of `tag`, concatenated in order and dropped from
        the record (the hybrid's shared block, called once per group)."""
        occs = sorted(o for (t, o) in self.data if t == tag)
        return torch.cat([self.pop(tag, o) for o in occs], dim=0)

    def has(self, tag: str, occ: int = 0) -> bool:
        return (tag, occ) in self.data


# ---------------------------------------------------------------------------
# Rotation / permutation helpers
# ---------------------------------------------------------------------------

def _normalized_hadamard(d: int, device) -> torch.Tensor:
    return torch.from_numpy(
        np.asarray(hadamard(d), np.float32) / math.sqrt(d)).to(device)


def _stream_rotation(d: int, kind: str, b: int, gen: torch.Generator,
                     device) -> torch.Tensor | None:
    if kind == "none":
        return None
    if kind in ("quarot", "spinquant"):
        if constructible(d):
            return _normalized_hadamard(d, device)
        return random_orthogonal(d, gen).to(device)
    if kind in ("mr", "mr_learned"):
        return block_hadamard_matrix(d, min(b, d), device=device)
    raise ValueError(kind)


def _learn_stream_rotation(r0: torch.Tensor, xs: list[torch.Tensor],
                           ws: list[torch.Tensor], cfg: PTQConfig,
                           block: bool) -> torch.Tensor:
    """SpinQuant / BRQ-Spin: Cayley-optimise the stream rotation to
    minimise sum ||Q_a(xR)(R^T W) - xW||^2, with STE through the
    quantisers."""
    d = r0.shape[0]
    xs = [x[:min(len(x), 512)] for x in xs]
    ws = [w.to(torch.float32) for w in ws]
    if block:
        b = min(cfg.block_size, d)
        n = d // b

        def bapply(x, r_small):
            y = x.reshape(*x.shape[:-1], n, b)
            return torch.einsum("...nb,bc->...nc", y, r_small).reshape(x.shape)

        def loss_small(r_small):
            total = 0.0
            for x, w in zip(xs, ws):
                xq = quantize_act(bapply(x, r_small), cfg.act_spec)
                wr = bapply(w.T, r_small).T
                total = total + torch.mean((xq @ wr - x @ w) ** 2)
            return total

        r_small, _ = learn_rotation(loss_small, b,
                                    r0=_normalized_hadamard(b, r0.device),
                                    steps=cfg.cayley_steps, lr=cfg.cayley_lr)
        return torch.kron(torch.eye(n, device=r0.device), r_small)

    def loss(r):
        total = 0.0
        for x, w in zip(xs, ws):
            xq = quantize_act(x @ r, cfg.act_spec)
            total = total + torch.mean((xq @ (r.T @ w) - x @ w) ** 2)
        return total

    r, _ = learn_rotation(loss, d, r0=r0, steps=cfg.cayley_steps,
                          lr=cfg.cayley_lr)
    return r


def _ffn_permutation(h_cal: torch.Tensor, cfg: PTQConfig, *, d: int,
                     head_dim: int | None = None) -> np.ndarray:
    """P3 for a site of width `d` calibrated on `h_cal`; with `head_dim`
    it permutes within each head only (the SSM's inner channels), and is
    the identity when a rotation block would straddle heads."""
    b = cfg.block_size
    if cfg.full_vector_r3 or b >= d or cfg.permutation == "identity":
        return MD.identity(d)
    if head_dim is None:
        return MD.make_permutation(cfg.permutation, h_cal, b, seed=cfg.seed)
    if b > head_dim or head_dim % b:
        return MD.identity(d)
    perm = np.arange(d, dtype=np.int64)
    for h0 in range(0, d, head_dim):
        sub = MD.make_permutation(cfg.permutation,
                                  h_cal[:, h0:h0 + head_dim], b,
                                  seed=cfg.seed)
        perm[h0:h0 + head_dim] = h0 + np.asarray(sub)
    return perm


def _r3_matrix(d: int, cfg: PTQConfig, device) -> torch.Tensor:
    if cfg.full_vector_r3 or cfg.block_size >= d:
        if constructible(d):
            return _normalized_hadamard(d, device)
        return torch.eye(d, dtype=torch.float32, device=device)
    return block_hadamard_matrix(d, cfg.block_size, device=device)


def _apply_r3_online(h: torch.Tensor, cfg: PTQConfig) -> torch.Tensor:
    d = h.shape[-1]
    if cfg.full_vector_r3 or cfg.block_size >= d:
        return hadamard_transform(h) if constructible(d) else h
    return block_hadamard_transform(h, cfg.block_size)


def _round_weight(w: torch.Tensor, x_fp: torch.Tensor | None,
                  cfg: PTQConfig) -> torch.Tensor:
    """Round W [d_in, d_out] given its (transformed) f32 input
    activations."""
    if cfg.rounding == "rtn" or x_fp is None or len(x_fp) < 4:
        return RD.rtn(w, cfg.weight_spec)
    xq = quantize_act(x_fp, cfg.act_spec) if cfg.act_spec.enabled else x_fp
    hq = RD.hessian_from_activations(xq)
    if cfg.rounding == "gptq":
        return RD.gptq(w, hq, cfg.weight_spec)
    if cfg.rounding == "qronos":
        c = RD.cross_from_activations(xq, x_fp)
        return RD.qronos(w, hq, cfg.weight_spec, c_qx=c)
    raise ValueError(cfg.rounding)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PTQResult:
    params: Params
    hooks: dict
    config: PTQConfig
    report: dict


@torch.no_grad()
def quantize_model(model: Model, params: Params,
                   calib_batches: list[Params], cfg: PTQConfig) -> PTQResult:
    """PTQ of `params` (the model's tree, on any device) calibrated on
    `calib_batches` (the model's input dicts, on the same device).
    Returns the fake-quantised parameters in the model's parameter dtype,
    the runtime hooks and a report (`r1`, and per FFN, expert or SSM
    out-projection the R3 site's largest block l1 mass before and after
    the permutation).

    The layers stream: each is copied to f32 and folded, run over every
    calibration batch under the capture hooks (the folded, unquantised
    model's hidden states, carried in the model's dtype from layer to
    layer), then rotated, permuted, rounded and written into its slot of
    an output tree allocated once. Only the embedding, the head, the final
    norm and the hybrid's shared block are held in f32 whole, so the
    device holds the input and output trees and one layer's working set. A
    learned R1 reads layers 0-3, which are calibrated before any layer is
    rounded. Every step after the fold is per layer, so the result is the
    whole-model pipeline's."""
    cfg_a = model.cfg
    fam = cfg_a.family
    ssm_like = fam in ("ssm", "hybrid")
    d = cfg_a.d_model
    n_layers = cfg_a.n_layers
    pdt = model.pdt
    dev = params["lm_head"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    report: dict[str, Any] = {"per_layer": []}

    def f32(a):
        return a.to(torch.float32, copy=True)

    layers = params["layers"]
    P = {k: tree_map(f32, v) for k, v in params.items() if k != "layers"}
    SH = P.get("shared_attn")  # the hybrid's shared block
    moe = "moe" in layers
    ffn_like = layers["ffn"] if "ffn" in layers else (
        SH["ffn"] if SH is not None else None)
    up_names = ("w_gate", "w_up") \
        if ffn_like is None or "w_gate" in ffn_like else ("w_up",)

    # ---- 1. fold norm scales (function-preserving) -------------------------
    rmsnorm_stream = cfg_a.norm == "rmsnorm"

    def fold(lay: dict) -> dict:
        """One layer's f32 leaves (its own copies) with its norm scales
        absorbed, in place."""
        if not rmsnorm_stream:
            return lay
        if ssm_like:
            lay["ssm"]["in_proj"].mul_(lay["norm"]["scale"][:, None])
        else:
            g = lay["attn_norm"]["scale"]
            for w in ("wq", "wk", "wv"):
                lay["attn"][w].mul_(g[:, None])
            g = lay["ffn_norm"]["scale"]
            if moe:
                M = lay["moe"]
                M["router"].mul_(g[:, None])
                for w in ("w_gate", "w_up"):
                    M[w].mul_(g[None, :, None])
                if "shared_gate" in M:
                    for w in ("shared_gate", "shared_up"):
                        M[w].mul_(g[:, None])
            else:
                for w in up_names:
                    lay["ffn"][w].mul_(g[:, None])
        for nm in ("norm", "attn_norm", "ffn_norm"):
            if nm in lay:
                lay[nm]["scale"].fill_(1.0)
        return lay

    def layer_f32(i: int) -> dict:
        return fold(tree_map(lambda a: f32(a[i]), layers))

    if rmsnorm_stream:
        if SH is not None:
            g = SH["attn_norm"]["scale"]
            for w in ("wq", "wk", "wv"):
                SH["attn"][w] = g[:, None] * SH["attn"][w]
            g = SH["ffn_norm"]["scale"]
            for w in up_names:
                SH["ffn"][w] = g[:, None] * SH["ffn"][w]
            SH["attn_norm"]["scale"].fill_(1.0)
            SH["ffn_norm"]["scale"].fill_(1.0)
        P["lm_head"] = P["final_norm"]["scale"][:, None] * P["lm_head"]
        P["final_norm"]["scale"].fill_(1.0)

    # ---- 2. calibrate on the folded model, one layer at a time -------------
    cap = _Capture()
    cap_model = build_model(cfg_a, quant_hooks=cap.hooks())
    inputs = {k: P[k].to(pdt) for k in ("embed", "frontend_proj") if k in P}
    xs = [cap_model.embed_inputs(inputs, batch) for batch in calib_batches]
    del inputs
    shared = None if SH is None else tree_map(lambda a: a.to(pdt), SH)

    def calibrate(i: int, lay: dict):
        """Layer `i` (and a hybrid's shared block where a group ends) over
        every batch: its captures, and the hidden states it hands on."""
        blk = tree_map(lambda a: a.to(pdt), lay)
        for b, x in enumerate(xs):
            cap.resume(b)
            xs[b] = cap_model.layer_step(i, x, blk, shared)

    # ---- 3. stream rotation R1 + per-head R2 -------------------------------
    use_stream_rot = cfg.rotation != "none" and rmsnorm_stream
    r1 = _stream_rotation(d, cfg.rotation, cfg.block_size, gen, dev) \
        if use_stream_rot else None
    report["r1"] = None if r1 is None else cfg.rotation
    # a learned R1 reads the captures and wq of layers 0-3
    n_learn = min(n_layers, 4) \
        if cfg.rotation in ("spinquant", "mr_learned") and r1 is not None \
        else 0

    dh = cfg_a.head_dim
    r2 = _normalized_hadamard(dh, dev) \
        if r1 is not None and cfg_a.n_heads and constructible(dh) else None

    def rotate_attn(t: dict) -> dict:
        """R1 (and R2) merged into one attention block's weights."""
        out = {w: r1.T @ t[w] for w in ("wq", "wk", "wv")}
        wo = t["wo"] @ r1
        if r2 is not None:
            out["wv"], wo = merge_head_rotation(
                out["wv"], wo, r2, cfg_a.n_kv_heads, cfg_a.n_heads)
            if "bv" in t:
                out["bv"] = (t["bv"].reshape(cfg_a.n_kv_heads, dh)
                             @ r2).reshape(-1)
        out["wo"] = wo
        return out

    def rotate_ffn(t: dict) -> dict:
        out = {w: r1.T @ t[w] for w in up_names}
        out["w_down"] = t["w_down"] @ r1
        return out

    def rotate_layer(lay: dict):
        if ssm_like:
            S = lay["ssm"]
            S["in_proj"] = r1.T @ S["in_proj"]
            S["out_proj"] = S["out_proj"] @ r1
            return
        A = lay["attn"]
        names = ("wq", "wk", "wv", "wo") + (("bv",) if "bv" in A else ())
        A.update(rotate_attn({w: A[w] for w in names}))
        if not moe:
            F = lay["ffn"]
            F.update(rotate_ffn({w: F[w] for w in up_names + ("w_down",)}))
            return
        M = lay["moe"]
        M["router"] = r1.T @ M["router"]
        for w in ("w_gate", "w_up"):
            # the d axis of [E, d, f]: R1^T W_e per expert
            M[w] = r1.T @ M[w]
        M["w_down"] = M["w_down"] @ r1
        if "shared_gate" in M:
            for w in ("shared_gate", "shared_up"):
                M[w] = r1.T @ M[w]
            M["shared_down"] = M["shared_down"] @ r1

    # transformed-activation helpers (captures are post-fold, pre-rotation)
    def tx(x):
        return x if r1 is None else x @ r1

    def tx_wo(x):
        if r2 is None:
            return x
        return (x.reshape(len(x), -1, dh) @ r2).reshape(x.shape)

    # ---- 4+5. permutation merge + rounding ---------------------------------
    def block_mass(h, perm_t):
        mb = min(cfg.block_size, h.shape[-1])
        mass = h.abs().mean(dim=0)
        report["per_layer"].append({
            "max_block_l1_before": float(mass.reshape(-1, mb).sum(-1).max()),
            "max_block_l1_after": float(
                mass[perm_t].reshape(-1, mb).sum(-1).max()),
        })

    def do_attn(t: dict, x_qkv, x_wo) -> dict:
        x_qkv = tx(x_qkv)
        out = {w: _round_weight(t[w], x_qkv, cfg) for w in ("wq", "wk", "wv")}
        del x_qkv
        out["wo"] = _round_weight(t["wo"], tx_wo(x_wo), cfg)
        return out

    def do_ffn(t: dict, x_ffn, h_down, names=up_names) -> dict:
        """P3 and R3 merged into one FFN's weights (a dense layer's, an
        expert's or the shared experts'), then rounded."""
        dff = t["w_down"].shape[0]
        perm = _ffn_permutation(h_down, cfg, d=dff)
        r3 = _r3_matrix(dff, cfg, dev)
        x_t = tx(x_ffn)
        out = {w: _round_weight(permute_producer(t[w], perm), x_t, cfg)
               for w in names}
        del x_t
        perm_t = torch.as_tensor(perm, device=dev)
        out["w_down"] = _round_weight(
            r3.T @ permute_consumer(t["w_down"], perm),
            h_down[:, perm_t] @ r3, cfg)
        block_mass(h_down, perm_t)
        return out

    def round_layer(i: int, lay: dict):
        if ssm_like:
            S = lay["ssm"]
            S["in_proj"] = _round_weight(S["in_proj"],
                                         tx(cap.pop("ssm_in", i)), cfg)
            y = cap.pop("ssm_out", i)
            d_inner = y.shape[-1]
            perm = _ffn_permutation(y, cfg, d=d_inner,
                                    head_dim=cfg_a.ssm_head_dim)
            r3 = _r3_matrix(d_inner, cfg, dev)
            _permute_ssm_layer(S, perm)
            perm_t = torch.as_tensor(perm, device=dev)
            S["out_proj"] = _round_weight(
                r3.T @ S["out_proj"][perm_t, :], y[:, perm_t] @ r3, cfg)
            block_mass(y, perm_t)
            return
        A = lay["attn"]
        A.update(do_attn(A, cap.pop("qkv", i), cap.pop("wo", i)))
        x_ffn = cap.pop("ffn", i)
        if not moe:
            F = lay["ffn"]
            F.update(do_ffn(F, x_ffn, cap.pop("down", i)))
            return
        M = lay["moe"]
        h_all = cap.pop("moe_down", i)                 # [N, E, C, f]
        e = cfg_a.n_experts
        x_exp = cap.pop("expert_in", i).reshape(h_all.shape[0], e, -1, d)
        for ex in range(e):
            # the tokens routed to this expert (empty capacity slots are
            # zero rows)
            h_e = h_all[:, ex].reshape(-1, h_all.shape[-1])
            live = h_e.abs().sum(-1) > 0
            if bool(live.any()):
                h_live = h_e[live]
                x_live = x_exp[:, ex].reshape(-1, d)[live]
            else:
                h_live, x_live = h_e, x_exp.new_zeros((2, d))
            new = do_ffn({w: M[w][ex] for w in ("w_gate", "w_up", "w_down")},
                         x_live, h_live, names=("w_gate", "w_up"))
            for w, v in new.items():
                M[w][ex] = v
        del h_all, x_exp
        if "shared_gate" in M:
            # the shared experts' down projection is the only "down" hook
            # of a MoE layer
            new = do_ffn({"w_gate": M["shared_gate"], "w_up": M["shared_up"],
                          "w_down": M["shared_down"]},
                         x_ffn, cap.pop("down", i), names=("w_gate", "w_up"))
            for w, v in new.items():
                M["shared_" + w[2:]] = v

    qlayers = tree_map(lambda a: torch.empty_like(a, dtype=pdt), layers)

    def finish(i: int, lay: dict):
        """Layer `i` rotated, permuted and rounded into its output slot."""
        if r1 is not None:
            rotate_layer(lay)
        round_layer(i, lay)
        tree_map(lambda o, t: o[i].copy_(t), qlayers, lay)

    w_learn = []
    for i in range(n_layers):
        lay = layer_f32(i)
        calibrate(i, lay)
        if i >= n_learn:
            finish(i, lay)
        else:
            w_learn.append(lay["ssm"]["in_proj"] if ssm_like
                           else lay["attn"]["wq"])
        del lay         # before the next layer's copy is made
        if i == n_learn - 1:
            tag = "ssm_in" if ssm_like else "qkv"
            js = [j for j in range(n_learn) if cap.has(tag, j)]
            if js:
                r1 = _learn_stream_rotation(
                    r1, [cap.get(tag, j) for j in js],
                    [w_learn[j] for j in js], cfg,
                    block=cfg.rotation == "mr_learned")
            del w_learn
            # the fold again: the same f32 leaves as the calibration's
            for j in range(n_learn):
                finish(j, layer_f32(j))
    del xs, shared

    if r1 is not None:
        if SH is not None:
            SH["attn"].update(rotate_attn(SH["attn"]))
            SH["ffn"].update(rotate_ffn(SH["ffn"]))
        for name in ("embed", "frontend_proj"):
            if name in P:
                P[name] = P[name] @ r1
        P["lm_head"] = r1.T @ P["lm_head"]
    if SH is not None:
        SH["attn"].update(do_attn(SH["attn"], cap.pop_all("qkv"),
                                  cap.pop_all("wo")))
        SH["ffn"].update(do_ffn(SH["ffn"], cap.pop_all("ffn"),
                                cap.pop_all("down")))

    # ---- runtime hooks ------------------------------------------------------
    act_spec = cfg.act_spec

    def act_in(x, tag):
        return quantize_act(x, act_spec)

    def down_proj_fn(h, w):
        return quantize_act(_apply_r3_online(h, cfg), act_spec) @ w

    def moe_down_proj_fn(h, w):
        hq = quantize_act(_apply_r3_online(h, cfg), act_spec)
        return torch.einsum("becf,efd->becd", hq, w)

    def ssm_out_proj_fn(y, w):
        return quantize_act(_apply_r3_online(y, cfg), act_spec) @ w

    qparams = {k: qlayers if k == "layers"
               else tree_map(lambda a: a.to(pdt), P[k]) for k in params}
    return PTQResult(params=qparams,
                     hooks={"act_in": act_in, "down_proj_fn": down_proj_fn,
                            "moe_down_proj_fn": moe_down_proj_fn,
                            "ssm_out_proj_fn": ssm_out_proj_fn},
                     config=cfg, report=report)


def _permute_ssm_layer(ssm: Params, perm: np.ndarray):
    """Permute one layer's Mamba2 inner channels jointly across (z, x,
    conv, norm), in place, so the out-projection's permutation is
    absorbed. Head-preserving permutations only: the conv is depthwise and
    the SSD elementwise in the within-head channel, so the region is
    permutation-equivariant."""
    d_inner = len(perm)
    in_proj = ssm["in_proj"]
    perm_t = torch.as_tensor(perm, device=in_proj.device)
    in_proj.copy_(torch.cat(
        [in_proj[:, :d_inner][:, perm_t],
         in_proj[:, d_inner:2 * d_inner][:, perm_t],
         in_proj[:, 2 * d_inner:]], dim=1))
    conv_w, conv_b = ssm["conv_w"], ssm["conv_b"]
    conv_w[:, :d_inner] = conv_w[:, :d_inner][:, perm_t]
    conv_b[:d_inner] = conv_b[:d_inner][perm_t]
    ssm["norm_scale"].copy_(ssm["norm_scale"][perm_t])


def _permute_ssm_channels(P: Params, i: int, perm: np.ndarray, cfg_a):
    """`_permute_ssm_layer` on layer `i` of the stacked tree `P` (the
    reference's form)."""
    _permute_ssm_layer({k: v[i] for k, v in P["layers"]["ssm"].items()},
                       perm)


def build_quantized_model(model: Model, result: PTQResult) -> Model:
    return build_model(model.cfg, quant_hooks=result.hooks)
