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

The port runs the dense, vlm and encoder families (LayerNorm streams get
R3 + P3 only), on the parameters' device: weights, captures and Hessians
stay f32 tensors there, and each layer's captures are freed once the layer
is rounded. The MoE and SSM/hybrid branches are ROADMAP Queue A10.
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

    def reset_forward(self):
        self._count = defaultdict(int)

    def _record(self, x, tag: str):
        occ = self._count[tag]
        self._count[tag] += 1
        self.data[(tag, occ)].append(
            x.detach().to(torch.float32).reshape(-1, x.shape[-1]))

    def hooks(self) -> dict:
        def act_in(x, tag):
            self._record(x, tag)
            return x

        def down_proj_fn(h, w):
            self._record(h, "down")
            return h @ w

        return {"act_in": act_in, "down_proj_fn": down_proj_fn}

    def pop(self, tag: str, occ: int) -> torch.Tensor:
        """The (tag, occ) captures of every batch, concatenated; they are
        dropped from the record."""
        return torch.cat(self.data.pop((tag, occ)), dim=0)

    def get(self, tag: str, occ: int) -> torch.Tensor:
        return torch.cat(self.data[(tag, occ)], dim=0)

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


def _ffn_permutation(h_cal: torch.Tensor, cfg: PTQConfig, *,
                     d: int) -> np.ndarray:
    b = cfg.block_size
    if cfg.full_vector_r3 or b >= d or cfg.permutation == "identity":
        return MD.identity(d)
    return MD.make_permutation(cfg.permutation, h_cal, b, seed=cfg.seed)


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
    the runtime hooks and a report (`r1`, and per layer the FFN hidden's
    largest block l1 mass before and after the permutation)."""
    cfg_a = model.cfg
    if cfg_a.family not in ("dense", "vlm", "encoder"):
        raise NotImplementedError(
            f"{cfg_a.name}: quantize_model's {cfg_a.family} branch is "
            "ROADMAP Queue A10")
    d = cfg_a.d_model
    n_layers = cfg_a.n_layers
    dev = params["lm_head"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    report: dict[str, Any] = {"per_layer": []}

    P = tree_map(lambda a: a.to(torch.float32).clone(), params)
    L = P["layers"]
    A, F = L["attn"], L["ffn"]
    has_gate = "w_gate" in F
    up_names = ("w_gate", "w_up") if has_gate else ("w_up",)

    # ---- 1. fold norm scales (function-preserving) -------------------------
    rmsnorm_stream = cfg_a.norm == "rmsnorm"
    if rmsnorm_stream:
        for i in range(n_layers):
            g = L["attn_norm"]["scale"][i]
            for w in ("wq", "wk", "wv"):
                A[w][i] = g[:, None] * A[w][i]
            g = L["ffn_norm"]["scale"][i]
            for w in up_names:
                F[w][i] = g[:, None] * F[w][i]
        L["attn_norm"]["scale"].fill_(1.0)
        L["ffn_norm"]["scale"].fill_(1.0)
        P["lm_head"] = P["final_norm"]["scale"][:, None] * P["lm_head"]
        P["final_norm"]["scale"].fill_(1.0)

    # ---- 2. calibrate on the folded model ----------------------------------
    cap = _Capture()
    cap_model = build_model(cfg_a, quant_hooks=cap.hooks())
    folded = tree_map(lambda a: a.to(model.pdt), P)
    for batch in calib_batches:
        cap.reset_forward()
        cap_model.forward(folded, batch)
    del folded

    # ---- 3. stream rotation R1 + per-head R2 -------------------------------
    use_stream_rot = cfg.rotation != "none" and rmsnorm_stream
    r1 = _stream_rotation(d, cfg.rotation, cfg.block_size, gen, dev) \
        if use_stream_rot else None
    if r1 is not None and cfg.rotation in ("spinquant", "mr_learned"):
        layers = [i for i in range(min(n_layers, 4)) if cap.has("qkv", i)]
        if layers:
            r1 = _learn_stream_rotation(
                r1, [cap.get("qkv", i) for i in layers],
                [A["wq"][i] for i in layers], cfg,
                block=cfg.rotation == "mr_learned")
    report["r1"] = None if r1 is None else cfg.rotation

    dh = cfg_a.head_dim
    r2 = _normalized_hadamard(dh, dev) \
        if r1 is not None and constructible(dh) else None

    if r1 is not None:
        for i in range(n_layers):
            for w in ("wq", "wk", "wv"):
                A[w][i] = r1.T @ A[w][i]
            wo = A["wo"][i] @ r1
            if r2 is not None:
                A["wv"][i], wo = merge_head_rotation(
                    A["wv"][i], wo, r2, cfg_a.n_kv_heads, cfg_a.n_heads)
                if "bv" in A:
                    A["bv"][i] = (A["bv"][i].reshape(cfg_a.n_kv_heads, dh)
                                  @ r2).reshape(-1)
            A["wo"][i] = wo
            for w in up_names:
                F[w][i] = r1.T @ F[w][i]
            F["w_down"][i] = F["w_down"][i] @ r1
        for name in ("embed", "frontend_proj"):
            if name in P:
                P[name] = P[name] @ r1
        P["lm_head"] = r1.T @ P["lm_head"]

    # transformed-activation helpers (captures are post-fold, pre-rotation)
    def tx(x):
        return x if r1 is None else x @ r1

    def tx_wo(x):
        if r2 is None:
            return x
        return (x.reshape(len(x), -1, dh) @ r2).reshape(x.shape)

    # ---- 4+5. permutation merge + rounding, layer by layer -----------------
    dff = F["w_down"].shape[1]
    r3 = _r3_matrix(dff, cfg, dev)
    mb = min(cfg.block_size, dff)
    for i in range(n_layers):
        x_qkv = tx(cap.pop("qkv", i))
        for w in ("wq", "wk", "wv"):
            A[w][i] = _round_weight(A[w][i], x_qkv, cfg)
        del x_qkv
        A["wo"][i] = _round_weight(A["wo"][i], tx_wo(cap.pop("wo", i)), cfg)

        h_down = cap.pop("down", i)
        perm = _ffn_permutation(h_down, cfg, d=dff)
        for w in up_names:
            F[w][i] = permute_producer(F[w][i], perm)
        F["w_down"][i] = r3.T @ permute_consumer(F["w_down"][i], perm)
        x_t = tx(cap.pop("ffn", i))
        for w in up_names:
            F[w][i] = _round_weight(F[w][i], x_t, cfg)
        del x_t
        perm_t = torch.as_tensor(perm, device=dev)
        F["w_down"][i] = _round_weight(F["w_down"][i],
                                       h_down[:, perm_t] @ r3, cfg)
        mass = h_down.abs().mean(dim=0)
        report["per_layer"].append({
            "max_block_l1_before": float(mass.reshape(-1, mb).sum(-1).max()),
            "max_block_l1_after": float(
                mass[perm_t].reshape(-1, mb).sum(-1).max()),
        })
        del h_down

    # ---- runtime hooks ------------------------------------------------------
    act_spec = cfg.act_spec

    def act_in(x, tag):
        return quantize_act(x, act_spec)

    def down_proj_fn(h, w):
        return quantize_act(_apply_r3_online(h, cfg), act_spec) @ w

    qparams = tree_map(lambda a: a.to(model.pdt), P)
    return PTQResult(params=qparams,
                     hooks={"act_in": act_in, "down_proj_fn": down_proj_fn},
                     config=cfg, report=report)


def build_quantized_model(model: Model, result: PTQResult) -> Model:
    return build_model(model.cfg, quant_hooks=result.hooks)
