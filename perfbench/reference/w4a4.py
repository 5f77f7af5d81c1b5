"""Plain PyTorch reference of the W4A4 dense decoder the benchmark serves:
what its layers store in the KV cache for a token sequence, and the head's
logits.

It works everything out again from the bf16 weights the benchmark drew:

  * the weight preparation of the `rtn_only` preset at block size b: the
    RMSNorm scales folded into the projections that read them, the block
    rotation I (x) H_b / sqrt(b) merged into `w_down`, round-to-nearest
    onto a symmetric int4 grid whose per-output-channel scale is the first
    of 80 ratios of the absmax that least squares the error, the result
    stored in the parameter dtype, and the grid read back from the stored
    values (the smallest error over absmax / m, m = 7..1);
  * the forward: per-token asymmetric int4 activations in front of every
    projection (after the online block rotation in front of `w_down`),
    exact integer products, K and V stored as asymmetric int4 codes with
    one scale and zero per position and head, K rotated by RoPE after it
    is read back, causal softmax attention in f32, SwiGLU, the final norm
    and the head (the final norm's scale folded into it).

Every value the configuration keeps in the compute dtype is rounded to it
at the point the model definition stores it; everything else is f32 with
no TF32. RMSNorm takes `norm_eps`, the configuration's eps for the
residual stream as `harness/weights.py` draws it. `fmt="fp8"` rounds those values to float8 e4m3 instead (a scale per
row), the precision below bf16: the benchmark's control.

The reference imports nothing of the program under test.
"""
from __future__ import annotations

import math

import numpy as np
import torch

TINY = float(np.finfo(np.float32).tiny)
N_RATIOS = 80
RATIO_LO = 0.2
E4M3_MAX = 448.0
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def recip_f32(v: float) -> float:
    """1 / v rounded to float32."""
    return float(np.float32(1.0) / np.float32(v))


def rounder(fmt: str):
    """x -> x rounded to the storage format `fmt`, returned in f32."""
    if fmt == "float32":
        return lambda x: x.to(torch.float32)
    if fmt == "bfloat16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    if fmt == "fp8":
        def fp8(x):
            x = x.to(torch.float32)
            amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(TINY)
            s = amax / E4M3_MAX
            return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return fp8
    raise ValueError(fmt)


def sylvester(n: int) -> torch.Tensor:
    h = torch.ones((1, 1))
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h


def block_rotation(d: int, b: int, device) -> torch.Tensor:
    """I_{d/b} (x) H_b / sqrt(b), f32."""
    hb = (sylvester(b) / math.sqrt(b)).to(device)
    return torch.block_diag(*([hb] * (d // b)))


def rotate_blocks(x: torch.Tensor, b: int) -> torch.Tensor:
    """x (I (x) H_b / sqrt(b)) over the last axis, f32."""
    d = x.shape[-1]
    hb = (sylvester(b) / math.sqrt(b)).to(x.device)
    return (x.reshape(*x.shape[:-1], d // b, b) @ hb).reshape(x.shape)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def rtn_int4(w: torch.Tensor) -> torch.Tensor:
    """Symmetric int4 round to nearest of w [K, N] (f32), one scale per
    column, searched over r * absmax / 7 for r in linspace(0.2, 1, 80)."""
    absmax = w.abs().amax(dim=0, keepdim=True).clamp_min(TINY)
    best_err = best_s = None
    for r in np.linspace(RATIO_LO, 1.0, N_RATIOS, dtype=np.float32):
        s = float(r) * absmax / 7.0
        q = torch.clamp(torch.round(w / s), -7, 7) * s
        err = ((q - w) ** 2).sum(dim=0, keepdim=True)
        if best_err is None:
            best_err, best_s = err, s
        else:
            better = err < best_err
            best_err = torch.where(better, err, best_err)
            best_s = torch.where(better, s, best_s)
    return torch.clamp(torch.round(w / best_s), -7, 7) * best_s


def grid_of(w: torch.Tensor):
    """(codes f32 in [-7, 7], scale f32 [N]) of stored weights w [K, N]: the
    grid absmax / m, m = 7..1, with the least round-trip error."""
    absmax = w.abs().amax(dim=0).clamp_min(1e-12)
    best_s = best_err = None
    for m in range(7, 0, -1):
        s = absmax / float(m)
        err = ((torch.clamp(torch.round(w / s), -7, 7) * s - w) ** 2).sum(0)
        if best_s is None:
            best_s, best_err = s, err
        else:
            better = err < best_err
            best_s = torch.where(better, s, best_s)
            best_err = torch.where(better, err, best_err)
    return torch.clamp(torch.round(w / best_s), -7, 7), best_s


class IntWeight:
    """One projection as the reference keeps it: int8 codes, f32 scale."""

    def __init__(self, w_f32: torch.Tensor, param_dtype: torch.dtype):
        stored = rtn_int4(w_f32).to(param_dtype).to(torch.float32)
        codes, self.scale = grid_of(stored)
        self.codes = codes.to(torch.int8)

    def __call__(self, q: torch.Tensor, s: torch.Tensor, z: torch.Tensor):
        """Activation codes q [M, K] (f32 integers), scale and zero [M, 1]
        -> f32 [M, N]: s_a s_w (q_a . q_w + z_a sum q_w), exact products."""
        wc = self.codes.to(torch.float32)
        acc = q @ wc
        colsum = wc.sum(dim=0, keepdim=True)
        return (s * self.scale[None]) * (acc + z * colsum)


def prepare(params: dict, spec: dict, n_layers: int) -> dict:
    """The reference's own weights of the first `n_layers` layers from the
    drawn tree `params` (the program's layout: stacked [n_layers, ...]
    leaves)."""
    pdt = DTYPES[spec["param_dtype"]]
    dev = params["embed"].device
    lay = params["layers"]
    f32 = torch.float32
    rot = block_rotation(spec["d_ff"], spec["block_size"], dev)
    layers = []
    for i in range(n_layers):
        ga = lay["attn_norm"]["scale"][i].to(f32)[:, None]
        gf = lay["ffn_norm"]["scale"][i].to(f32)[:, None]
        A, Fn = lay["attn"], lay["ffn"]
        L = {
            "wqkv": IntWeight(torch.cat([ga * A[w][i].to(f32)
                                         for w in ("wq", "wk", "wv")], 1),
                              pdt),
            "wo": IntWeight(A["wo"][i].to(f32), pdt),
            "w_gate": IntWeight(gf * Fn["w_gate"][i].to(f32), pdt),
            "w_up": IntWeight(gf * Fn["w_up"][i].to(f32), pdt),
            "w_down": IntWeight(rot.T @ Fn["w_down"][i].to(f32), pdt),
        }
        if spec["qkv_bias"]:
            L["bias"] = torch.cat([A[k][i] for k in ("bq", "bk", "bv")]) \
                .to(f32)
        layers.append(L)
    out = {"embed": params["embed"], "layers": layers}
    if n_layers == spec["n_layers"]:
        # the final norm's scale folded into the head, kept in param dtype
        g = params["final_norm"]["scale"].to(f32)[:, None]
        out["head"] = (g * params["lm_head"].to(f32)).to(pdt).to(f32)
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def quant_rows(x: torch.Tensor, levels: float = 15.0, floor: float = TINY):
    """Per-row asymmetric quantisation of x (f32) over its last axis ->
    (codes 0..levels f32, scale, zero)."""
    mn = x.amin(dim=-1, keepdim=True)
    mx = x.amax(dim=-1, keepdim=True)
    s = ((mx - mn) * recip_f32(levels)).clamp_min(floor)
    z = torch.round(mn / s)
    return torch.clamp(torch.round(x / s) - z, 0, levels), s, z


def rmsnorm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE of x [S, H, Dh] (f32) at positions pos [S]."""
    dh = x.shape[-1]
    inv = torch.from_numpy((1.0 / (theta ** (
        np.arange(0, dh, 2, dtype=np.float32) / np.float32(dh))))
        .astype(np.float32)).to(x.device)
    ang = pos[:, None].to(torch.float32) * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def int4_kv(x: torch.Tensor):
    """K or V [S, KH, Dh] as the int4 cache stores it -> (the value read
    back, f32, and the scale [S, KH, 1])."""
    q, s, z = quant_rows(x, floor=1e-6)
    return s * (q + z), s


@torch.no_grad()
def forward(ref: dict, spec: dict, tokens: torch.Tensor,
            fmt: str | None = None, follow=None, q_block: int = 1024):
    """The prepared layers over the sequence `tokens` [S]: yields per layer
    (K read back (before RoPE), V read back, K scale, V scale), f32, what
    the layer stores in the KV cache; after the last layer of a whole
    model, yields the final hidden state [S, d] (before the final norm).
    Values the configuration keeps in the compute dtype are rounded to
    `fmt` (the compute dtype by default). With `follow` (per layer, the
    K and V read back from another cache) attention reads those in place
    of the layer's own: the reference then follows that cache layer by
    layer."""
    rnd = rounder(fmt or spec["compute_dtype"])
    h_, kh, dh = spec["n_heads"], spec["n_kv_heads"], spec["head_dim"]
    eps, theta, b = spec["norm_eps"], spec["rope_theta"], spec["block_size"]
    s_len = tokens.shape[0]
    dev = tokens.device
    pos = torch.arange(s_len, device=dev)
    x = rnd(ref["embed"][tokens].to(torch.float32))
    g = h_ // kh
    scale = recip_f32(math.sqrt(dh))
    nq = h_ * dh
    for li, L in enumerate(ref["layers"]):
        hx = rnd(rmsnorm(x, eps))
        qkv = rnd(L["wqkv"](*quant_rows(hx)))
        if "bias" in L:
            qkv = rnd(qkv + rnd(L["bias"]))
        q = qkv[:, :nq].reshape(s_len, h_, dh)
        k = qkv[:, nq:nq + kh * dh].reshape(s_len, kh, dh)
        v = qkv[:, nq + kh * dh:].reshape(s_len, kh, dh)
        k, ks = int4_kv(k)
        v, vs = int4_kv(v)
        yield k, v, ks, vs
        if li == len(ref["layers"]) - 1 and "head" not in ref:
            return
        if follow is not None:
            k, v = follow[li]
        del qkv, ks, vs
        q = rnd(rope(q, pos, theta))
        kt = rope(k, pos, theta).permute(1, 0, 2)             # [KH, S, Dh]
        vt = v.permute(1, 0, 2)
        att_out = torch.empty((s_len, h_, dh), device=dev)
        for lo in range(0, s_len, q_block):
            hi = min(lo + q_block, s_len)
            qb = q[lo:hi].reshape(hi - lo, kh, g, dh).permute(1, 2, 0, 3)
            att = torch.einsum("kgqd,ksd->kgqs", qb, kt[:, :hi]) * scale
            mask = pos[None, :hi] <= pos[lo:hi, None]
            att = torch.where(mask, att, torch.full_like(att, -math.inf))
            o = torch.einsum("kgqs,ksd->kgqd", torch.softmax(att, dim=-1),
                             vt[:, :hi])
            att_out[lo:hi] = o.permute(2, 0, 1, 3).reshape(hi - lo, h_, dh)
        del q, kt, vt
        attn = rnd(att_out.reshape(s_len, nq))
        x = rnd(x + rnd(L["wo"](*quant_rows(attn))))
        hx = rnd(rmsnorm(x, eps))
        qa = quant_rows(hx)
        gate = rnd(L["w_gate"](*qa))
        up = rnd(L["w_up"](*qa))
        hid = rnd(rnd(gate * rnd(torch.sigmoid(gate))) * up)
        del gate, up, qa
        x = rnd(x + rnd(L["w_down"](*quant_rows(rotate_blocks(hid, b)))))
    yield x


@torch.no_grad()
def logits(ref: dict, spec: dict, x: torch.Tensor,
           fmt: str | None = None) -> torch.Tensor:
    """The head's logits [S, V] of final hidden states x [S, d], rounded
    to `fmt` as the configuration keeps them."""
    rnd = rounder(fmt or spec["compute_dtype"])
    return rnd(rnd(rmsnorm(x, spec["norm_eps"])) @ rnd(ref["head"]))
