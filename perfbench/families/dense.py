"""The dense family: a decoder of GQA/MHA attention and a SwiGLU FFN in every
layer, served on the program's W4A4 integer path as its launcher builds it
(`launch/serve.py --integer-path --preset rtn_only`), and checked against
the plain reference `perfbench/reference/w4a4.py`.

A family module is found by the `family` key of a configuration file
(`harness/spec.py::family`) and gives the harness:

  dims(cfg)             the sizes a run needs, by the harness's names; the
                        general code reads `n_layers` and `vocab`
  draw(cfg, seed, device)
                        the seeded weights on the device
  build(cfg, dims, params, seed, device)
                        the program's servable model (`as_servable`) from
                        the drawn weights, which it may free
  held(engine, req, n_layers)
                        what the program's state holds for a request, as
                        copies, for the check
  numbers(cfg, seed, device, held, limits, control=False)
                        every number of the check over the held requests,
                        the reference's (with `control`, the control's);
                        `positions`: the cached positions compared
  step_work(dims, step) the counted work of one engine step (a
                        `harness.cell.StepRecord`) by class: `proj`, `attn`,
                        `head`, each (ops, bytes, bound seconds), and
                        `ideal_s`
  KERNELS               (optional) hand-written kernel groups of the
                        program's, by device symbol, added to
                        `harness/trace.py::HAND_WRITTEN`

Weights. The tree has the program's layout (stacked `[n_layers, ...]`
leaves, the projections stored [in, out]), so the same tensors go to the
program and to the reference. Each leaf kind is one draw for all layers.
LLM-like activation outliers are injected by a copy of the rule the
program's launcher uses: a few large norm-scale channels, and a
function-preserving rescaling of sparse FFN hidden channels (the online
rotation's site). The configuration's published scalar multipliers are
folded into the weights: the embedding multiplier into the embedding, the
attention multiplier (in place of 1/sqrt(head_dim)) into `wq`, the residual
multiplier into `wo` and `w_down`, and the logits scaling into the head.
The head is the transposed embedding table when the configuration ties
them. The program's RMSNorm has a fixed eps (`PROGRAM_NORM_EPS`). For a
configuration that publishes another, the whole residual stream is scaled
by c = sqrt(PROGRAM_NORM_EPS / eps) (folded into the embedding, `wo` and
`w_down`): RMSNorm(c x; c^2 eps) = RMSNorm(x; eps), and every layer reads
its stream only through a norm, so the run is the published model with its
published eps, up to the rounding of the scaled stream.

The check. The random W4A4 model is chaotic: a rounding that differs in the
last bit between the program's kernels and the reference flips an int4
code, and the flip spreads to every row that attends to it and to every
layer after it. So the reference follows the program's cache: at each
layer its attention reads the K and V the program stored for every earlier
position (the program's state), and each layer's own K and V, which it
works out from the tokens through every layer before, are compared with
the program's. Rows still part, each as a whole, at a rate the seed sets:
at layer 1 a parted row stays within about two steps of the reference
while a row computed in a lower precision does not, so layer 1 is compared
past `steps`; deeper, parted rows read like the control (`PERF.md`
section 2). The numbers, each under a limit of
`perfbench/limits/<cell>.json`:

  kv_mismatch.layer0    share of layer 0's K and V elements the program
                        stores off the reference's by more than half a
                        quantisation step
  kv_far.layer1         share of layer 1's K and V elements off by more
                        than `steps` quantisation steps
  head_rank.median      median over the served tokens of the share of the
                        vocabulary the reference's logits put above the
                        served token (the reference after every layer,
                        following the program's cache): 0 where the token
                        is the reference's greedy choice

The control is the reference in fp8 in the program's place: its own cache,
and at each position the token its fp8 logits put first.

Work, per layer (`harness/counts.py` holds the peaks and the general
counts): the projections are four items, Q, K and V one (one input), `wo`,
gate and up one (one input), and `w_down`; attention in every layer; the
head on every row whose logits are used.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from perfbench.harness import counts

OUTLIER_STRENGTH = (8.0, 5.0)     # norm-scale channels: d/24 at 8x, d/32 at 5x
HIDDEN_STRENGTH = 16.0            # FFN hidden channels: f/16 at U(8, 16)
EMBED_STD = 0.02
BIAS_STD = 0.02


PROGRAM_NORM_EPS = 1e-6          # the program's RMSNorm, fixed in its code


def dims(cfg: dict) -> dict:
    """The sizes a run needs, by the names the harness uses. `norm_eps` is
    the eps the scaled stream's norms use (the published one times the
    square of `stream_scale`), in f32."""
    eps = float(cfg["rms_norm_eps"])
    scale = math.sqrt(PROGRAM_NORM_EPS / eps)
    return {
        "n_layers": cfg["num_hidden_layers"],
        "d_model": cfg["hidden_size"],
        "d_ff": cfg["intermediate_size"],
        "n_heads": cfg["num_attention_heads"],
        "n_kv_heads": cfg["num_key_value_heads"],
        "head_dim": cfg["head_dim"],
        "vocab": cfg["vocab_size"],
        "qkv_bias": bool(cfg["attention_bias"]),
        "rope_theta": float(cfg["rope_theta"]),
        "rms_norm_eps": eps,
        "stream_scale": scale,
        "norm_eps": float(np.float32(eps * scale * scale)),
        "param_dtype": cfg["torch_dtype"],
        "compute_dtype": cfg["torch_dtype"],
        "block_size": cfg["quantization"]["block_size"],
        "kv_bits": cfg["quantization"]["kv_bits"],
    }


# -- weights ---------------------------------------------------------------

def _normal(gen, shape, std, dtype):
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def inject_outliers(params: dict, rng: np.random.Generator):
    """The outlier rule, in place, from `rng` in a fixed order of draws."""
    def scale_vec(s):
        d = s.shape[-1]
        for count, k in ((max(1, d // 24), OUTLIER_STRENGTH[0]),
                         (max(1, d // 32), OUTLIER_STRENGTH[1])):
            i = torch.as_tensor(rng.choice(d, size=count, replace=False),
                                device=s.device)
            s[..., i] = (s[..., i].to(torch.float32) * k).to(s.dtype)

    lay = params["layers"]
    scale_vec(lay["attn_norm"]["scale"])
    scale_vec(lay["ffn_norm"]["scale"])
    up, down = lay["ffn"]["w_up"], lay["ffn"]["w_down"]
    f = up.shape[-1]
    idx = rng.choice(f, size=max(1, f // 16), replace=False)
    sc = rng.uniform(HIDDEN_STRENGTH / 2, HIDDEN_STRENGTH,
                     size=len(idx)).astype(np.float32)
    i = torch.as_tensor(idx, device=up.device)
    s = torch.as_tensor(sc, device=up.device)
    up[..., i] = (up[..., i].to(torch.float32) * s).to(up.dtype)
    down[..., i, :] = (down[..., i, :].to(torch.float32)
                       / s[:, None]).to(down.dtype)
    scale_vec(params["final_norm"]["scale"])


@torch.no_grad()
def draw(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights for `seed` on `device`."""
    m = dims(cfg)
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        m["param_dtype"]]
    n, d, f = m["n_layers"], m["d_model"], m["d_ff"]
    h, kv, dh, v = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["vocab"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    emb_mul = float(cfg.get("embedding_multiplier", 1.0))
    att_mul = float(cfg.get("attention_multiplier", 1.0 / math.sqrt(dh)))
    stream = m["stream_scale"]
    res_mul = float(cfg.get("residual_multiplier", 1.0)) * stream
    logit_div = float(cfg.get("logits_scaling", 1.0))
    table = _normal(gen, (v, d), EMBED_STD, torch.float32)
    attn = {
        "wq": _normal(gen, (n, d, h * dh),
                      d ** -0.5 * att_mul * math.sqrt(dh), dt),
        "wk": _normal(gen, (n, d, kv * dh), d ** -0.5, dt),
        "wv": _normal(gen, (n, d, kv * dh), d ** -0.5, dt),
        "wo": _normal(gen, (n, h * dh, d), (h * dh) ** -0.5 * res_mul, dt),
    }
    if m["qkv_bias"]:
        attn["bq"] = _normal(gen, (n, h * dh), BIAS_STD, dt)
        attn["bk"] = _normal(gen, (n, kv * dh), BIAS_STD, dt)
        attn["bv"] = _normal(gen, (n, kv * dh), BIAS_STD, dt)
    ffn = {
        "w_gate": _normal(gen, (n, d, f), d ** -0.5, dt),
        "w_up": _normal(gen, (n, d, f), d ** -0.5, dt),
        "w_down": _normal(gen, (n, f, d), f ** -0.5 * res_mul, dt),
    }
    ones = torch.ones((n, d), dtype=dt, device=device)
    params = {
        "embed": (table * (emb_mul * stream)).to(dt),
        "layers": {"attn_norm": {"scale": ones.clone()},
                   "attn": attn,
                   "ffn_norm": {"scale": ones},
                   "ffn": ffn},
        "final_norm": {"scale": torch.ones((d,), dtype=dt, device=device)},
    }
    if cfg.get("tie_word_embeddings", False):
        params["lm_head"] = (table.T / logit_div).to(dt).contiguous()
    else:
        params["lm_head"] = _normal(gen, (d, v), d ** -0.5 / logit_div, dt)
    del table
    inject_outliers(params, np.random.default_rng([seed, 1]))
    return params


def calibration_tokens(cfg: dict, seed: int, shape=(4, 128)) -> torch.Tensor:
    """The PTQ's calibration batch (unused by round-to-nearest, which the
    pipeline still runs through its calibration forward)."""
    rng = np.random.default_rng([seed, 2])
    return torch.from_numpy(rng.integers(0, cfg["vocab_size"], shape))


# -- the program -----------------------------------------------------------

def arch_config(cfg: dict):
    """The program's `ArchConfig` of a configuration file: the registry's
    entry with every size the file gives."""
    from repro_torch.configs.registry import get_config
    m = dims(cfg)
    return dataclasses.replace(
        get_config(cfg["arch_id"]), n_layers=m["n_layers"],
        d_model=m["d_model"], vocab=m["vocab"], n_heads=m["n_heads"],
        n_kv_heads=m["n_kv_heads"], head_dim=m["head_dim"], d_ff=m["d_ff"],
        qkv_bias=m["qkv_bias"], rope_theta=m["rope_theta"],
        param_dtype=m["param_dtype"],
        compute_dtype=m["compute_dtype"]).validate()


def build(cfg: dict, dims: dict, params: dict, seed: int, device):
    """`core.pipeline.quantize_model` (the configuration's preset at its
    block size), `serve.quantized.pack_dense_params`, `QuantizedDenseLM`
    with the configuration's KV pages, `serve.engine.as_servable`."""
    from repro_torch.core import pipeline as PL
    from repro_torch.models.transformer import build_model
    from repro_torch.serve.engine import as_servable
    from repro_torch.serve.quantized import (QuantizedDenseLM,
                                             pack_dense_params)
    acfg = arch_config(cfg)
    res = PL.quantize_model(
        build_model(acfg), params,
        [{"tokens": calibration_tokens(cfg, seed).to(device)}],
        PL.preset(cfg["quantization"]["preset"],
                  block_size=dims["block_size"]))
    del params
    qlm = QuantizedDenseLM(acfg, block_size=dims["block_size"],
                           kv_bits=dims["kv_bits"])
    return as_servable(qlm, pack_dense_params(res.params, acfg))


def held(engine, req, n_layers: int) -> dict:
    """What the program's pool holds for request `req`: its token stream,
    its prompt's length and, for each of the first `n_layers` layers, K
    and V read back (scale * (code + offset + zero), K before RoPE), as
    copies."""
    n = req.n_cached
    kv = engine.kv.state["kv"]
    pages = torch.tensor(engine.kv.tables[req.rid], dtype=torch.int64,
                         device=kv["k"].device)
    off = float(2 ** (engine.adapter.qlm.kv_bits - 1))

    def rows(leaf, l):
        t = kv[leaf][l][pages]
        return t.reshape(-1, *t.shape[2:])[:n].to(torch.float32)

    return {"tokens": (list(req.prompt) + list(req.generated))[:n],
            "prompt_len": len(req.prompt),
            "layers": [tuple(rows(f"{x}_scale", l)
                             * (rows(x, l) + off + rows(f"{x}_zero", l))
                             for x in ("k", "v"))
                       for l in range(n_layers)]}


# -- the check -------------------------------------------------------------

class _Tally:
    """Elements of each layer's K and V off the reference's by more than
    a number of quantisation steps, and elements."""

    def __init__(self):
        self.n: dict = {}

    def add(self, l: int, steps: float, got: tuple, want: tuple):
        k, v, ks, vs = want
        c = self.n.setdefault((l, steps), [0, 0])
        for g, r, sc in ((got[0], k, ks), (got[1], v, vs)):
            c[0] += int(((g - r).abs() > steps * sc).sum())
            c[1] += g.numel()

    def share(self, l: int, steps: float) -> float:
        bad, n = self.n.get((l, steps), (0, 0))
        return bad / n if n else float("inf")


def _served_ranks(ref, spec, x, picked, first: int) -> torch.Tensor:
    """Share of the vocabulary the reference's logits put above each token
    picked after positions first .. S-2 (`picked[p]` follows position p),
    from final hidden states x [S, d]."""
    from perfbench.reference import w4a4
    out = []
    for lo in range(first, x.shape[0] - 1, 512):
        hi = min(lo + 512, x.shape[0] - 1)
        lg = w4a4.logits(ref, spec, x[lo:hi])
        got = lg.gather(1, picked[lo:hi, None])
        out.append((lg > got).sum(dim=-1) / lg.shape[-1])
    return torch.cat(out) if out else torch.empty(0, device=x.device)


@torch.no_grad()
def numbers(cfg: dict, seed: int, device, held: list[dict], lim,
            control: bool = False) -> dict:
    """Every number of the check over the held requests; with `control`,
    of the fp8 reference in the program's place instead."""
    from perfbench.reference import w4a4
    spec = dims(cfg)
    n_held = len(held[0]["layers"])
    params = draw(cfg, seed, device)
    ref = w4a4.prepare(params, spec, n_held)
    del params
    has_head = "head" in ref
    tally = _Tally()
    compared = [(name, min(l, n_held - 1), steps)
                for name, l, steps, _ in lim.kv]
    ranks = []
    for h in held:
        toks = torch.tensor(h["tokens"], dtype=torch.int64, device=device)
        first = max(h["prompt_len"] - 1, 0)
        if control:
            own = list(w4a4.forward(ref, spec, toks, fmt="fp8"))
            x_own = own.pop() if has_head else None
            kv = [o[:2] for o in own]
            picked = None if lim.head_rank is None else \
                w4a4.logits(ref, spec, x_own, fmt="fp8").argmax(-1)
            del own, x_own
        else:
            kv = h["layers"]
            picked = toks[1:]
        out = list(w4a4.forward(ref, spec, toks, follow=kv))
        x = out.pop() if has_head else None
        for _, l, steps in compared:
            tally.add(l, steps, kv[l], out[l])
        if lim.head_rank is not None and first < len(h["tokens"]) - 1:
            ranks.append(_served_ranks(ref, spec, x, picked, first))
        del out, x, kv
    res = {name: tally.share(l, steps) for name, l, steps in compared}
    res["positions"] = sum(len(h["tokens"]) for h in held)
    if lim.head_rank is not None:
        r = torch.cat(ranks) if ranks else torch.empty(0)
        res["head_rank.median"] = float(r.median()) if r.numel() \
            else float("inf")
        res["served_tokens"] = int(r.numel())
    return res


# -- work ------------------------------------------------------------------

def projection_items(dims: dict) -> list[tuple[int, int]]:
    """(K, N) of each projection item of one layer."""
    d, f = dims["d_model"], dims["d_ff"]
    h, kv, dh = dims["n_heads"], dims["n_kv_heads"], dims["head_dim"]
    return [(d, (h + 2 * kv) * dh),        # q, k, v: one input
            (h * dh, d),                   # wo
            (d, 2 * f),                    # gate, up: one input
            (f, d)]                        # w_down


def step_work(dims: dict, step) -> dict:
    """Work of one engine step (a `StepRecord`): per class (ops, bytes,
    bound seconds), and the ideal seconds of each class at its peak."""
    layers = dims["n_layers"]
    decode = step.decode_ctx
    chunks = step.chunks
    rows = len(decode) + sum(r for _, r, _ in chunks)
    # the step's rows need every weight once, however they are batched
    proj = list(counts.projection_work(projection_items(dims), rows,
                                       layers)) if rows else [0.0] * 3
    attn = [0.0, 0.0, 0.0]
    for c in decode:
        for i, v in enumerate(counts.attention_work(dims, c - 1, 1, layers)):
            attn[i] += v
    for s, r, _ in chunks:
        for i, v in enumerate(counts.attention_work(dims, s, r, layers)):
            attn[i] += v
    used = len(decode) + sum(1 for _, _, last in chunks if last)
    head = list(counts.head_work(dims, used)) if used else [0.0] * 3
    return {
        "proj": proj, "attn": attn, "head": head,
        "ideal_s": proj[0] / counts.INT8_OPS_PER_S
        + (attn[0] + head[0]) / counts.BF16_FLOPS_PER_S,
    }
