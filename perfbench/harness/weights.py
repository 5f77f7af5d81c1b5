"""Seeded bf16 weights of a configuration, drawn on the device.

The tree has the program's layout (stacked `[n_layers, ...]` leaves, the
projections stored [in, out]), so the same tensors go to the program and to
the reference. Each leaf kind is one draw for all layers. LLM-like
activation outliers are injected by a copy of the rule the program's
launcher uses: a few large norm-scale channels, and a function-preserving
rescaling of sparse FFN hidden channels (the online rotation's site). The
configuration's published scalar multipliers are folded into the weights:
the embedding multiplier into the embedding, the attention multiplier (in
place of 1/sqrt(head_dim)) into `wq`, the residual multiplier into `wo`
and `w_down`, and the logits scaling into the head. The head is the
transposed embedding table when the configuration ties them.

The program's RMSNorm has a fixed eps (`PROGRAM_NORM_EPS`). For a
configuration that publishes another, the whole residual stream is scaled
by c = sqrt(PROGRAM_NORM_EPS / eps) (folded into the embedding, `wo` and
`w_down`): RMSNorm(c x; c^2 eps) = RMSNorm(x; eps), and every layer reads
its stream only through a norm, so the run is the published model with
its published eps, up to the rounding of the scaled stream.
"""
from __future__ import annotations

import math

import numpy as np
import torch

OUTLIER_STRENGTH = (8.0, 5.0)     # norm-scale channels: d/24 at 8x, d/32 at 5x
HIDDEN_STRENGTH = 16.0            # FFN hidden channels: f/16 at U(8, 16)
EMBED_STD = 0.02
BIAS_STD = 0.02


PROGRAM_NORM_EPS = 1e-6          # the program's RMSNorm, fixed in its code


def model_dims(cfg: dict) -> dict:
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
    m = model_dims(cfg)
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
