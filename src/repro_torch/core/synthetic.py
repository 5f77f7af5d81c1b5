"""Synthetic outlier structure for freshly initialised weights.

A freshly initialised model has Gaussian activations with no outliers, so
there is nothing for a rotation to suppress. Real LLMs concentrate
activation mass in a few channels. This helper injects that structure - a
few systematically large norm-scale channels and a function-preserving
rescaling of sparse FFN hidden channels - so that the serving path sees
LLM-like activations without pretrained checkpoints.
"""
from __future__ import annotations

import numpy as np
import torch


def inject_outlier_channels(params, *, strength: float = 8.0,
                            strength2: float = 5.0, seed: int = 0,
                            hidden_strength: float = 16.0):
    """Create LLM-like activation outliers in a model's parameter tree
    (layer leaves stacked `[n_layers, ...]`), **in place**; returns `params`.

    Two mechanisms:
      * norm-scale outliers - a sparse set of large gamma channels (residual
        stream outliers, as observed in real LLMs);
      * FFN hidden outliers - a function-preserving reparametrisation
        w_up[:, c] <- s * w_up[:, c], w_down[c, :] <- w_down[c, :] / s for
        sparse c: the model function is unchanged, but the down-projection
        input (the online-rotation site) concentrates its l1 mass in a few
        channels.

    The channel indices and scales come from `numpy.random.default_rng(seed)`
    in a fixed order of draws, independent of the device the tensors lie on.
    """
    rng = np.random.default_rng(seed)

    def scale_vec(s: torch.Tensor):
        d = s.shape[-1]
        idx1 = rng.choice(d, size=max(1, d // 24), replace=False)
        idx2 = rng.choice(d, size=max(1, d // 32), replace=False)
        for idx, k in ((idx1, strength), (idx2, strength2)):
            i = torch.as_tensor(idx, device=s.device)
            s[..., i] = (s[..., i].to(torch.float32) * k).to(s.dtype)

    def reparam_ffn(ffn):
        if "w_up" not in ffn:
            return
        f = ffn["w_up"].shape[-1]
        idx = rng.choice(f, size=max(1, f // 16), replace=False)
        scales = rng.uniform(hidden_strength / 2, hidden_strength,
                             size=len(idx)).astype(np.float32)
        up, down = ffn["w_up"], ffn["w_down"]
        i = torch.as_tensor(idx, device=up.device)
        sc = torch.as_tensor(scales, device=up.device)
        # the gate stays unscaled: silu(g) * (s * u) = s * (silu(g) * u)
        up[..., i] = (up[..., i].to(torch.float32) * sc).to(up.dtype)
        down[..., i, :] = (down[..., i, :].to(torch.float32)
                           / sc[:, None]).to(down.dtype)

    layers = params["layers"]
    for nm in ("attn_norm", "ffn_norm", "norm"):
        if nm in layers:
            scale_vec(layers[nm]["scale"])
    if "ffn" in layers:
        reparam_ffn(layers["ffn"])
    if "moe" in layers:
        moe = layers["moe"]
        reparam_ffn(moe)
        if "shared_up" in moe:
            reparam_ffn({"w_up": moe["shared_up"],
                         "w_down": moe["shared_down"]})
    if "shared_attn" in params:
        shared = params["shared_attn"]
        for nm in ("attn_norm", "ffn_norm"):
            scale_vec(shared[nm]["scale"])
        reparam_ffn(shared["ffn"])
    scale_vec(params["final_norm"]["scale"])
    return params
