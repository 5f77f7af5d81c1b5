"""Figure 3: mass concentration δ vs outlier suppression ratio, on real
(trained-model) activations vs per-token-fitted Gaussian/Laplace samples.

Claims checked: (1) suppression occurs for almost all tokens even when the
sufficient condition δ < 1/√d fails; (2) δ correlates strongly with the
suppression ratio; (3) fitted-distribution δ's differ from the real ones.

    PYTHONPATH=src python -m repro_torch.paper.fig3_delta [--device cpu]
"""
import argparse

import numpy as np
import torch

from ..core import bounds
from ..core.hadamard import hadamard_transform
from ..core.pipeline import _Capture
from ..models.transformer import build_model
from .common import add_bench_args, bench_from_args, bench_model, calib_batches


def collect_down_activations(bench=None) -> torch.Tensor:
    """The third (or last) layer's down-projection input over one
    calibration batch, [tokens, d_ff] f32 on the surrogate's device."""
    cfg, model, params, corpus = bench or bench_model()
    cap = _Capture()
    cmodel = build_model(cfg, quant_hooks=cap.hooks())
    for b in calib_batches(corpus, cfg, n=1,
                           device=params["lm_head"].device):
        cap.reset_forward()
        cmodel.forward(params, b)
    return cap.get("down", min(2, cfg.n_layers - 1))


def run(bench=None):
    x = collect_down_activations(bench)[:1024]
    d = x.shape[-1]
    delta = bounds.mass_concentration(x).cpu().numpy()
    ratio = bounds.suppression_ratio(x, hadamard_transform(x)).cpu().numpy()
    corr = float(np.corrcoef(delta, ratio)[0, 1])
    suppressed = float((ratio < 1.0).mean())

    # per-token fitted Gaussian / Laplace surrogates
    rng = np.random.default_rng(0)
    xn = x.cpu().numpy()
    mu, sd = xn.mean(-1, keepdims=True), xn.std(-1, keepdims=True)
    bscale = np.abs(xn - np.median(xn, -1, keepdims=True)).mean(-1,
                                                                keepdims=True)
    gauss = rng.normal(mu, sd, xn.shape).astype(np.float32)
    lap = rng.laplace(np.median(xn, -1, keepdims=True), bscale,
                      xn.shape).astype(np.float32)
    d_gauss = bounds.mass_concentration(torch.from_numpy(gauss)).numpy()
    d_lap = bounds.mass_concentration(torch.from_numpy(lap)).numpy()
    return {
        "d": d, "suff_threshold": d ** -0.5,
        "delta_mean": float(delta.mean()),
        "delta_p05": float(np.quantile(delta, .05)),
        "ratio_mean": float(ratio.mean()), "frac_suppressed": suppressed,
        "corr_delta_ratio": corr,
        "delta_gauss_mean": float(d_gauss.mean()),
        "delta_laplace_mean": float(d_lap.mean()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_bench_args(ap)
    r = run(bench_from_args(ap.parse_args(argv)))
    print("# Fig3 surrogate")
    for k, v in r.items():
        print(f"{k},{v}")
    print(f"holds_frac_suppressed_above_0.95,{r['frac_suppressed'] > 0.95}")
    print(f"holds_corr_above_0.5,{r['corr_delta_ratio'] > 0.5}")
    return r


if __name__ == "__main__":
    main()
