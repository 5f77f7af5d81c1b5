"""Rotation-quality probes on served activations (MixQuant §3 quantities).

The paper's central claim is that permutation + block rotation equalizes
per-block ℓ1 mass, which controls the Prop-3.2 quantization-error bound;
DFRot's analysis predicts the interesting failure mode — massive
activations that survive rotation and saturate the int4 grid — shows up
on *real* traffic, not calibration data. These probes measure exactly
that, on the serving path, per layer:

* `l1_imbalance_pre` / `l1_imbalance_post` — max/mean blockwise ℓ1 mass
  of the activation entering the fused rotate+quantize step, before and
  after the online block-Hadamard rotation (1.0 = perfectly balanced;
  the rotation should pull this toward 1).
* `sat_rate` — fraction of int4 activation codes pinned at either end
  of the asymmetric grid (0 or 2^bits−1): code-point waste / clipping
  pressure from surviving outliers.
* `kurtosis_pre` / `kurtosis_post` — excess-free Pearson kurtosis of the
  same activation (3.0 = Gaussian). Rotations drive activations toward
  Gaussian; a post-rotation kurtosis well above 3 is the DFRot
  massive-activation signature.

Bit-path neutrality: PyTorch runs eagerly and fuses nothing, so the probe
math is a side computation on tensors the main path has already
computed; it reads them and writes none of them, and the forward's
logits are equal bit for bit with probes on and off (regression-tested).
The JAX package needs an `optimization_barrier` for the same guarantee.
The stats stay on the device: `QualityProbes.record` brings all of a
dispatch's [5, n_layers] values to the host in one transfer. Overhead
stays bounded because the scheduler samples: only every `every_k`-th
decode dispatch runs the probe variant of the forward.

Stats land in the shared `MetricsRegistry` as `quality.<stat>`
histograms (one observation per layer per probed dispatch) plus
`quality.layer<NN>.<stat>` gauges holding each layer's latest value.
"""
from __future__ import annotations

import torch

from .metrics import MetricsRegistry

PROBE_STATS = ("l1_imbalance_pre", "l1_imbalance_post", "sat_rate",
               "kurtosis_pre", "kurtosis_post")


def _block_l1_imbalance(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """max/mean of per-block ℓ1 mass, blocks along the channel axis,
    mass pooled over every token in the chunk — the Theorem-driven
    balance quantity (1.0 = equalized)."""
    d = x.shape[-1]
    mass = x.abs().reshape(-1, d // block_size, block_size).sum(dim=(0, 2))
    return mass.max() / torch.clamp_min(mass.mean(), 1e-12)


def _kurtosis(x: torch.Tensor) -> torch.Tensor:
    """Pearson kurtosis pooled over all elements (3.0 = Gaussian)."""
    x = x.reshape(-1)
    dev = x - x.mean()
    var = torch.clamp_min(torch.square(dev).mean(), 1e-24)
    return torch.square(torch.square(dev)).mean() / torch.square(var)


def activation_probe_stats(pre: torch.Tensor, post: torch.Tensor,
                           codes: torch.Tensor, *, bits: int,
                           block_size: int) -> dict[str, torch.Tensor]:
    """Per-layer probe scalars (0-d f32 tensors on the inputs' device) from
    one fused rotate+quantize site.

    `pre` is the activation entering the rotation, `post` the rotated
    activation, `codes` the asymmetric integer codes the main path
    actually dispatched (range [0, 2^bits−1]). The inputs are only read.
    """
    pre = pre.to(torch.float32)
    post = post.to(torch.float32)
    levels = 2 ** bits - 1
    return {
        "l1_imbalance_pre": _block_l1_imbalance(pre, block_size),
        "l1_imbalance_post": _block_l1_imbalance(post, block_size),
        "sat_rate": ((codes == 0) | (codes == levels)).to(torch.float32)
        .mean(),
        "kurtosis_pre": _kurtosis(pre),
        "kurtosis_post": _kurtosis(post),
    }


class QualityProbes:
    """Sampling policy + registry sink for the activation probes.

    Construct with the sampling period and hand to
    `ServeEngine(quality_probes=...)`; the engine binds its registry and
    asks `should_probe()` once per decode dispatch — every `every_k`-th
    one (the first included) runs the probe variant of the forward, whose
    per-layer stats arrive at `record()`.
    """

    def __init__(self, every_k: int = 8):
        if every_k < 1:
            raise ValueError("every_k must be >= 1")
        self.every_k = every_k
        self._registry: MetricsRegistry | None = None
        self._dispatches = 0

    def bind(self, registry: MetricsRegistry):
        self._registry = registry

    def reset(self):
        self._dispatches = 0

    def should_probe(self) -> bool:
        n = self._dispatches
        self._dispatches += 1
        return n % self.every_k == 0

    def record(self, stats: dict[str, torch.Tensor]):
        """`stats`: name → [n_layers] tensor (the per-layer scalars,
        stacked). The values reach the host in one transfer; each layer's
        value feeds the pooled histogram and its own latest-value gauge."""
        if self._registry is None:
            raise RuntimeError("QualityProbes.record before bind()")
        reg = self._registry
        reg.counter("quality.probe_dispatches").inc()
        names = list(stats)
        host = torch.stack([torch.as_tensor(stats[n]).reshape(-1)
                            for n in names]).cpu().double().numpy()
        for name, vals in zip(names, host):
            hist = reg.histogram(f"quality.{name}")
            for layer, v in enumerate(vals):
                v = float(max(v, 0.0))
                hist.observe(v)
                reg.gauge(f"quality.layer{layer:02d}.{name}").set(v)
