"""Quickstart: the PeRQ pipeline on a small LM in ~30 lines of API.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from ..configs.registry import get_config
from ..core import pipeline as PL
from ..core.synthetic import inject_outlier_channels
from ..models.transformer import build_model


def main(device="cuda") -> float:
    # 1. a model (reduced() for a seconds-long run)
    cfg = get_config("llama3-1b").reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = inject_outlier_channels(model.init(gen))

    # 2. calibration data (here random tokens; real runs use the data
    # pipeline)
    rng = np.random.default_rng(1)
    calib = [{"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (4, 128))).to(device)}]

    # 3. quantize: PeRQ* = MassDiff + QuaRot rotations + block-Hadamard R3
    # + Qronos
    result = PL.quantize_model(model, params, calib, PL.preset("perq_star"))

    # 4. run the quantized model (W4A4, online block rotation at the down
    # projection)
    qmodel = PL.build_quantized_model(model, result)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 64))).to(device)}
    logits_fp = model.forward(params, batch)
    logits_q = qmodel.forward(result.params, batch)

    err = float(torch.mean((logits_q - logits_fp) ** 2)
                / torch.mean(logits_fp ** 2))
    print(f"relative output MSE after INT4 W4A4 PeRQ*: {err:.4f}")
    print("per-layer max-block l1 mass before -> after MassDiff:")
    for i, e in enumerate(result.report["per_layer"][:4]):
        print(f"  layer {i}: {e['max_block_l1_before']:.2f} -> "
              f"{e['max_block_l1_after']:.2f}")
    return err


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
