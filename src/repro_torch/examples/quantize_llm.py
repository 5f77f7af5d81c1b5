"""End-to-end driver: TRAIN a small LM on the synthetic corpus (with
checkpointing + the fault-tolerant driver), then post-training-quantize it
with each of six pipelines and compare perplexities — the paper's
Table-1/2 protocol compressed into one script.

    PYTHONPATH=src python -m repro_torch.examples.quantize_llm \\
        [--steps 300] [--eval-batches 8] [--workdir DIR] [--device cpu]

The surrogate is llama3's family at 4 layers, d_model 128, vocab 512, f32,
its parameters drawn from a generator seeded with 0 on `--device`.
`main(argv)` returns the bf16 perplexity and each pipeline's.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.registry import get_config
from ..core import pipeline as PL
from ..data.pipeline import (DataConfig, Prefetcher, SyntheticCorpus,
                             batch_iterator)
from ..launch.train import on_device
from ..models.transformer import build_model
from ..optim import adamw
from ..runtime.driver import RuntimeConfig, TrainDriver
from ..train.step import TrainConfig, make_train_step

SURROGATE = dict(n_layers=4, d_model=128, vocab=512, n_heads=4, n_kv_heads=2,
                 head_dim=32, d_ff=256)
PIPELINES = ["rtn_only", "mr_rtn", "mr_qronos", "perq_star", "perq_dagger",
             "quarot"]


def surrogate(device):
    """(cfg, model, freshly drawn params on `device`, corpus)."""
    cfg = get_config("llama3-1b").reduced(**SURROGATE)
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return cfg, model, model.init(gen), SyntheticCorpus(cfg.vocab, seed=0)


def train(model, params, corpus, steps: int, workdir: str, device):
    """`steps` AdamW steps through the fault-tolerant driver, with
    checkpoints under `workdir`; returns the trained params."""
    cfg = model.cfg
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=steps)
    opt = adamw.init_state(opt_cfg, params)
    step = make_train_step(model, opt_cfg, TrainConfig(remat=False))
    mgr = CheckpointManager(os.path.join(workdir, "ckpt"), keep=2)
    mgr.save(0, {"params": params, "opt": opt}, blocking=True)
    driver = TrainDriver(step, mgr, RuntimeConfig(checkpoint_every=100))
    it = Prefetcher(batch_iterator(corpus, DataConfig(cfg.vocab, 64, 16)))
    try:
        (params, opt), _ = driver.run(params, opt, on_device(it, device),
                                      num_steps=steps)
    finally:
        it.close()
    return params


def ppl(model, params, corpus, n_batches: int, hooks=None) -> float:
    """Held-out perplexity on `n_batches` [16, 64] batches (seed 999)."""
    cfg = model.cfg
    m = build_model(cfg, quant_hooks=hooks) if hooks else model
    dev = params["lm_head"].device
    eit = on_device(batch_iterator(corpus, DataConfig(cfg.vocab, 64, 16,
                                                      seed=999)), dev)
    with torch.no_grad():
        tot = sum(float(m.loss_fn(params, next(eit))[1]["nll"])
                  for _ in range(n_batches))
    return math.exp(tot / n_batches)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.quantize_llm")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg, model, params, corpus = surrogate(device)

    # ---- train (fault-tolerant driver + checkpoints) ----
    workdir = args.workdir or tempfile.mkdtemp(prefix="perq_example_")
    print(f"training {args.steps} steps → {workdir}")
    params = train(model, params, corpus, args.steps, workdir, device)

    # ---- evaluate fp baseline ----
    fp_ppl = ppl(model, params, corpus, args.eval_batches)
    print(f"\nbf16 perplexity: {fp_ppl:.3f}")

    # ---- PTQ across pipelines ----
    cit = on_device(batch_iterator(corpus, DataConfig(cfg.vocab, 128, 8,
                                                      seed=77)), device)
    calib = [next(cit) for _ in range(2)]
    print(f"{'pipeline':14s} {'ppl':>9s} {'vs bf16':>9s}")
    out = {"bf16": fp_ppl, "ppl": {}}
    for name in PIPELINES:
        res = PL.quantize_model(model, params, calib,
                                PL.preset(name, cayley_steps=8))
        q = ppl(model, res.params, corpus, args.eval_batches,
                hooks=res.hooks)
        out["ppl"][name] = q
        print(f"{name:14s} {q:9.3f} {q / fp_ppl:9.2f}x")
    return out


if __name__ == "__main__":
    main()
