"""Shared harness of the paper's tables and figures.

The paper evaluates on pretrained LLMs; offline the repo (a) trains a small
llama3-family LM on a synthetic Markov-Zipf corpus until its perplexity is
well below uniform, (b) injects LLM-like outlier channels, then (c) runs
the PTQ pipelines and reports perplexity on held-out data. The paper's
claims checked here are orderings and monotonicities (the trends of Tables
1, 2, 5 and 6), which its theory derives independently of model scale.

The trained surrogate is cached under `artifacts/bench_model_torch/` (or
`cache_dir`). Every entry point runs on `device` ("cuda" unless the caller
asks for the CPU); batches are drawn with numpy, as in the JAX package, and
moved there.
"""
from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.registry import get_config
from ..core import pipeline as PL
from ..core.synthetic import inject_outlier_channels
from ..data.pipeline import DataConfig, SyntheticCorpus, batch_iterator
from ..models.transformer import build_model
from ..optim import adamw
from ..train.step import TrainConfig, make_train_step

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts")
CACHE_DIR = os.path.join(ART, "bench_model_torch")

BENCH_CFG = dict(n_layers=4, d_model=128, vocab=512, n_heads=4, n_kv_heads=2,
                 head_dim=32, d_ff=256)
TRAIN_STEPS = 300
SEQ, BATCH = 64, 16
# the surrogate's optimizer, as the reference trains it
LR, WARMUP = 3e-3, 20


def to_device(batch: dict, device) -> dict:
    """A numpy batch -> the same dict of tensors on `device`."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def bench_model(train_steps: int = TRAIN_STEPS, *, seed: int = 0,
                refresh: bool = False, device="cuda",
                cache_dir: str | None = None):
    """Returns (cfg, model, trained_params, corpus), the params on
    `device` with the outlier channels injected. Trained once and cached
    on disk; `refresh=True` trains again."""
    cfg = get_config("llama3-1b").reduced(**BENCH_CFG)
    model = build_model(cfg)
    corpus = SyntheticCorpus(cfg.vocab, seed=seed)
    mgr = CheckpointManager(cache_dir or CACHE_DIR, keep=1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = model.init(gen)
    if not refresh and mgr.latest_step() == train_steps:
        params = mgr.restore(target={"params": params})["params"]
    else:
        opt_cfg = adamw.AdamWConfig(lr=LR, warmup_steps=WARMUP,
                                    total_steps=train_steps)
        step = make_train_step(model, opt_cfg, TrainConfig(remat=False))
        opt = adamw.init_state(opt_cfg, params)
        it = batch_iterator(corpus, DataConfig(cfg.vocab, SEQ, BATCH,
                                               seed=seed))
        for _ in range(train_steps):
            params, opt, _ = step(params, opt, to_device(next(it), device))
        mgr.save(train_steps, {"params": params}, blocking=True)
    # function-preserving hidden-channel reparametrization only: the model
    # is numerically unchanged, but the down-projection inputs (the
    # paper's R3 site) now concentrate l1 mass like trained LLMs do
    params = inject_outlier_channels(params, strength=1.0, strength2=1.0,
                                     hidden_strength=24.0, seed=seed)
    return cfg, model, params, corpus


def add_bench_args(ap: argparse.ArgumentParser):
    """The options every surrogate harness takes: where it runs, and how
    the surrogate is trained and cached."""
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train-steps", type=int, default=TRAIN_STEPS)
    ap.add_argument("--cache-dir", default=None)


def bench_from_args(args: argparse.Namespace):
    return bench_model(args.train_steps, device=args.device,
                       cache_dir=args.cache_dir)


def eval_ppl(model, params, corpus, *, hooks=None, n_batches: int = 8,
             seed: int = 1234) -> float:
    """Held-out perplexity, on the parameters' device."""
    m = build_model(model.cfg, quant_hooks=hooks) if hooks else model
    dev = params["lm_head"].device
    it = batch_iterator(corpus, DataConfig(model.cfg.vocab, SEQ, BATCH,
                                           seed=seed))
    total = 0.0
    with torch.no_grad():
        for _ in range(n_batches):
            total += float(m.loss_fn(params, to_device(next(it), dev))[1]["nll"])
    return math.exp(total / n_batches)


def calib_batches(corpus, cfg, n: int = 2, seed: int = 77, device="cuda"):
    it = batch_iterator(corpus, DataConfig(cfg.vocab, 128, 8, seed=seed))
    return [to_device(next(it), device) for _ in range(n)]


def quantize_and_eval(model, params, corpus, ptq_cfg: PL.PTQConfig,
                      n_eval: int = 8) -> float:
    cal = calib_batches(corpus, model.cfg, device=params["lm_head"].device)
    res = PL.quantize_model(model, params, cal, ptq_cfg)
    return eval_ppl(model, res.params, corpus, hooks=res.hooks,
                    n_batches=n_eval)


def ragged_paged_batch(batch: int, max_len: int, page_size: int):
    """The shared ragged decode workload of the paged-attention benches
    (`bench.kernel_bench`, `bench.serve_bench`).

    Lengths span 25%..100% of `max_len`; each sequence gets distinct
    sequential page ids in a `[batch, max_len/page_size]` table padded
    with the scratch page, and queries sit at the last position. Returns
    (lengths, n_pages, block_table rows, qpos rows) as plain Python/numpy
    so both benches build identical tables and their pages-walked rows
    stay comparable.
    """
    lengths = [max(1, int(max_len * f))
               for f in np.linspace(0.25, 1.0, batch)]
    n_cols = -(-max_len // page_size)
    n_pages = 1 + sum(-(-n // page_size) for n in lengths)
    ids = list(range(1, n_pages))
    table = [[ids.pop(0) for _ in range(-(-n // page_size))]
             + [0] * (n_cols - -(-n // page_size)) for n in lengths]
    qpos = [[n - 1] for n in lengths]
    return lengths, n_pages, table, qpos
