"""Training launcher CLI.

    python -m repro_torch.launch.train --arch llama3-1b --reduced \\
        --steps 200 --batch 16 --seq 64 --workdir /tmp/run1 [--device cpu]

Runs the fault-tolerant driver (retries, periodic checkpoints, straggler
EWMA) over the synthetic or file-backed corpus, on a CUDA device by default
(`--device cpu` for a CPU run; with `--device cuda` and no card it exits
non-zero). The parameters are drawn from a generator seeded with 0 on the
device. A workdir that holds a checkpoint (the port's or the JAX
launcher's: the file format is shared) is resumed from its latest step;
otherwise step 0 is saved first. Under an initialised `torch.distributed`
process group of several ranks the run takes a ("data", "model") mesh of
them and trains data-parallel: each rank takes `cuda:rank % cards`, draws
its own share of the data and holds the whole parameters (with a model
extent of 1 every parameter's spec replicates it over the data axis), the
step averages the gradients over the data axis, and rank 0 writes the
checkpoints. Tensor-parallel (`--model-parallel` > 1) and ZeRO-3 parameter
sharding are not ported: the launcher refuses them. On one device with
`--model-parallel 1` there is no mesh.

It prints `resumed from step N` when it resumes, `step S  ewma E ms
stragglers K` every 20 steps and `finished at step N; failures=F
restores=R` at the end. `main(argv)` returns the driver, the final state
and step.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.registry import ARCH_IDS, get_config
from ..data.pipeline import (ByteCorpus, DataConfig, Prefetcher,
                             SyntheticCorpus, batch_iterator)
from ..distributed import shardings as SH
from ..distributed.context import mesh_context, rank_and_world
from ..models.transformer import build_model
from ..optim import adamw
from ..runtime.driver import ElasticMesh, RuntimeConfig, TrainDriver
from ..train.step import TrainConfig, make_train_step


def on_device(batches, device):
    """The numpy batches of `batches`, as tensors on `device`."""
    for batch in batches:
        yield {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="llama3-1b", choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--corpus", default=None,
                    help="path to a byte corpus (default: synthetic)")
    ap.add_argument("--workdir", default="/tmp/repro_train")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--model-parallel", type=int, default=1)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu for a CPU run)")
    rank, world = rank_and_world()
    device = torch.device(args.device)
    if args.device == "cuda" and world > 1:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)

    mesh = None
    if args.model_parallel > 1 or world > 1:
        mesh = ElasticMesh(args.model_parallel).make(device_type=device.type)
        if mesh.shape["model"] > 1 or cfg.name in SH.ZERO3_ARCHS:
            raise SystemExit(
                "tensor-parallel and ZeRO-3 parameter sharding are not "
                "ported: train with --model-parallel 1 and an arch outside "
                f"{sorted(SH.ZERO3_ARCHS)}")

    corpus = ByteCorpus(args.corpus) if args.corpus else \
        SyntheticCorpus(cfg.vocab, seed=0)
    data_cfg = DataConfig(cfg.vocab, args.seq, args.batch,
                          host_id=rank, num_hosts=world)
    it = Prefetcher(batch_iterator(corpus, data_cfg))

    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps)

    def run():
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = model.init(gen)
        opt = adamw.init_state(opt_cfg, params)
        step = make_train_step(
            model, opt_cfg,
            TrainConfig(num_microbatches=args.microbatches,
                        remat=args.remat))
        mgr = CheckpointManager(os.path.join(args.workdir, "ckpt"))
        start, latest = 0, mgr.latest_step()
        if world > 1:       # every rank reads the directory before rank 0
            torch.distributed.barrier()     # writes step 0 into it
        if latest is not None:
            restored = mgr.restore(target={"params": params, "opt": opt})
            params, opt = restored["params"], restored["opt"]
            start = latest
            print(f"resumed from step {start}")
        else:
            mgr.save(0, {"params": params, "opt": opt}, blocking=True)
        driver = TrainDriver(step, mgr, RuntimeConfig(
            checkpoint_every=args.checkpoint_every))

        def report(s, state):
            if s % 20 == 0:
                print(f"step {s:6d}  ewma {driver.stats.ewma*1e3:8.1f} ms"
                      f"  stragglers {len(driver.stats.stragglers)}")

        (params, opt), end = driver.run(params, opt, on_device(it, device),
                                        start_step=start,
                                        num_steps=args.steps,
                                        on_metrics=report)
        print(f"finished at step {end}; failures={driver.failures} "
              f"restores={driver.restores}")
        return {"driver": driver, "params": params, "opt": opt, "step": end}

    try:
        if mesh is not None:
            with mesh_context(mesh):
                return run()
        return run()
    finally:
        it.close()


if __name__ == "__main__":
    main()
