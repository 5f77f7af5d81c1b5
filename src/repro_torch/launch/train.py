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
process group the run takes a ("data", "model") mesh of its ranks, with
`--model-parallel` ranks along "model"; each rank takes `cuda:rank %
cards`, and rank 0 writes the checkpoints.

  * Where the mesh splits no weight (a model extent of 1 and an arch
    outside `shardings.ZERO3_ARCHS`) it trains data-parallel: each rank
    draws its own share of the data and holds the whole parameters as
    plain tensors, and the step averages the gradients over the data axis.
  * Otherwise (tensor-parallel, `--model-parallel` > 1, or ZeRO-3, whose
    weights are split over the data axis too) the parameters and the
    AdamW state are DTensors laid out by `shardings.param_shardings` and
    `opt_state_shardings`; the ranks of one data index draw the same rows
    (that index's share of the data) and each batch is a DTensor split
    over the data axis and replicated over "model". A checkpoint is saved
    whole, in the same format, so it resumes on any mesh shape or on one
    device.

On one device without a process group there is no mesh. Started by
`torchrun` (`WORLD_SIZE` > 1 in the environment) the launcher makes the
process group itself: gloo with `--device cpu`, else NCCL.

It prints `resumed from step N` when it resumes, `step S  ewma E ms
stragglers K` every 20 steps and `finished at step N; failures=F
restores=R` at the end. `main(argv)` returns the driver, the final state
and step.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.registry import ARCH_IDS, get_config
from ..data.pipeline import (ByteCorpus, DataConfig, Prefetcher,
                             SyntheticCorpus, batch_iterator)
from ..distributed import shardings as SH
from ..distributed.context import in_group, mesh_context, rank_and_world
from ..models.transformer import build_model
from ..optim import adamw
from ..runtime.driver import ElasticMesh, RuntimeConfig, TrainDriver
from ..train.step import TrainConfig, make_train_step
from ..tree import leaves, unflatten


def on_device(batches, device, mesh=None):
    """The numpy batches of `batches`, as tensors on `device`; with a
    `mesh` of several ranks, each leaf this rank's share of a DTensor laid
    out by `shardings.batch_shardings`."""
    for batch in batches:
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        if mesh is not None and mesh.size > 1:
            batch = _rank_shares(batch, mesh)
        yield batch


def _rank_shares(batch, mesh):
    from torch.distributed.tensor import DTensor
    dp = _data_extent(mesh)
    whole = {k: torch.empty((v.shape[0] * dp, *v.shape[1:]), dtype=v.dtype,
                            device="meta") for k, v in batch.items()}
    return {k: DTensor.from_local(batch[k], mesh.device_mesh(),
                                  s.placements(), run_check=False)
            for k, s in SH.batch_shardings(mesh, whole).items()}


def _data_extent(mesh) -> int:
    return mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)


def _placed(tree, shardings):
    return unflatten(tree, [s.place(t) for t, s in
                            zip(leaves(tree), leaves(shardings))])


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
    owned = not in_group() and int(os.environ.get("WORLD_SIZE", "1")) > 1
    if owned:       # started by torchrun: its environment names the group
        torch.distributed.init_process_group(
            "nccl" if args.device == "cuda" else "gloo")
    try:
        return _main(args)
    finally:
        if owned:
            torch.distributed.destroy_process_group()


def _main(args):
    rank, world = rank_and_world()
    device = torch.device(args.device)
    if args.device == "cuda" and world > 1:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)

    mesh, sharded = None, False
    if args.model_parallel > 1 or in_group():
        if args.model_parallel > world:
            raise SystemExit(f"--model-parallel {args.model_parallel} needs "
                             f"as many ranks; the process group has {world}")
        mesh = ElasticMesh(args.model_parallel).make(device_type=device.type)
        sharded = mesh.shape["model"] > 1 or args.arch in SH.ZERO3_ARCHS
        if sharded and mesh.size != world:
            raise SystemExit(f"the {mesh.devices.shape} mesh leaves ranks "
                             f"out of the {world}: run a power of two times "
                             f"{args.model_parallel} ranks")

    corpus = ByteCorpus(args.corpus) if args.corpus else \
        SyntheticCorpus(cfg.vocab, seed=0)
    if sharded:     # the ranks of one data index draw the same rows
        host_id = int(np.argwhere(mesh.devices == rank)[0][0])
        data_cfg = DataConfig(cfg.vocab, args.seq, args.batch,
                              host_id=host_id, num_hosts=_data_extent(mesh))
    else:
        data_cfg = DataConfig(cfg.vocab, args.seq, args.batch,
                              host_id=rank, num_hosts=world)
    it = Prefetcher(batch_iterator(corpus, data_cfg))

    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps)

    def run():
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = model.init(gen)
        pshard = None
        if sharded:
            pshard = SH.param_shardings(mesh, params, args.arch)
            params = _placed(params, pshard)
        opt = adamw.init_state(opt_cfg, params)
        if sharded:
            opt = _placed(opt, SH.opt_state_shardings(mesh, opt, params,
                                                      args.arch))
        step = make_train_step(
            model, opt_cfg,
            TrainConfig(num_microbatches=args.microbatches,
                        remat=args.remat),
            param_shardings=pshard)
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

        batches = on_device(it, device, mesh) if sharded \
            else on_device(it, device)
        (params, opt), end = driver.run(params, opt, batches,
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
