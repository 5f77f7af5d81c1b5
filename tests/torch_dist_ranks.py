"""The ranks of `test_torch_distributed.py`'s two-rank test, in a module
of their own so that a spawned rank imports torch and the port only: the
int8 all-reduce, a sharded restore, an activation's layout, and the
training launcher data-parallel over the ranks."""
import os

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed import compression as TC
from repro_torch.distributed import context as TX
from repro_torch.distributed import shardings as TS
from repro_torch.launch import train as LT
from repro_torch.tree import flatten_with_paths


def inputs(rank):
    rng = np.random.default_rng(100 + rank)
    return {"f32": rng.standard_normal((64, 48)).astype(np.float32)
            * (1 + 3 * rank),
            "bf16": rng.standard_normal((96,)).astype(np.float32)}


LAUNCH = ["--arch", "llama3-1b", "--reduced", "--device", "cpu", "--steps",
          "2", "--batch", "4", "--seq", "16"]


def rank_main(rank, world, store, ckpt_dir, out_dir):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        mesh = TX.Mesh(np.arange(world), ("pod",), "cpu")
        res = {}
        with TX.mesh_context(mesh):
            for k, v in inputs(rank).items():
                x = torch.from_numpy(v)
                if k == "bf16":
                    x = x.to(torch.bfloat16)
                res[k] = TC.compressed_psum(x, "pod").float().numpy()
            # restore_sharded: w by its spec (columns over "pod"), b
            # replicated
            target = {"w": torch.zeros(4, 6), "b": torch.zeros(3)}
            shard = {"w": TX.NamedSharding(mesh, TX.P(None, "pod")),
                     "b": TS.replicated(mesh)}
            got = CheckpointManager(ckpt_dir).restore_sharded(target, shard)
            assert isinstance(got["w"], DTensor)
            assert list(got["w"].placements) == [Shard(1)]
            assert list(got["b"].placements) == [Replicate()]
            res["w_local"] = got["w"].to_local().numpy()
            res["w_full"] = got["w"].full_tensor().numpy()
            res["b_local"] = got["b"].to_local().numpy()
            # shard_act: a replicated DTensor laid out by ("batch", None)
            act = TX.shard_act(got["w"].redistribute(
                mesh.device_mesh(), [Replicate()]), ("batch", None))
            assert list(act.placements) == [Shard(0)]
            res["act_local"] = act.to_local().numpy()
        # the launcher, data-parallel over the two ranks
        run = LT.main(LAUNCH + ["--workdir", os.path.join(out_dir, "dp")])
        for path, v in flatten_with_paths(run["params"]):
            res["dp::" + "::".join(path)] = v.numpy()
        res["dp_step"] = np.asarray(run["step"])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()
