"""The ranks of `test_torch_launch.py`'s mesh test, in a module of their
own so that a spawned rank imports torch and the port only.

Four gloo ranks run the reduced families' steps with DTensor parameters on
a (2, 2) mesh (llama3-1b's 2 KV heads divide the model axis: the attention
is head-parallel) and llama3-1b's also on a (1, 4) one (they do not: the
attention splits the sequence, and decode reads a cache split by
sequence), the paths `launch/dryrun.py` counts; rank 0 also runs every
step on plain tensors. Each rank writes the whole outputs to `<out>/rank<r>.pt`. Ranks 1
and 2 then leave the gloo world and count the dry-run cells of
`torch_dryrun_cells.py` in fake worlds of their own, half each, into
`<out>/dryrun<r>.json`, with what importing the launch modules changed
(the environment, a process group) before any world existed."""
import json
import os

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.distributed import context as TX
from repro_torch.distributed import shardings as TS
from repro_torch.models.transformer import build_model
from repro_torch.serve.quantized import QuantizedDenseLM, pack_dense_params
from repro_torch.train.step import grads_of
from repro_torch.tree import flatten_with_paths, leaves, unflatten

# a forward of 2 x 64 tokens a rank gathers the SSM's in-projection
# weight, a prefill of 12 or a decode step its output
B, S, PROMPT = 4, 64, 12
ARCHS = ("llama3-1b", "deepseek-moe-16b", "mamba2-1.3b", "zamba2-1.2b")
# (1, 4): the sequence-split attention and flash-decoding; (2, 2): the
# head-parallel attention, expert- and head-parallel MoE and SSM blocks,
# and weights replicated over a data axis of two
MESHES = {(1, 4): ("llama3-1b",), (2, 2): ARCHS}


def _place(tree, shardings):
    return unflatten(tree, [sh.place(t) for t, sh in
                            zip(leaves(tree), leaves(shardings))])


def _whole(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def _inputs(cfg):
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=g,
                           dtype=torch.int32)
    return {"tokens": tokens[:, :-1].contiguous(),
            "labels": tokens[:, 1:].contiguous()}


def steps(arch, mesh):
    """The steps of `arch` (reduced, seeded) inside `mesh` (None: plain
    tensors) -> {name: whole tensor}."""
    # one layer (zamba2: two, a group and its shared block)
    cfg = get_config(arch).reduced(n_layers=2 if arch == "zamba2-1.2b"
                                   else 1)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _inputs(cfg)
    out = {}
    # plain tensors met on a mesh (masks, tables) are replicated operands,
    # as in the dry run
    from torch.distributed.tensor.experimental import implicit_replication
    with TX.mesh_context(mesh), implicit_replication():
        if mesh is not None:
            params = _place(params, TS.param_shardings(mesh, params, arch))
            batch = _place(batch, TS.batch_shardings(mesh, batch))
        out["forward"] = _whole(model.forward(params, {"tokens":
                                                       batch["tokens"]}))
        if arch == "llama3-1b":
            loss, _, grads = grads_of(model, params, batch, remat=True)
            out["loss"] = _whole(loss)
            for p, g in flatten_with_paths(grads):
                out["grad/" + "/".join(map(str, p))] = _whole(g)
        cache = model.init_cache(B, S, dtype=torch.float32, device="cpu")
        prompt = {"tokens": batch["tokens"][:, :PROMPT]}
        if mesh is not None:
            cache = _place(cache, TS.cache_shardings(mesh, cache))
        last, cache = model.prefill(params, prompt, cache)
        out["prefill"] = _whole(last)
        index = torch.full((B,), PROMPT, dtype=torch.int32)
        logits, cache = model.decode_step(params, batch["tokens"][
            :, PROMPT:PROMPT + 1], cache, index)
        out["decode"] = _whole(logits)
        if arch == "llama3-1b":
            qlm = QuantizedDenseLM(cfg, block_size=32)
            packed = pack_dense_params(model.init(
                torch.Generator().manual_seed(0)), cfg)
            qcache = qlm.init_cache(B, S, dtype=torch.float32, device="cpu")
            if mesh is not None:
                from repro_torch.launch.dryrun import \
                    quantized_param_shardings
                packed = _place(packed, quantized_param_shardings(
                    mesh, packed, arch))
                qcache = _place(qcache, TS.cache_shardings(mesh, qcache))
            ql, _ = qlm.decode_step(packed, batch["tokens"][:, :1], qcache,
                                    torch.zeros((B,), dtype=torch.int32))
            out["int_decode"] = _whole(ql)
    return out


def rank_main(rank, world, store, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    if rank in (1, 2):
        before = dict(os.environ)
        from repro_torch.launch import (dryrun, hlo_analysis,  # noqa: F401
                                        mesh, roofline, specs)
        imported = {"env_changed": sorted(
            k for k in set(os.environ) | set(before)
            if os.environ.get(k) != before.get(k)),
            "group_after_import": dist.is_initialized()}
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        res = {}
        for shape, archs in MESHES.items():
            mesh = TX.Mesh(np.arange(world).reshape(shape),
                           ("data", "model"), "cpu")
            for arch in archs:
                for k, v in steps(arch, mesh).items():
                    res[f"{shape[0]}x{shape[1]}/{arch}/{k}"] = v
        if rank == 0:
            for arch in ARCHS:
                for k, v in steps(arch, None).items():
                    res[f"plain/{arch}/{k}"] = v
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    if rank in (1, 2):
        from torch_dryrun_cells import collect
        with open(f"{out_dir}/dryrun{rank}.json", "w") as f:
            json.dump({**imported, **collect(rank - 1)}, f)
