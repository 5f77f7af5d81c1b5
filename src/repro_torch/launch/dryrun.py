"""Multi-pod dry run: count every (arch x shape x mesh) cell without a card.

The port's counterpart of `repro/launch/dryrun.py`, which lowers and
compiles each cell for 512 forced host devices. There is no compiler
here. For each cell this script:

  1. makes a fake world of `device_count_required` ranks
     (`torch.distributed`'s "fake" backend: collectives do nothing) inside
     `fake_world`, which destroys it again; nothing happens at import;
  2. builds the parameters, optimizer state, batch and cache as meta
     tensors (`launch/specs.py`) and lays each out on the production mesh
     by the port's shardings (`distributed/shardings.py`; the packed int4
     tree by `quantized_param_shardings`): a DTensor of meta shards, so
     nothing is allocated;
  3. runs the cell's step once under `launch/hlo_analysis.py::analyze_step`,
     where DTensor's sharding propagation plays XLA's SPMD partitioner and
     every op is counted on one rank's shards: FLOPs, HBM bytes, the peak of
     live allocations and the collectives per kind;
  4. writes one JSON per cell to artifacts/dryrun_torch/, with the
     reference's record keys.

A train cell counts one micro-batch (`train.step.grads_of` and the add
into the f32 accumulator), multiplies it by `num_microbatches` and adds
one AdamW update: the reference walker's trip-count rule for its scan over
micro-batches. A cell that fails is recorded as `status: "fail"` with its
traceback.

Usage (no card needed; seconds to a few minutes per cell on a CPU):
    PYTHONPATH=src python -m repro_torch.launch.dryrun          # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-1b \\
        --shape decode_32k --multi-pod single --quantized-serve
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import numpy as np
import torch

from ..configs.registry import ARCH_IDS, get_config
from ..distributed import shardings as SH
from ..distributed.context import Mesh, NamedSharding, P, mesh_context
from ..models.config import applicable_shapes, skipped_shapes
from ..models.transformer import build_model
from ..optim import adamw
from ..tree import flatten_with_paths, leaves, tree_map, unflatten
from .hlo_analysis import analyze_step, tensor_bytes
from .mesh import device_count_required, make_production_mesh
from .specs import batch_specs, input_specs, plan_for

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

@contextlib.contextmanager
def fake_world(world_size: int):
    """A `torch.distributed` world of `world_size` ranks in this one
    process (rank 0), whose collectives do nothing; destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group already exists")
    dist.init_process_group("fake", store=FakeStore(),
                            world_size=world_size, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _place(tree, shardings):
    """Each meta leaf as a DTensor of meta shards laid out by its
    `NamedSharding` (the leaf itself on a one-rank mesh)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def one(t, sh: NamedSharding):
        if sh.mesh.size == 1:
            return t
        dm, pl = sh.mesh.device_mesh(), sh.placements()
        shape, _ = compute_local_shape_and_global_offset(t.shape, dm, pl)
        local = torch.empty(shape, dtype=t.dtype, device="meta")
        return DTensor.from_local(local, dm, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    shs = leaves(shardings) if not isinstance(shardings, NamedSharding) \
        else [shardings] * len(leaves(tree))
    return unflatten(tree, [one(t, s) for t, s in zip(leaves(tree), shs)])


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum(tensor_bytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in leaves(tree))


def quantized_param_shardings(mesh: Mesh, aparams, arch: str):
    """Shardings for the packed-int4 serving tree: packed weights shard
    like their bf16 counterparts (column-parallel on N for the in-projections,
    row-parallel on K/2 for the out-projections; nibble pairs stay on one
    shard because K is even per shard); the reference's rule. The port's
    `colsum` leaves ([N] int32) shard like `scale`."""
    def spec(path, leaf):
        parts = path.split("/")
        name = parts[-2] if parts[-1] in ("packed", "scale", "colsum") \
            else parts[-1]
        mdl = "model" if "model" in mesh.axis_names else None
        if parts[-1] == "packed":
            if name in ("wq", "wk", "wv", "w_gate", "w_up"):
                return SH._fit(P(None, None, mdl), leaf.shape, mesh)
            return SH._fit(P(None, mdl, None), leaf.shape, mesh)
        if parts[-1] in ("scale", "colsum") and name in (
                "wq", "wk", "wv", "w_gate", "w_up"):
            return SH._fit(P(None, mdl), leaf.shape, mesh)
        if name == "embed":
            return SH._fit(P(mdl, None), leaf.shape, mesh)
        if name == "lm_head":
            return SH._fit(P(None, mdl), leaf.shape, mesh)
        return P(*([None] * len(leaf.shape)))

    flat = flatten_with_paths(aparams)
    return unflatten(aparams, [NamedSharding(mesh, spec(SH._path_str(p), l))
                               for p, l in flat])


def _hlo_costs(c) -> dict:
    return {"flops_per_device": c.flops,
            "bytes_per_device": c.bytes_accessed,
            "collective_bytes_by_kind": dict(c.collective_bytes),
            "collective_counts": dict(c.collective_counts),
            "top_dots": c.dot_details[:12],
            "flops_by_op": dict(c.flops_by_op),
            "bytes_by_op": dict(sorted(c.bytes_by_op.items(),
                                       key=lambda kv: -kv[1])),
            "kernel_ops": dict(c.kernel_ops)}


def _scaled(c, n: int):
    """Costs `c` counted `n` times (a loop's body and its trip count)."""
    return dataclasses.replace(
        c, flops=c.flops * n, bytes_accessed=c.bytes_accessed * n,
        collective_bytes={k: v * n for k, v in c.collective_bytes.items()},
        collective_counts={k: v * n for k, v in c.collective_counts.items()},
        dot_details=[[k, v * n] for k, v in c.dot_details],
        flops_by_op={k: v * n for k, v in c.flops_by_op.items()},
        bytes_by_op={k: v * n for k, v in c.bytes_by_op.items()},
        kernel_ops={k: {f: v * n for f, v in d.items()}
                    for k, d in c.kernel_ops.items()})


def _summed(a, b):
    def add(x, y):
        return {k: x.get(k, 0) + y.get(k, 0) for k in {**x, **y}}
    dots = {}
    for k, v in a.dot_details + b.dot_details:
        dots[k] = dots.get(k, 0) + v
    return dataclasses.replace(
        a, flops=a.flops + b.flops,
        bytes_accessed=a.bytes_accessed + b.bytes_accessed,
        collective_bytes=add(a.collective_bytes, b.collective_bytes),
        collective_counts=add(a.collective_counts, b.collective_counts),
        dot_details=sorted(([k, v] for k, v in dots.items()),
                           key=lambda kv: -kv[1]),
        peak_bytes=max(a.peak_bytes, b.peak_bytes),
        flops_by_op=add(a.flops_by_op, b.flops_by_op),
        bytes_by_op=add(a.bytes_by_op, b.bytes_by_op),
        kernel_ops={**a.kernel_ops, **b.kernel_ops})


def _count(mesh: Mesh, fn, *args):
    """`analyze_step(fn, *args)` inside the mesh, with plain tensors taken
    as replicated operands on a mesh of several ranks."""
    if mesh.size == 1:
        return analyze_step(fn, *args)
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        return analyze_step(fn, *args)


def _train(model, plan, mesh, aparams, pshard, arch, moment_dtype):
    from ..train.step import grads_of
    cfg = model.cfg
    opt_cfg = adamw.AdamWConfig(moment_dtype=moment_dtype)
    aopt = adamw.init_state(opt_cfg, aparams)
    oshard = SH.opt_state_shardings(mesh, aopt, aparams, arch)
    cell = plan.cell
    n = plan.num_microbatches
    if cell.global_batch % n:
        raise ValueError(f"batch {cell.global_batch} does not split into "
                         f"{n} micro-batches")
    batch = batch_specs(cfg, cell.global_batch, cell.seq_len,
                        with_labels=True)
    # a micro-batch whose rows do not divide the data ranks is padded to
    # the next multiple of them, as XLA pads a split that does not divide
    # (each rank counts its one padded share)
    dp = math.prod(mesh.shape.get(a, 1) for a in ("pod", "data"))
    rows = -(-(cell.global_batch // n) // dp) * dp
    micro = batch_specs(cfg, rows, cell.seq_len, with_labels=True)
    params = _place(aparams, pshard)
    opt = _place(aopt, oshard)
    acc_shapes = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                                device="meta"), aparams)
    acc = _place(acc_shapes, pshard)
    mb = _place(micro, SH.batch_shardings(mesh, micro))

    def micro_step(params, acc, mb):
        _, _, grads = grads_of(model, params, mb, remat=True)
        for a, g in zip(leaves(acc), leaves(grads)):
            a.add_(g)

    def update(params, acc, opt):
        for a in leaves(acc):
            a.div_(n)
        return adamw.apply_updates(opt_cfg, params, acc, opt)

    c_micro = _count(mesh, micro_step, params, acc, mb)
    c_update = _count(mesh, update, params, acc, opt)
    costs = _summed(_scaled(c_micro, n), c_update)
    argument = _local_bytes(params) + _local_bytes(opt) \
        + _local_bytes(_place(batch, SH.batch_shardings(mesh, batch)))
    # the f32 accumulator lives through the step: a temporary of the step
    temp = _local_bytes(acc) + max(c_micro.peak_bytes, c_update.peak_bytes)
    out = _local_bytes(params) + _local_bytes(opt)
    return costs, {"argument_size_bytes": argument,
                   "output_size_bytes": out, "temp_size_bytes": temp,
                   "generated_code_size_bytes": 0,
                   "alias_size_bytes": out}


def dry_run_cell(arch: str, shape_name: str, *, multi_pod: bool,
                 serve_layout: bool = False, remat_policy: str = "nothing",
                 microbatches: int | None = None,
                 moment_dtype: str = "float32",
                 quantized_serve: bool = False,
                 mesh_shape: tuple | None = None, reduced: bool = False,
                 batch: int | None = None, seq: int | None = None) -> dict:
    """Count one cell; the reference's `lower_cell`. The port's extras,
    for tests and for checks on one card: `mesh_shape` in place of the
    production mesh (its axes: the last two are data x model, a third in
    front is pod), `reduced` for the arch's small config, `batch` and `seq`
    in place of the cell's. A fake world of the mesh's size must exist
    (`fake_world`); `main` makes it."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cells = {c.name: c for c in applicable_shapes(cfg)}
    if shape_name not in cells:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": skipped_shapes(cfg).get(shape_name, "n/a")}
    cell = cells[shape_name]
    if batch is not None or seq is not None:
        cell = dataclasses.replace(
            cell, global_batch=batch or cell.global_batch,
            seq_len=seq or cell.seq_len)
    plan = plan_for(cfg, cell)
    if microbatches is not None and plan.kind == "train":
        plan = dataclasses.replace(plan, num_microbatches=microbatches)
    if mesh_shape is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cuda")
    else:
        axes = ("pod", "data", "model")[-len(mesh_shape):]
        mesh = Mesh(np.arange(int(np.prod(mesh_shape))).reshape(mesh_shape),
                    axes, device_type="cuda")
    model = build_model(cfg, remat_policy=remat_policy)

    # serving layout: replicated batch, 2-D weights, the cache's sequence
    # over every axis, so decode never gathers ZeRO-3 weights
    serve = serve_layout and plan.kind == "decode"
    rules = SH.SERVE_RULES if serve else None

    t0 = time.perf_counter()
    with mesh_context(mesh, rules=rules):
        aparams = model.init_shapes()
        pshard = SH.param_shardings(mesh, aparams, arch)
        specs = input_specs(model, plan)
        memory = None
        if plan.kind == "train":
            costs, memory = _train(model, plan, mesh, aparams, pshard, arch,
                                   moment_dtype)
        elif plan.kind == "prefill":
            params = _place(aparams, pshard)
            b = _place(specs["batch"],
                       SH.batch_shardings(mesh, specs["batch"]))
            if "cache" in specs:
                cache = _place(specs["cache"],
                               SH.cache_shardings(mesh, specs["cache"]))
                costs = _count(mesh, model.prefill, params, b, cache)
                args = (params, b, cache)
            else:
                costs = _count(mesh, model.forward, params, b)
                args = (params, b)
        elif quantized_serve:
            from ..serve.quantized import QuantizedDenseLM, pack_dense_params
            qlm = QuantizedDenseLM(cfg, block_size=32)
            aq = pack_dense_params(aparams, cfg)
            params = _place(aq, quantized_param_shardings(mesh, aq, arch))
            cspec = qlm.init_cache(cell.global_batch, cell.seq_len,
                                   device="meta")
            cache = _place(cspec, SH.cache_shardings(mesh, cspec))
            tokens = _place(specs["tokens"], SH.batch_shardings(
                mesh, {"t": specs["tokens"]})["t"])
            index = specs["index"].expand(cell.global_batch)
            costs = _count(mesh, qlm.decode_step, params, tokens, cache,
                           index)
            args = (params, tokens, cache, specs["index"])
        else:
            params = _place(aparams, pshard)
            if serve:
                cache = _place(specs["cache"], SH.serve_cache_shardings(
                    mesh, specs["cache"]))
                tshard = SH.replicated(mesh)
            else:
                cache = _place(specs["cache"],
                               SH.cache_shardings(mesh, specs["cache"]))
                tshard = SH.batch_shardings(mesh,
                                            {"t": specs["tokens"]})["t"]
            tokens = _place(specs["tokens"], tshard)
            index = specs["index"].expand(cell.global_batch)
            costs = _count(mesh, model.decode_step, params, tokens, cache,
                           index)
            args = (params, tokens, cache, specs["index"])
        if memory is None:
            argument = sum(_local_bytes(a) for a in args)
            memory = {"argument_size_bytes": argument,
                      "output_size_bytes": 0,
                      "temp_size_bytes": costs.peak_bytes,
                      "generated_code_size_bytes": 0,
                      "alias_size_bytes": 0}
    t_count = time.perf_counter() - t0
    coll = {"bytes_by_kind": {k: int(v) for k, v in
                              costs.collective_bytes.items()},
            "count_by_kind": {k: int(v) for k, v in
                              costs.collective_counts.items()},
            "total_bytes": int(costs.total_collective_bytes)}
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": plan.kind,
        "multi_pod": multi_pod,
        "mesh": {"shape": list(mesh.devices.shape),
                 "axes": list(mesh.axis_names)},
        "num_microbatches": plan.num_microbatches,
        "remat_policy": remat_policy,
        "moment_dtype": moment_dtype,
        "serve_layout": serve,
        "quantized_serve": quantized_serve,
        "reduced": reduced,
        "global_batch": cell.global_batch,
        "seq_len": cell.seq_len,
        "status": "ok",
        "lower_s": round(t_count, 2),
        "compile_s": 0.0,
        "memory": memory,
        "cost": {"flops": costs.flops, "bytes accessed": costs.bytes_accessed},
        "collectives": coll,
        "hlo_costs": _hlo_costs(costs),
    }


def record_name(rec: dict, *, multi_pod: bool, serve_layout: bool,
                tag: str) -> str:
    return f"{rec['arch']}__{rec['shape']}__{'mp' if multi_pod else 'sp'}" \
        + ("__serve" if serve_layout and rec.get("kind") == "decode"
           else "") + (f"__{tag}" if tag else "") + ".json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="single arch id (default all)")
    ap.add_argument("--shape", default=None, help="single shape name")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--serve-layout", action="store_true",
                    help="replicated-batch serving layout for decode cells")
    ap.add_argument("--remat-policy", default="nothing",
                    choices=["nothing", "dots"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--quantized-serve", action="store_true",
                    help="count the packed-int4 integer decode path")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    # the port's: another mesh, another batch or length (a check on one
    # card)
    ap.add_argument("--mesh", default=None,
                    help="mesh shape, e.g. 1,1 or 2,4 (data x model) or "
                         "2,2,4; replaces --multi-pod's production mesh")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else \
        ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]
    mesh_shape = tuple(int(x) for x in args.mesh.split(",")) \
        if args.mesh else None
    if mesh_shape is not None:
        pods = [len(mesh_shape) == 3]

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for mp in pods:
        world = int(np.prod(mesh_shape)) if mesh_shape else \
            device_count_required(mp)
        with fake_world(world):
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch}/{shape}/{'2pod' if mp else '1pod'}"
                    try:
                        rec = dry_run_cell(
                            arch, shape, multi_pod=mp,
                            serve_layout=args.serve_layout,
                            remat_policy=args.remat_policy,
                            microbatches=args.microbatches,
                            moment_dtype=args.moment_dtype,
                            quantized_serve=args.quantized_serve,
                            mesh_shape=mesh_shape, batch=args.batch,
                            seq=args.seq)
                    except Exception:
                        rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                               "status": "fail",
                               "error": traceback.format_exc(limit=20)}
                    if rec["status"] == "ok":
                        n_ok += 1
                        mem = rec["memory"]
                        per_dev = (mem["argument_size_bytes"]
                                   + mem["temp_size_bytes"]) / 2 ** 30
                        print(f"[OK]   {tag:60s} count {rec['lower_s']:6.1f}s "
                              f"arg+temp/dev {per_dev:7.2f} GiB coll "
                              f"{rec['collectives']['total_bytes'] / 2**30:.3f}"
                              f" GiB", flush=True)
                    elif rec["status"] == "skipped":
                        n_skip += 1
                        print(f"[SKIP] {tag:60s} {rec['reason']}", flush=True)
                    else:
                        n_fail += 1
                        print(f"[FAIL] {tag}")
                        print(rec["error"], flush=True)
                    fname = record_name(rec, multi_pod=mp,
                                        serve_layout=args.serve_layout,
                                        tag=args.tag)
                    with open(os.path.join(args.out, fname), "w") as f:
                        json.dump(rec, f, indent=1)
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
