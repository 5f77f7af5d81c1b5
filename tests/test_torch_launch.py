"""The port's dry run (`repro_torch.launch.{mesh,specs,hlo_analysis,dryrun,
roofline}`) against the JAX package's `repro.launch.{mesh,specs,
hlo_analysis}`:

- the mesh constants and `device_count_required`, and for every arch of
  the registry at full size and every shape: the plan, the skip reasons
  and `input_specs` leaf by leaf (shape and dtype) - abstract trees on
  both sides, nothing allocated. The reference's `make_production_mesh`
  needs 256 JAX devices and `repro.launch.dryrun` forces 512 at import;
  neither is touched;
- `analyze_step`'s FLOPs on meta tensors against `analyze_hlo` on the
  reference's compiled HLO at reduced size, exactly: the forward of every
  family, the gradient of `loss_fn` (dense, MoE), and llama3-1b's
  integer decode step on its dense cache (the reference under
  `use_kernels(False)`; the port's wrappers count one op per kernel with
  its plain version's products);
- the counting rules on toy ops, and each kernel wrapper's shape-only path
  on meta tensors;
- the dry run itself, in a spawned rank (`tests/torch_dryrun_cells.py`):
  the reference's record keys and skip reasons, argument bytes against
  the reference's own shardings, a one-rank mesh against the plain count,
  the (2, 4) fake world's per-device FLOPs against the one-rank count, a
  row-parallel all-reduce against its formula, and no process group in
  this process;
- the paths it counts compute the model's own results: the reduced
  families' steps with DTensor parameters on four gloo ranks
  (`tests/torch_mesh_ranks.py`) against plain tensors;
- `roofline_row` on a synthetic record with the H100 constants.
"""
import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import get_config as jax_get_config
from repro.distributed import shardings as JS
from repro.kernels import ops as jops
from repro.launch import hlo_analysis as JH
from repro.launch import mesh as JM
from repro.launch import specs as JSP
from repro.models.config import ALL_SHAPES as JAX_SHAPES
from repro.models.config import skipped_shapes as jax_skipped
from repro.models.transformer import build_model as jax_build
from repro.serve.quantized import QuantizedDenseLM as JaxQLM
from repro.serve.quantized import pack_dense_params as jax_pack
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.kernels import block_hadamard as BH
from repro_torch.kernels import hadamard_quant as HQ
from repro_torch.kernels import int4_matmul as I4
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_attention as PA
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import mesh as TM
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as TSP
from repro_torch.models.config import ALL_SHAPES, applicable_shapes
from repro_torch.models.config import skipped_shapes
from repro_torch.models.transformer import build_model
from repro_torch.serve.quantized import QuantizedDenseLM, pack_dense_params
from repro_torch.train.step import grads_of
from repro_torch.tree import flatten_with_paths

# the keys of the reference's `lower_cell` record
RECORD_KEYS = {"arch", "shape", "kind", "multi_pod", "mesh",
               "num_microbatches", "remat_policy", "moment_dtype",
               "serve_layout", "quantized_serve", "status", "lower_s",
               "compile_s", "memory", "cost", "collectives", "hlo_costs"}
MEMORY_KEYS = {"argument_size_bytes", "output_size_bytes", "temp_size_bytes",
               "generated_code_size_bytes", "alias_size_bytes"}
HLO_KEYS = {"flops_per_device", "bytes_per_device",
            "collective_bytes_by_kind", "collective_counts", "top_dots"}
REF_DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
              jnp.dtype(jnp.float32): torch.float32,
              jnp.dtype(jnp.int32): torch.int32}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module (under several
    test workers a thread pool per worker oversubscribes the cores); the
    worker's own setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# mesh, plans, specs
# ---------------------------------------------------------------------------

def test_mesh_matches_the_reference():
    assert TM.SINGLE_POD == JM.SINGLE_POD
    assert TM.MULTI_POD == JM.MULTI_POD
    for mp in (False, True):
        assert TM.device_count_required(mp) == JM.device_count_required(mp)
        m = TM.make_production_mesh(multi_pod=mp)
        assert m.devices.shape == (JM.MULTI_POD if mp else JM.SINGLE_POD)
        assert m.axis_names == (("pod", "data", "model") if mp
                                else ("data", "model"))
        assert m.size == JM.device_count_required(mp)
        assert m._device_mesh is None       # nothing made before it is used
    assert not dist.is_initialized()


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p):
            (tuple(x.shape), REF_DTYPES[jnp.dtype(x.dtype)])
            for p, x in flat}


def _port_leaves(tree):
    return {p: (tuple(t.shape), t.dtype) for p, t in flatten_with_paths(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plans_skips_and_input_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model, jmodel = build_model(cfg), jax_build(jcfg)
    assert skipped_shapes(cfg) == jax_skipped(jcfg)
    assert [c.name for c in ALL_SHAPES] == [c.name for c in JAX_SHAPES]
    assert _port_leaves(TSP.params_specs(model)) == \
        _ref_leaves(JSP.params_specs(jmodel))
    jcells = {c.name: c for c in JAX_SHAPES}
    for cell in applicable_shapes(cfg):
        plan, jplan = TSP.plan_for(cfg, cell), JSP.plan_for(
            jcfg, jcells[cell.name])
        assert (plan.name, plan.kind, plan.num_microbatches) == \
            (jplan.name, jplan.kind, jplan.num_microbatches)
        got = TSP.input_specs(model, plan)
        want = JSP.input_specs(jmodel, jplan)
        assert all(t.device.type == "meta"
                   for _, t in flatten_with_paths(got))
        assert _port_leaves(got) == _ref_leaves(want), (arch, cell.name)


# ---------------------------------------------------------------------------
# analyze_step against analyze_hlo
# ---------------------------------------------------------------------------

B, S = 2, 64


def _batches(cfg, with_labels):
    t = TSP.batch_specs(cfg, B, S, with_labels=with_labels)
    j = {k: jax.ShapeDtypeStruct(v.shape, {torch.bfloat16: jnp.bfloat16,
                                           torch.float32: jnp.float32,
                                           torch.int32: jnp.int32}[v.dtype])
         for k, v in t.items()}
    return t, j


def _hlo(fn, *args):
    return JH.analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())


@pytest.mark.parametrize("arch", ["llama3-1b", "deepseek-moe-16b",
                                  "mamba2-1.3b", "zamba2-1.2b",
                                  "internvl2-2b", "hubert-xlarge"])
def test_forward_flops_equal_the_references_hlo(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    model, jmodel = build_model(cfg), jax_build(jcfg)
    batch, jbatch = _batches(cfg, with_labels=False)
    want = _hlo(jmodel.forward, jmodel.init_abstract(), jbatch)
    got = H.analyze_step(model.forward, model.init_shapes(), batch)
    assert got.flops == want.flops > 0
    assert got.bytes_accessed > 0 and got.peak_bytes > 0
    assert not got.collective_bytes


@pytest.mark.parametrize("arch", ["llama3-1b", "deepseek-moe-16b"])
def test_gradient_flops_equal_the_references_hlo(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    model, jmodel = build_model(cfg), jax_build(jcfg)
    batch, jbatch = _batches(cfg, with_labels=True)
    want = _hlo(jax.grad(lambda p, b: jmodel.loss_fn(p, b)[0]),
                jmodel.init_abstract(), jbatch)
    got = H.analyze_step(grads_of, model, model.init_shapes(), batch,
                         remat=False)
    assert got.flops == want.flops > 0


def test_integer_decode_flops_equal_the_references_hlo():
    """llama3-1b's integer decode step on its dense cache, batch 4, 128
    positions. The reference's jnp path (`use_kernels(False)`) against the
    port's wrappers, each one op with its plain version's products: no op
    differs, so the totals are equal; the plain versions run op by op
    (`use_kernels(False)` on meta) give the same total."""
    cfg, jcfg = get_config("llama3-1b").reduced(), \
        jax_get_config("llama3-1b").reduced()
    jq = JaxQLM(jcfg, block_size=32)
    japarams = jax_build(jcfg).init_abstract()
    aq = jax.eval_shape(lambda p: jax_pack(p, jcfg), japarams)
    cache = jax.eval_shape(lambda: jq.init_cache(4, 128))

    def decode(p, t, c, i):
        with jops.use_kernels(False):
            return jq.decode_step(p, t, c, i)

    want = _hlo(decode, aq, jax.ShapeDtypeStruct((4, 1), jnp.int32), cache,
                jax.ShapeDtypeStruct((), jnp.int32))
    q = QuantizedDenseLM(cfg, block_size=32)
    params = pack_dense_params(build_model(cfg).init_shapes(), cfg)
    args = (params, TSP.sds((4, 1), torch.int32),
            q.init_cache(4, 128, device="meta"),
            TSP.sds((), torch.int32).expand(4))
    got = H.analyze_step(q.decode_step, *args)
    assert set(got.kernel_ops) == {"quantize_act", "int4_matmul",
                                   "hadamard_quant"}
    # one op per wrapper call: per layer 2 + 1 quantisations, 7
    # projections, 1 rotation
    n = cfg.n_layers
    assert {k: v["calls"] for k, v in got.kernel_ops.items()} == \
        {"quantize_act": 3 * n, "int4_matmul": 7 * n, "hadamard_quant": n}
    assert got.flops == want.flops > 0
    with kops.use_kernels(False):
        plain = H.analyze_step(q.decode_step, *args)
    assert plain.flops == want.flops and not plain.kernel_ops


# ---------------------------------------------------------------------------
# counting rules, kernel wrappers on meta
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_counting_rules_on_toy_ops():
    m, k, n = 48, 32, 16
    a, b = _meta(m, k), _meta(k, n)
    c = H.analyze_step(torch.mm, a, b)
    assert c.flops == 2 * m * k * n
    assert c.bytes_accessed == (m * k + k * n + m * n) * 4
    assert c.dot_details == [[f"mm float32[{m},{k}] x float32[{k},{n}] -> "
                              f"float32[{m},{n}]", 2.0 * m * k * n]]
    # views, reshapes and detach are free
    v = H.analyze_step(lambda t: t.view(k, m).t().unsqueeze(0).expand(
        2, m, k).detach(), a)
    assert v.flops == v.bytes_accessed == v.peak_bytes == 0
    # an elementwise op: operands plus output, no FLOPs
    e = H.analyze_step(torch.add, a, a)
    assert e.flops == 0 and e.bytes_accessed == 3 * m * k * 4
    # a gather of rows: the rows read, the indices, the rows written
    table, ids = _meta(100, k), _meta(5, dtype=torch.int64)
    g = H.analyze_step(lambda: table[ids])
    assert g.bytes_accessed == 2 * 5 * k * 4 + 5 * 8
    # a copy into a slice: twice the update
    buf, upd = _meta(10, k), _meta(3, k)
    w = H.analyze_step(lambda: buf[2:5].copy_(upd))
    assert w.bytes_accessed == 2 * 3 * k * 4 and w.peak_bytes == 0

    # the peak of live allocations: x (1 KiB) and y (2 KiB) live together,
    # then x dies; z (4 KiB) joins y
    def seq(t):
        x = t.repeat(1, 1)              # 256 f32
        y = torch.cat([x, x])           # 512
        del x
        z = torch.cat([y, y])           # 1024
        return y, z

    p = H.analyze_step(seq, _meta(16, 16))
    assert p.peak_bytes == (512 + 1024) * 4
    assert not p.collective_bytes


def _shapes(out):
    out = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in out]


def test_kernel_wrappers_take_a_shape_only_path_on_meta():
    """Each wrapper on meta tensors returns the output shapes and dtypes of
    its plain version (run on the same inputs on the CPU), launches
    nothing, and inside `analyze_step` counts one op with the kernel's
    bytes."""
    before = kops.count_snapshot()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 1, 256, generator=g).to(torch.bfloat16)
    codes = torch.randint(-8, 8, (4, 256), generator=g, dtype=torch.int8)
    s, z = torch.rand(4, 1, generator=g), torch.zeros(4, 1)
    w = torch.randint(0, 256, (128, 96), generator=g, dtype=torch.uint8)
    ws, cs = torch.rand(96, generator=g), torch.zeros(96, dtype=torch.int32)
    q = torch.randn(2, 1, 4, 64, generator=g)
    kv = {"k": torch.randn(6, 16, 2, 64, generator=g),
          "v": torch.randn(6, 16, 2, 64, generator=g)}
    bt = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    pos = torch.tensor([[40], [20]], dtype=torch.int32)
    cases = [
        (kops.block_hadamard, BH.block_hadamard_plain, (x, 16), {}),
        (kops.hadamard_quant, lambda x, b: HQ.hadamard_quant_plain(x, b, 4),
         (x, 16), {}),
        (kops.quantize_act, HQ.quantize_act_plain, (x, 4), {}),
        (kops.int4_matmul, I4.int4_matmul_plain, (codes, s, z, w, ws, cs),
         {}),
        (kops.paged_attention, PA.paged_attention_plain, (q, kv, bt, pos),
         {}),
    ]
    for fn, plain, args, kw in cases:
        meta = [{k: v.to("meta") for k, v in a.items()} if isinstance(a, dict)
                else a.to("meta") if torch.is_tensor(a) else a for a in args]
        got = fn(*meta, **kw)
        assert all(t.device.type == "meta"
                   for t in (got if isinstance(got, tuple) else (got,)))
        assert _shapes(got) == _shapes(plain(*args, **kw)), fn.__name__
    codes, s, z, w, ws, cs = (t.to("meta") for t in (codes, s, z, w, ws, cs))
    assert kops.counts_since(before) == ({}, {})      # nothing launched
    c = H.analyze_step(kops.int4_matmul, codes, s, z, w, ws, cs)
    assert c.kernel_ops["int4_matmul"]["calls"] == 1
    assert c.bytes_accessed == 4 * 256 + 128 * 96 + 8 * 4 + 8 * 96 \
        + 4 * 4 * 96          # chip_smoke.py's bound for the kernel
    assert c.flops == 2 * 4 * 256 * 96


# ---------------------------------------------------------------------------
# the dry run, in spawned ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four spawned gloo ranks (`tests/torch_mesh_ranks.py`): the mesh
    steps of every rank, and ranks 1 and 2's dry-run cells."""
    import torch.multiprocessing as tmp
    from torch_mesh_ranks import rank_main
    out = tmp_path_factory.mktemp("ranks")
    world = 4
    ctx = tmp.start_processes(
        rank_main, args=(world, str(out / "store"), str(out)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the ranks hung"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return out


@pytest.fixture(scope="module")
def dryrun_cells(ranks):
    one, two = (json.loads((ranks / f"dryrun{r}.json").read_text())
                for r in (1, 2))
    for k in ("env_changed", "group_after_import", "group_at_end"):
        assert one[k] == two[k]
    return {**one, **two, "cells": {**one["cells"], **two["cells"]}}


def test_dryrun_imports_and_worlds_leave_nothing_behind(dryrun_cells):
    assert dryrun_cells["env_changed"] == []
    assert dryrun_cells["group_after_import"] is False
    assert dryrun_cells["group_at_end"] is False
    assert not dist.is_initialized()


def test_dryrun_records_keep_the_references_layout(dryrun_cells):
    recs = dryrun_cells["cells"]["2x4"] + [dryrun_cells["production"]]
    for rec in recs:
        if rec["status"] == "skipped":
            cfg = jax_get_config(rec["arch"]).reduced()
            assert rec["reason"] == jax_skipped(cfg)[rec["shape"]]
            continue
        assert rec["status"] == "ok", rec.get("error")
        assert RECORD_KEYS <= set(rec)
        assert set(rec["memory"]) == MEMORY_KEYS
        assert set(rec["collectives"]) == {"bytes_by_kind", "count_by_kind",
                                           "total_bytes"}
        assert HLO_KEYS <= set(rec["hlo_costs"])
        assert rec["hlo_costs"]["flops_per_device"] > 0
    skipped = {(r["arch"], r["shape"]) for r in recs
               if r["status"] == "skipped"}
    assert skipped == {("llama3-1b", "long_500k"),
                       ("hubert-xlarge", "decode_32k")}


def _ref_shard_bytes(tree, shardings, mesh):
    """Bytes of one device's shards, from the reference's specs."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    flat, _ = jax.tree_util.tree_flatten(tree)
    specs, _ = jax.tree_util.tree_flatten(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(flat, specs):
        n = 1
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim):
            axes = () if entry is None else entry if isinstance(entry, tuple) \
                else (entry,)
            n *= dim // math.prod(sizes[a] for a in axes)
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def test_argument_bytes_equal_the_references_shards(dryrun_cells,
                                                    monkeypatch):
    """The production decode cell's and the (2, 4) train cell's argument
    bytes against the shard bytes of the reference's own specs and
    shardings."""
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)
    from repro.optim import adamw as jadamw
    # llama3-1b decode_32k on (16, 16): params, tokens, cache, index
    cfg = jax_get_config("llama3-1b")
    model = jax_build(cfg)
    mesh = FakeMesh(JM.SINGLE_POD, ("data", "model"))
    plan = JSP.plan_for(cfg, {c.name: c for c in JAX_SHAPES}["decode_32k"])
    specs = JSP.input_specs(model, plan)
    params = model.init_abstract()
    want = (_ref_shard_bytes(params, JS.param_shardings(mesh, params,
                                                        cfg.name), mesh)
            + _ref_shard_bytes(specs["tokens"], JS.batch_shardings(
                mesh, {"t": specs["tokens"]})["t"], mesh)
            + _ref_shard_bytes(specs["cache"],
                               JS.cache_shardings(mesh, specs["cache"]), mesh)
            + 4)
    assert dryrun_cells["production"]["memory"]["argument_size_bytes"] == want
    # reduced llama3-1b train on (2, 4), batch 8 x 64: params, AdamW, batch
    cfg = jax_get_config("llama3-1b").reduced()
    model = jax_build(cfg)
    mesh = FakeMesh((2, 4), ("data", "model"))
    params = model.init_abstract()
    opt = jax.eval_shape(lambda p: jadamw.init_state(jadamw.AdamWConfig(), p),
                         params)
    batch = JSP.batch_specs(cfg, 8, 64, with_labels=True)
    pshard = JS.param_shardings(mesh, params, cfg.name)
    want = (_ref_shard_bytes(params, pshard, mesh)
            + _ref_shard_bytes(opt, JS.opt_state_shardings(
                mesh, opt, params, cfg.name), mesh)
            + _ref_shard_bytes(batch, JS.batch_shardings(mesh, batch), mesh))
    rec = dryrun_cells["cells"]["2x4"][0]
    assert (rec["arch"], rec["shape"]) == ("llama3-1b", "train_4k")
    assert rec["memory"]["argument_size_bytes"] == want


def test_a_one_rank_mesh_is_the_plain_count(dryrun_cells):
    """On a 1x1 mesh: no collective, and a forward's FLOPs equal
    `analyze_step` of the model alone."""
    for rec in dryrun_cells["cells"]["1x1"]:
        if rec["status"] != "ok":
            continue
        assert rec["collectives"]["total_bytes"] == 0, rec["arch"]
        assert rec["hlo_costs"]["collective_counts"] == {}
    rec = next(r for r in dryrun_cells["cells"]["1x1"]
               if (r["arch"], r["shape"]) == ("internvl2-2b", "prefill_32k"))
    model = build_model(get_config("internvl2-2b").reduced())
    batch = TSP.batch_specs(model.cfg, 8, 64, with_labels=False)
    cache = TSP.cache_specs(model, 8, 64)
    c = H.analyze_step(model.prefill, model.init_shapes(), batch, cache)
    assert rec["hlo_costs"]["flops_per_device"] == c.flops


def test_sharded_flops_cover_the_global_count(dryrun_cells):
    """Per-device FLOPs times the world's 8 ranks are at least the one-rank
    count (replicated work counts on every rank), and equal to it where
    every sharded dimension divides and nothing is computed twice: the
    dense families' prefill and decode."""
    exact = {("llama3-1b", "prefill_32k", False),
             ("llama3-1b", "decode_32k", False),
             ("qwen1.5-0.5b", "prefill_32k", False)}
    eights = {(r["arch"], r["shape"], r.get("quantized_serve")): r
              for r in dryrun_cells["cells"]["2x4"]}
    for one in dryrun_cells["cells"]["1x1"]:
        eight = eights[one["arch"], one["shape"], one.get("quantized_serve")]
        assert one["status"] == eight["status"], one["arch"]
        if one["status"] != "ok":
            continue
        f1 = one["hlo_costs"]["flops_per_device"]
        f8 = eight["hlo_costs"]["flops_per_device"]
        assert f8 * 8 >= f1, (one["arch"], one["shape"])
        if (one["arch"], one["shape"], one["quantized_serve"]) in exact:
            assert f8 * 8 == f1, (one["arch"], one["shape"])
        assert eight["collectives"]["total_bytes"] > 0


def test_rows_that_do_not_divide_the_data_ranks(dryrun_cells):
    """A decode of one sequence and a ZeRO-3 train step whose micro-batch
    of one row does not divide the 2 data ranks count: the activations
    are replicated where their rows do not divide the ranks, and the
    micro-batch is padded to one row a rank (P8)."""
    for rec in dryrun_cells["uneven"]:
        assert rec["status"] == "ok", rec.get("error")
        assert rec["hlo_costs"]["flops_per_device"] > 0


def test_row_parallel_all_reduce_bytes_follow_the_formula(dryrun_cells):
    """A SwiGLU feed-forward split over "model" (4 ranks) with the batch
    over "data" (2): one all-reduce of the down projection's output, the
    result on one device: (batch / 2) x seq x d f32."""
    r = dryrun_cells["row_parallel_ffn"]
    assert r["collective_counts"] == {"all-reduce": 1}
    assert r["collective_bytes"] == {
        "all-reduce": r["batch"] // 2 * r["seq"] * r["d"] * 4}
    assert r["flops"] == 3 * 2 * (r["batch"] // 2) * r["seq"] * r["d"] \
        * (r["f"] // 4)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def test_roofline_row_with_the_h100_constants():
    rec = {"status": "ok", "arch": "llama3-1b", "shape": "decode_32k",
           "kind": "decode", "mesh": {"shape": [16, 16]},
           "memory": {"argument_size_bytes": 2 ** 30,
                      "temp_size_bytes": 2 ** 29},
           "hlo_costs": {"flops_per_device": 989e9,
                         "bytes_per_device": 3.35e10,
                         "collective_bytes_by_kind": {"all-reduce": 2.5e8,
                                                      "all-gather": 2.5e8}}}
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 50e9)
    row = R.roofline_row(rec)
    assert row["t_compute_s"] == pytest.approx(1e-3)
    assert row["t_memory_s"] == pytest.approx(1e-2)
    assert row["t_collective_s"] == pytest.approx(1e-2)
    assert row["dominant"] in ("memory", "collective")
    assert row["mesh"] == "16x16" and row["hbm_gib_dev"] == 1.5
    mf = R.model_flops("llama3-1b", "decode_32k", "decode")
    assert mf == 2.0 * R._arch_matmul_params(get_config("llama3-1b")) * 128
    assert row["useful_ratio"] == pytest.approx(mf / 256 / 989e9)
    assert row["roofline_frac"] == pytest.approx(mf / 256 / 989e12 / 1e-2)
    assert R.roofline_row({"status": "fail"}) is None
    assert "llama3-1b" in R.fmt_table([row])


# ---------------------------------------------------------------------------
# the counted paths compute the one-device results (gloo ranks)
# ---------------------------------------------------------------------------

def test_mesh_paths_give_the_one_device_results(ranks):
    """What the dry run counts on a mesh is the model's own step: on four
    gloo ranks, (2, 2) and (1, 4) meshes with DTensor parameters, the
    reduced families' forward, prefill into a cache and a decode step from
    it (llama3-1b also its loss and every gradient with remat, and the
    integer decode step) equal the plain tensors' results, to f32
    reordering of the sums split over the ranks."""
    world = 4
    res_of = [torch.load(ranks / f"rank{r}.pt") for r in range(world)]
    plain = {k[len("plain/"):]: v for k, v in res_of[0].items()
             if k.startswith("plain/")}
    checked = 0
    for res in res_of:
        for key, got in res.items():
            if key.startswith("plain/"):
                continue
            want = plain[key.split("/", 1)[1]]
            scale = max(float(want.abs().max()), 1e-6)
            err = float((got - want).abs().max())
            assert err <= 2e-5 * scale, (key, err, scale)
            checked += 1
    from torch_mesh_ranks import MESHES
    assert checked == world * sum(
        len([k for k in plain if k.split("/")[0] in archs])
        for archs in MESHES.values())
