"""The launcher benches of the port (`repro_torch.bench`) against the
reference's (`benchmarks/kernel_bench.py`, `benchmarks/serve_bench.py`),
on the CPU.

Held exactly: the shared ragged workload (`ragged_paged_batch`), the three
slab oracles of `serve/engine/pages.py` (bit for bit on numpy-made pools,
f32, bf16 and int8 leaves, a nested pool among them), and what both
packages' `_check_schema`s accept and refuse. The port's `main`s run at
the reduced size with `--smoke --device cpu` (host clock, plain versions)
and write the reference's row names; the serve bench's three gated traces
(burst, swap, prefix) pass with the reference's traces; without a card
`--device cuda` exits instead of running on the CPU. The reference's own
`main`s cannot run here (its paged-attention kernel needs R1's shim).
"""
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common as JC  # noqa: E402
from repro.serve.engine import pages as JPG  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.bench import kernel_bench, serve_bench  # noqa: E402
from repro_torch.bench import timing as T  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.paper import common  # noqa: E402
from repro_torch.serve.engine import as_servable  # noqa: E402
from repro_torch.serve.engine import pages as PG  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module (under several
    test workers a thread pool per worker oversubscribes the cores); the
    worker's own setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_reference(name):
    """A reference bench loaded by path, as `tests/test_telemetry.py`
    loads it."""
    root = ROOT / "benchmarks"
    sys.path.insert(0, str(root))
    try:
        spec = importlib.util.spec_from_file_location(
            f"reference_{name}", root / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.remove(str(root))


# ----------------------------------------------------------------------
# the shared ragged workload
# ----------------------------------------------------------------------

# the kernel bench's cases (batch 4, page 16, ctx 64 / 256 / 1024), the
# serve bench's data-path rows (4 slots, 64 or 512 tokens) and odd ones
@pytest.mark.parametrize("batch,max_len,page_size", [
    (4, 64, 16), (4, 256, 16), (4, 1024, 16), (4, 512, 16),
    (1, 1, 1), (3, 100, 7), (8, 33, 8), (5, 17, 16), (2, 7, 32)])
def test_ragged_paged_batch_equals_the_references(batch, max_len, page_size):
    assert common.ragged_paged_batch(batch, max_len, page_size) \
        == JC.ragged_paged_batch(batch, max_len, page_size)


# ----------------------------------------------------------------------
# the slab oracles
# ----------------------------------------------------------------------

N_LAYERS, N_PAGES, PAGE = 2, 7, 4


def _leaf(rng, shape, dtype):
    if dtype == "int8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    x = rng.standard_normal(shape).astype(np.float32)
    return x.astype(jnp.bfloat16) if dtype == "bf16" else x


def _pool(rng, dtype, nested=False, rows=N_PAGES * PAGE):
    """A numpy pool tree: [n_layers, n_pages, page, 3, 8] k/v leaves (or
    slab rows when `rows` is given as a (B, L) pair) with [.., 3, 1] f32
    scale leaves, optionally nested as a hybrid's shared block is."""
    lead = ((N_LAYERS, N_PAGES, PAGE) if isinstance(rows, int)
            else (N_LAYERS,) + rows)
    tree = {"k": _leaf(rng, lead + (3, 8), dtype),
            "v": _leaf(rng, lead + (3, 8), dtype),
            "k_scale": _leaf(rng, lead + (3, 1), "f32")}
    return {"shared": tree, "k": _leaf(rng, lead + (3, 8), dtype)} \
        if nested else tree


def _bits(x) -> np.ndarray:
    """Raw bits of a leaf of either package, for bit-for-bit equality."""
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
        return x
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _assert_trees_bit_equal(got, want):
    got, want = sorted(_flat(got)), sorted(_flat(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape), path
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(path))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flat(v, path + (k,))
        return out
    return [(path, tree)]


def _both(tree):
    return (interop.tree_from_numpy(tree, "cpu"),
            jax.tree.map(jnp.asarray, tree))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("nested", [False, True])
def test_gather_pages_equals_the_references(dtype, nested):
    rng = np.random.default_rng(1)
    pool_t, pool_j = _both(_pool(rng, dtype, nested))
    table = np.array([[3, 1, 0], [2, 6, 5], [4, 0, 0]], np.int32)
    got = PG.gather_pages(pool_t, torch.from_numpy(table))
    want = JPG.gather_pages(pool_j, jnp.asarray(table))
    assert got["k"].shape == (N_LAYERS, 3, 3 * PAGE, 3, 8)
    _assert_trees_bit_equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("nested", [False, True])
def test_scatter_decode_rows_equals_the_references(dtype, nested):
    rng = np.random.default_rng(2)
    pool = _pool(rng, dtype, nested)
    # an f32 slab written into bf16 / int8 pools: the cast is the oracle's
    slab = _pool(rng, "f32" if dtype == "bf16" else dtype, nested,
                 rows=(3, 3 * PAGE))
    pool_t, pool_j = _both(pool)
    slab_t, slab_j = _both(slab)
    fill = np.array([5, 0, 11], np.int32)
    page_ids = np.array([2, 6, 1], np.int32)
    offsets = np.array([1, 0, 3], np.int32)
    got = PG.scatter_decode_rows(pool_t, slab_t, *(torch.from_numpy(a) for a
                                                   in (fill, page_ids,
                                                       offsets)))
    want = JPG.scatter_decode_rows(pool_j, slab_j, *(jnp.asarray(a) for a in
                                                     (fill, page_ids,
                                                      offsets)))
    _assert_trees_bit_equal(got, want)
    # a copy: the pool handed in is left as it was
    _assert_trees_bit_equal(pool_t, jax.tree.map(jnp.asarray, pool))


def test_scatter_decode_rows_padded_slots_write_only_scratch():
    """Padded slots point at the scratch page: their duplicate writes land
    there and nowhere else (scratch holds garbage by contract)."""
    rng = np.random.default_rng(3)
    pool_t, pool_j = _both(_pool(rng, "f32"))
    slab_t, slab_j = _both(_pool(rng, "f32", rows=(4, 2 * PAGE)))
    fill = np.array([3, 6, 0, 0], np.int32)
    page_ids = np.array([4, 5, PG.SCRATCH_PAGE, PG.SCRATCH_PAGE], np.int32)
    offsets = np.array([2, 0, 0, 0], np.int32)
    got = PG.scatter_decode_rows(pool_t, slab_t, *(torch.from_numpy(a) for a
                                                   in (fill, page_ids,
                                                       offsets)))
    want = JPG.scatter_decode_rows(pool_j, slab_j, *(jnp.asarray(a) for a in
                                                     (fill, page_ids,
                                                      offsets)))
    for name in got:
        np.testing.assert_array_equal(got[name][:, 1:].numpy(),
                                      np.asarray(want[name])[:, 1:])


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("nested", [False, True])
def test_scatter_prefill_rows_equals_the_references(dtype, nested):
    rng = np.random.default_rng(4)
    pool = _pool(rng, dtype, nested)
    slab = _pool(rng, "f32" if dtype == "bf16" else dtype, nested,
                 rows=(1, 3 * PAGE))
    pool_t, pool_j = _both(pool)
    slab_t, slab_j = _both(slab)
    # a 6-token chunk at positions 3..8 of a sequence on pages 5, 2, 6
    positions = np.arange(3, 9, dtype=np.int32)
    table = np.array([5, 2, 6])
    page_ids = table[positions // PAGE].astype(np.int32)
    offsets = (positions % PAGE).astype(np.int32)
    got = PG.scatter_prefill_rows(pool_t, slab_t, *(
        torch.from_numpy(a) for a in (positions, page_ids, offsets)))
    want = JPG.scatter_prefill_rows(pool_j, slab_j, *(
        jnp.asarray(a) for a in (positions, page_ids, offsets)))
    _assert_trees_bit_equal(got, want)


def test_gather_then_scatter_round_trips():
    """A gathered slab scattered back row by row restores the pool."""
    rng = np.random.default_rng(5)
    pool = interop.tree_from_numpy(_pool(rng, "bf16"), "cpu")
    table = torch.tensor([[1, 4], [6, 2]], dtype=torch.int32)
    slab = PG.gather_pages(pool, table)
    blank = {k: torch.zeros_like(v) for k, v in pool.items()}
    for b in range(2):
        pos = torch.arange(2 * PAGE, dtype=torch.int32)
        one = {k: v[:, b:b + 1] for k, v in slab.items()}
        blank = PG.scatter_prefill_rows(blank, one, pos,
                                        table[b][pos.long() // PAGE],
                                        pos % PAGE)
    for k in pool:
        rows = table.reshape(-1).long()
        assert torch.equal(blank[k][:, rows], pool[k][:, rows])


# ----------------------------------------------------------------------
# row schemas: both packages refuse the same rows
# ----------------------------------------------------------------------

KERNEL_ROWS = [
    ({"op": "decode_ref", "decode_step_us": 12}, None),
    ({"op": "decode_ref"}, "missing required field"),
    ({"op": "mystery_op", "value": 1}, "unknown op family"),
    ({"decode_step_us": 12}, "missing 'op'"),
    ({"op": "paged_attention_early_exit", "ctx": 64, "kv_heads": 2,
      "q_heads": 4, "kv_splits": 1, "page_size": 16, "batch": 4,
      "pages_per_step": 10, "us_per_step": 1.0}, None),
    ({"op": "paged_attention_full_walk", "ctx": 64}, "missing required field"),
    ({"op": "fusion_hbm_byte_saving", "value": 0.571}, None),
    ({"op": "fusion_hbm_byte_saving"}, "missing required field"),
    ({"op": "swap_out_io", "pages": 8}, "missing required field"),
]


@pytest.mark.parametrize("row,refusal", KERNEL_ROWS)
def test_kernel_bench_schema_refuses_what_the_reference_refuses(row, refusal):
    ref = _load_reference("kernel_bench")
    for check in (ref._check_schema, kernel_bench._check_schema):
        if refusal is None:
            check([row])
        else:
            with pytest.raises(ValueError, match=refusal):
                check([row])


def test_kernel_bench_schema_takes_the_ports_fields():
    """The port's hadamard and swap rows carry its own fields (device
    times, the H100 bound, the copy's device time)."""
    rows = [{"op": "block_hadamard_b32", "kernel_us": 1.0, "plain_us": 2.0,
             "model_bytes": 4, "model_flops": 8, "h100_bound_us": 0.5,
             "bound": "memory"},
            {"op": "swap_in_io", "pages": 8, "bytes_per_cycle": 1,
             "us_per_cycle": 1.0, "gib_per_s": 1.0, "copy_device_ms": None}]
    kernel_bench._check_schema(rows)
    for row in rows:
        for field in ("h100_bound_us", "copy_device_ms"):
            if field in row:
                with pytest.raises(ValueError,
                                   match="missing required field"):
                    kernel_bench._check_schema([{
                        k: v for k, v in row.items() if k != field}])


SERVE_ROWS = [
    ({"path": "x", "family": "dense", "tokens_per_s": 1}, None),
    ({"path": "x", "family": "dense"}, "missing required field"),
    ({"path": "x", "tokens_per_s": 1}, "missing required field"),
    ({"family": "dense", "tokens_per_s": 1}, None),
]


@pytest.mark.parametrize("row,refusal", SERVE_ROWS)
def test_serve_bench_schema_refuses_what_the_reference_refuses(row, refusal):
    ref = _load_reference("serve_bench")
    for check in (ref._check_schema, serve_bench._check_schema):
        if refusal is None:
            check([row])
        else:
            with pytest.raises(ValueError, match=refusal):
                check([row])


# ----------------------------------------------------------------------
# the mains and the gated traces, reduced, on the CPU
# ----------------------------------------------------------------------

# the reference's smoke run: its paged-attention cases, its decode pair
# and its swap pair (`benchmarks/kernel_bench.py::main` with --smoke)
KERNEL_SMOKE_OPS = (
    ["paged_attention_full_walk", "paged_attention_early_exit"] * 2
    + ["decode_ref", "decode_kernels", "swap_out_io", "swap_in_io"])
SERVE_ROW_NAMES = [
    "legacy_sched_bf16", "engine_bf16", "engine_int4_kvbf16",
    "engine_int4_kv8", "engine_bf16_ssm", "engine_bf16_hybrid",
    "engine_bf16_moe", "engine_burst_reserve", "engine_burst_optimistic",
    "engine_swap_recompute", "engine_swap_swap", "engine_prefix_off",
    "engine_prefix_on", "attn_slab_gather", "attn_paged_kernel"]


def test_kernel_bench_main_smoke_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "kernels.json"
    for n in (1, 2):
        kernel_bench.main(["--smoke", "--reduced", "--device", "cpu",
                           "--out", str(out)])
        history = json.loads(out.read_text())["history"]
        assert len(history) == n
    entry = history[-1]
    assert entry["bench"] == "kernels" and entry["clock"] == "host"
    assert entry["device"] == {"platform": "cpu"} and entry["smoke"]
    assert [r["op"] for r in entry["rows"]] == KERNEL_SMOKE_OPS
    walked = {r["op"]: r["pages_per_step"] for r in entry["rows"][:2]}
    assert walked == {"paged_attention_full_walk": 16,
                      "paged_attention_early_exit": 10}
    swap = entry["rows"][-2:]
    assert all(r["copy_device_ms"] is None and r["bytes_per_cycle"] > 0
               for r in swap)
    assert "wrote" in capsys.readouterr().out


def test_serve_bench_main_smoke_on_the_cpu(tmp_path):
    out = tmp_path / "serve.json"
    serve_bench.main(["--smoke", "--reduced", "--device", "cpu",
                      "--out", str(out)])
    entry = json.loads(out.read_text())["history"][-1]
    assert entry["bench"] == "serve" and entry["clock"] == "host"
    assert entry["device"] == {"platform": "cpu"}
    from repro_torch.serve.telemetry import SCHEMA_VERSION
    assert entry["metrics_schema_version"] == SCHEMA_VERSION
    assert [r["path"] for r in entry["rows"]] == SERVE_ROW_NAMES
    rows = {r["path"]: r for r in entry["rows"]}
    assert rows["engine_bf16"]["pages_walked_per_step"] \
        < rows["engine_bf16"]["pages_dense_per_step"]
    # the data path's two rows agree on their output, f32 on the CPU
    assert rows["attn_paged_kernel"]["max_abs_diff_vs_slab"] < 2e-5
    assert rows["attn_slab_gather"]["gathered_bytes_per_step"] > 0
    # a history stamped with a newer telemetry schema refuses the append
    out.write_text(json.dumps({"history": [
        {"metrics_schema_version": SCHEMA_VERSION + 1}]}))
    with pytest.raises(SystemExit, match="metrics_schema_version"):
        serve_bench.main(["--smoke", "--reduced", "--device", "cpu",
                          "--out", str(out)])


@pytest.mark.parametrize("main", [kernel_bench.main, serve_bench.main])
def test_mains_exit_without_a_card(main, monkeypatch, tmp_path):
    """`--device cuda` (the default) never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--smoke", "--reduced", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
    assert T.device_record(torch.device("cpu")) == {"platform": "cpu"}


@pytest.fixture(scope="module")
def bf16_adapter():
    cfg = get_config("llama3-1b").reduced()
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, as_servable(model, model.init(gen))


def test_burst_trace_shows_the_optimistic_admission_win(bf16_adapter):
    cfg, adapter = bf16_adapter
    res, opt = serve_bench.bench_burst(adapter, n_tenants=4, prompt_len=8,
                                       max_new=16, page_size=8,
                                       vocab=cfg.vocab)
    assert opt["preemptions"] >= 1 and res["preemptions"] == 0
    assert opt["peak_util"] > res["peak_util"]


def test_swap_trace_shows_the_swap_tier_win(bf16_adapter):
    cfg, adapter = bf16_adapter
    rec, sw = serve_bench.bench_swap(adapter, vocab=cfg.vocab)
    assert sw["replayed_prefill_tokens"] == 0 < rec["replayed_prefill_tokens"]
    assert sw["swap_out"] == sw["swap_in"] >= 1 and sw["swap_fallbacks"] == 0


def test_prefix_trace_shows_the_radix_cache_win(bf16_adapter):
    cfg, adapter = bf16_adapter
    off, on = serve_bench.bench_prefix(adapter, vocab=cfg.vocab)
    assert 2 * on["prefill_tokens"] <= off["prefill_tokens"]
    assert on["prefix_hits"] > 0 and off["prefix_hits"] == 0
