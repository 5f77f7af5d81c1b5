"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU and `nvcc`; without a CUDA device each one
skips. Run them on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

(`python3 chip_smoke.py` runs the same comparisons at the serving path's
full-width shapes and then serves a model through the kernels.)
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.synthetic import inject_outlier_channels
from repro_torch.kernels import _scratch
from repro_torch.kernels import block_hadamard as BH
from repro_torch.kernels import hadamard_quant as HQ
from repro_torch.kernels import int4_matmul as I4
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_attention as PA
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import (EngineRequest, SamplingParams,
                                      ServeEngine, as_servable)
from repro_torch.serve.quantized import QuantizedDenseLM, pack_dense_params
from repro_torch.serve.telemetry import QualityProbes

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("d,b", [(256, 1), (512, 16), (4096, 64), (384, 12),
                                 (19200, 64), (19200, 12)])   # > 48 KB rows
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hadamard_quant_kernel(dev, d, b, dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((9, d)).astype(np.float32) * 3)
    x = x.to(dev).to(dtype)
    before = HQ.LAUNCHES["hadamard_quant"]
    codes, s, z = kops.hadamard_quant(x, b)
    assert HQ.LAUNCHES["hadamard_quant"] == before + 1
    pc, ps, pz = HQ.hadamard_quant_plain(x, b)
    torch.testing.assert_close(s, ps, rtol=1e-6, atol=0)
    diff = (codes.int() - pc.int()).abs()
    # codes differ only at rounding ties of the two summation orders
    assert float((diff != 0).float().mean()) <= 1e-3 and int(diff.max()) <= 1


def _hq_input(dev, m, d, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32) * 3)
    x[:, ::29] *= 12.0
    return x.to(dev).to(dtype)


def _hq_close_to_plain(x, b, codes, s, z):
    """The rule against the plain version (a dense product): scale to
    1e-6 relative, codes equal but at rounding ties of the two summation
    orders (at most 0.1 % of entries, one step)."""
    pc, ps, pz = HQ.hadamard_quant_plain(x, b)
    torch.testing.assert_close(s, ps, rtol=1e-6, atol=0)
    zd = float((z - pz).abs().max())
    assert zd <= 1.0
    diff = (codes.int() - pc.int()).abs()
    assert float((diff != 0).float().mean()) <= 1e-3 and int(diff.max()) <= 1 + int(zd)


def _hq_equal_to_block_hadamard(x, b, codes, s, z):
    """Both kernels run one butterfly, and the plain quantiser divides as the
    kernel does: codes, scale and zero bit-equal (f32 input)."""
    wc, ws, wz = HQ.quantize_act_plain(BH.block_hadamard(x, b))
    assert torch.equal(codes, wc) and torch.equal(s, ws) and torch.equal(z, wz)


# (m, d, b): every plan kind - registers + shuffles, shared-memory rounds
# (b > 32 E), dense operand (Paley) - at each cluster size the plan takes
# (8, 4 and 2 slices a row, and 1: a plain launch), uneven slices
HQ_CASES = [(1, 2048, 1), (4, 2048, 1), (4, 8192, 16), (32, 8192, 16), (37, 8192, 16),
            (37, 2048, 32), (4, 19200, 64), (37, 19200, 64), (4, 18, 2), (9, 240, 4),
            (4, 8192, 512), (4, 8192, 8192), (3, 32768, 32768), (2, 4096, 2048),
            (4, 3072, 12), (37, 19200, 12), (4, 2304, 768), (5, 240, 20), (200, 2048, 16)]


@pytest.mark.parametrize("m,d,b", HQ_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hadamard_quant_cluster_kernel(dev, m, d, b, dtype):
    x = _hq_input(dev, m, d, dtype, m + d + b)
    before = HQ.LAUNCHES["hadamard_quant"]
    codes, s, z = kops.hadamard_quant(x, b)
    assert HQ.LAUNCHES["hadamard_quant"] == before + 1
    assert codes.shape == x.shape and s.shape == z.shape == (m, 1)
    _hq_close_to_plain(x, b, codes, s, z)
    if dtype == torch.float32 and b & (b - 1) == 0:
        _hq_equal_to_block_hadamard(x, b, codes, s, z)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("elems", [4, 8, 16])
@pytest.mark.parametrize("m,d,b", [(4, 2048, 1), (4, 8192, 16), (32, 8192, 16),
                                   (4, 19200, 64)])
def test_hadamard_quant_sweep_plans(dev, monkeypatch, m, d, b, cluster, elems):
    """The plans `chip_smoke.py --sweep` times, each bit-equal to the
    butterfly of block_hadamard + the plain quantiser. A row that does not
    fit the fixed cluster at E elements a thread takes a larger E."""
    monkeypatch.setattr(HQ, "PLAN_CLUSTER", cluster)
    monkeypatch.setattr(HQ, "PLAN_ELEMS", elems)
    p = HQ.hadamard_quant_plan(m, d, b)
    assert p.cluster == cluster and p.elems >= elems
    x = _hq_input(dev, m, d, torch.float32, 7)
    codes, s, z = kops.hadamard_quant(x, b)
    _hq_equal_to_block_hadamard(x, b, codes, s, z)


@pytest.mark.parametrize("m,d,b", [(4, 2048, 1), (4, 8192, 16), (37, 19200, 64),
                                   (4, 8192, 8192), (4, 3072, 12)])
def test_hadamard_quant_nan_stays_in_its_row(dev, m, d, b):
    """A NaN makes its row's scale NaN; every other row's codes, scale and
    zero are bit-equal to the run without it: a cluster never reads across
    rows."""
    x = _hq_input(dev, m, d, torch.float32, 9)
    clean = kops.hadamard_quant(x, b)
    bad = x.clone()
    bad[m // 2, d - 3] = float("nan")
    dirty = kops.hadamard_quant(bad, b)
    assert bool(dirty[1][m // 2].isnan().all())
    keep = torch.arange(m, device=dev) != m // 2
    for got, want in zip(dirty, clean):
        assert torch.equal(got[keep], want[keep])


def test_hadamard_quant_graph_replay(dev):
    """The cluster launch captured in a CUDA graph, replayed on new input
    written into the captured buffer."""
    x = _hq_input(dev, 4, 8192, torch.bfloat16, 10)
    kops.hadamard_quant(x, 16)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kops.hadamard_quant(x, 16)
    for seed in (11, 12):
        x.copy_(_hq_input(dev, 4, 8192, torch.bfloat16, seed))
        graph.replay()
        torch.cuda.synchronize()
        want = kops.hadamard_quant(x, 16)
        for got, w in zip(out, want):
            assert torch.equal(got, w)


def test_hadamard_quant_misaligned_and_strided_input(dev):
    base = _hq_input(dev, 1, 4 * 2048 + 1, torch.bfloat16, 13)
    x = base[0, 1:].view(4, 2048)
    assert x.data_ptr() % 16
    codes, s, z = kops.hadamard_quant(x, 16)
    _hq_close_to_plain(x, 16, codes, s, z)
    xt = _hq_input(dev, 2048, 4, torch.float32, 14).t()
    codes, s, z = kops.hadamard_quant(xt, 16)
    _hq_equal_to_block_hadamard(xt.contiguous(), 16, codes, s, z)


def test_hadamard_quant_launch_refuses_a_plan_that_disagrees(dev):
    from repro_torch.kernels import _build
    lib = _build.load()
    x = torch.zeros((4, 2048), dtype=torch.float32, device=dev)
    codes = torch.empty((4, 2048), dtype=torch.int8, device=dev)
    sz = torch.empty((2, 4), dtype=torch.float32, device=dev)
    p = HQ.hadamard_quant_plan(4, 2048, 16)

    def call(**change):
        a = {"kind": 0, "elems": p.elems, "threads": p.threads, "cluster": p.cluster,
             "grid": p.grid, "smem": p.smem_bytes, **change}
        return lib.hadamard_quant_launch(x.data_ptr(), 0, None, codes.data_ptr(),
                                         sz[0].data_ptr(), sz[1].data_ptr(), 4, 2048, 16, 4,
                                         *a.values(), torch.cuda.current_stream().cuda_stream)

    assert call() == 0
    for change in ({"kind": 1}, {"elems": 4}, {"threads": p.threads + 32},
                   {"cluster": 16, "grid": 64}, {"grid": p.grid + 1}, {"smem": 16}):
        assert call(**change) != 0, change
    torch.cuda.synchronize()


@pytest.mark.parametrize("m,k,n", [(1, 64, 8), (4, 2048, 512), (37, 250, 514),
                                   (130, 512, 1024),
                                   # decode- and prefill-sized M, ragged tiles
                                   (1, 2048, 2048), (16, 2048, 2048), (17, 2048, 2048),
                                   (32, 8192, 512), (33, 1024, 1024), (130, 2048, 640),
                                   (4, 250, 514), (16, 250, 514), (17, 250, 514),
                                   (33, 250, 514), (1, 4096, 8192)])
def test_int4_matmul_kernel(dev, m, k, n):
    rng = np.random.default_rng(1)
    qa = torch.from_numpy(rng.integers(0, 16, (m, k)).astype(np.int8)).to(dev)
    wc = torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.int8)).to(dev)
    wp = I4.int4_pack(wc)
    sa = torch.from_numpy(rng.uniform(0.01, 0.2, (m, 1)).astype(np.float32)).to(dev)
    za = torch.from_numpy(np.round(rng.uniform(-12, 0, (m, 1))).astype(np.float32)).to(dev)
    sw = torch.from_numpy(rng.uniform(0.001, 0.02, (n,)).astype(np.float32)).to(dev)
    before = I4.LAUNCHES["int4_matmul"]
    out = kops.int4_matmul(qa, sa, za, wp, sw)
    assert I4.LAUNCHES["int4_matmul"] == before + 1
    with kops.use_kernels(False):
        want = kops.int4_matmul(qa, sa, za, wp, sw)
    # same integers, same three f32 roundings in the same order
    torch.testing.assert_close(out, want, rtol=1e-6, atol=0)
    acc = I4.int4_matmul(qa, torch.ones_like(sa), torch.zeros_like(za), wp,
                         torch.ones_like(sw))
    assert torch.equal(acc.double(), qa.double() @ wc.double())


def _integer_part(qa, wp):
    """The kernel's float(q_a @ q_w): unit scales and a zero offset."""
    m, n = qa.shape[0], wp.shape[1]
    one_m = torch.ones((m, 1), dtype=torch.float32, device=qa.device)
    one_n = torch.ones((n,), dtype=torch.float32, device=qa.device)
    return I4.int4_matmul(qa, one_m, torch.zeros_like(one_m), wp, one_n)


@pytest.mark.parametrize("k", [8192, 16384])
@pytest.mark.parametrize("m", [4, 32])
@pytest.mark.parametrize("a_code,w_code", [(15, -8), (0, 7), (-128, -8), (127, 7)])
def test_int4_matmul_extreme_codes(dev, m, k, a_code, w_code):
    """The largest products the int32 accumulator sees (|sum| up to
    128 * 8 * 16384 = 2^24), bit-equal to the exact integer product."""
    n = 1024
    qa = torch.full((m, k), a_code, dtype=torch.int8, device=dev)
    wc = torch.full((k, n), w_code, dtype=torch.int8, device=dev)
    got = _integer_part(qa, I4.int4_pack(wc))
    assert torch.equal(got.double(), torch.full_like(got.double(), float(a_code * w_code * k)))


@pytest.mark.parametrize("m,k,n", [(4, 2048, 8192), (32, 8192, 2048), (130, 2048, 512)])
def test_int4_matmul_graph_replay(dev, m, k, n):
    """Captured in a CUDA graph and replayed twice: the same output as the
    eager call each time, so the split workspace and its counters are left
    zero by every launch."""
    rng = np.random.default_rng(4)
    qa = torch.from_numpy(rng.integers(0, 16, (m, k)).astype(np.int8)).to(dev)
    wp = torch.from_numpy(rng.integers(0, 256, (k // 2, n)).astype(np.uint8)).to(dev)
    assert I4.int4_plan(m, n, k).splits > 1
    want = _integer_part(qa, wp)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _integer_part(qa, wp)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert torch.equal(_integer_part(qa, wp), want)


def test_int4_matmul_graph_keeps_its_workspace(dev, monkeypatch):
    """A graph captured at M = 4; then an eager call at M = 32 grows the
    split workspace, and tensors of the old pair's sizes are allocated and
    filled - until one lands on the old pair's memory, if the allocator has
    it back. The replays must still give the eager result bit for bit and
    leave those tensors alone: the old pair stays the graph's."""
    monkeypatch.setattr(I4, "_WORKSPACE", {})
    rng = np.random.default_rng(8)
    k, n = 2048, 8192
    qa = torch.from_numpy(rng.integers(0, 16, (4, k)).astype(np.int8)).to(dev)
    wp = torch.from_numpy(rng.integers(0, 256, (k // 2, n)).astype(np.uint8)).to(dev)
    assert I4.int4_plan(4, n, k).splits > 1 and I4.int4_plan(32, n, k).splits > 1
    want = _integer_part(qa, wp)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _integer_part(qa, wp)
    key = torch.cuda.current_device()
    old_ws, old_cnt = I4._WORKSPACE[key]
    qa32 = torch.from_numpy(rng.integers(0, 16, (32, k)).astype(np.int8)).to(dev)
    want32 = qa32.double() @ I4.int4_unpack(wp).double()
    assert torch.equal(_integer_part(qa32, wp).double(), want32)
    assert I4._WORKSPACE[key][0].numel() > old_ws.numel()      # it grew
    sizes = (old_ws.numel(), old_cnt.numel())
    old_ptrs = {old_ws.data_ptr(), old_cnt.data_ptr()}
    del old_ws, old_cnt
    pattern = 0x5A5A5A5A
    fills = []
    for _ in range(256):
        fills += [torch.full((n_,), pattern, dtype=torch.int32, device=dev) for n_ in sizes]
        if old_ptrs & {f.data_ptr() for f in fills[-2:]}:
            break
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert all(bool((f == pattern).all()) for f in fills)
    assert torch.equal(_integer_part(qa32, wp).double(), want32)


@pytest.mark.parametrize("m,k,n", [(4, 512, 256), (33, 512, 256)])
def test_int4_matmul_misaligned_operands(dev, m, k, n):
    """Codes and packed weights that start at an odd byte offset."""
    rng = np.random.default_rng(5)
    qa_buf = torch.from_numpy(rng.integers(0, 16, m * k + 3).astype(np.int8)).to(dev)
    w_buf = torch.from_numpy(rng.integers(0, 256, k // 2 * n + 5).astype(np.uint8)).to(dev)
    qa = qa_buf[3:].view(m, k)
    wp = w_buf[5:].view(k // 2, n)
    assert qa.data_ptr() % 16 and wp.data_ptr() % 16
    want = qa.double() @ I4.int4_unpack(wp).double()
    assert torch.equal(_integer_part(qa, wp).double(), want)


def test_launches_refuse_a_plan_that_disagrees(dev):
    """The C launches check the Python plan against their own geometry."""
    from repro_torch.kernels import _build
    lib = _build.load()
    qa = torch.zeros((4, 256), dtype=torch.int8, device=dev)
    wp = torch.zeros((128, 512), dtype=torch.uint8, device=dev)
    f = torch.zeros(512, dtype=torch.float32, device=dev)
    cs = torch.zeros(512, dtype=torch.int32, device=dev)
    out = torch.empty((4, 512), dtype=torch.float32, device=dev)
    p = I4.int4_plan(4, 512, 256)
    args = dict(rows=p.rows, k_rows=p.k_rows, splits=p.splits, threads=p.threads,
                gx=p.grid[0], gy=p.grid[1], gz=p.grid[2],
                smem=p.smem_bytes)
    ws, cnt = _scratch.zeroed(I4._WORKSPACE, dev, (4 * 512, 64), "int4_matmul")

    def call(**change):
        a = {**args, **change}
        return lib.int4_matmul_launch(
            qa.data_ptr(), wp.data_ptr(), ws.data_ptr(), cnt.data_ptr(), f.data_ptr(),
            f.data_ptr(), f.data_ptr(), cs.data_ptr(), out.data_ptr(), 4, 512, 256,
            *a.values(), torch.cuda.current_stream().cuda_stream)

    assert call() == 0
    for change in ({"threads": 64}, {"k_rows": p.k_rows - 1}, {"gx": p.grid[0] + 1},
                   {"smem": p.smem_bytes + 8}, {"rows": 64}, {"splits": p.splits + 1}):
        assert call(**change) != 0, change
    torch.cuda.synchronize()
    x = torch.zeros((4, 64), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    hp = BH.hadamard_plan(4, 64, 16)

    def bh(**change):
        a = {"kind": 0, "elems": hp.elems, "threads": hp.threads, "grid": hp.grid,
             "smem": hp.smem_bytes, **change}
        return lib.block_hadamard_launch(x.data_ptr(), 0, None, y.data_ptr(), 4, 64, 16,
                                         *a.values(), torch.cuda.current_stream().cuda_stream)

    assert bh() == 0
    for change in ({"kind": 1}, {"elems": 1}, {"grid": hp.grid + 1}, {"threads": 48}):
        assert bh(**change) != 0, change
    torch.cuda.synchronize()


def _attention_inputs(dev, fmt, t, s, g, dh, lens, n_cols, q_dtype=torch.float32,
                      group=None, kh=2, seed=2):
    """One seeded case: (args, keyword arguments but kv_splits) of a
    `paged_attention` call."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    n_pages = 1 + b * n_cols
    shape = (n_pages, t, kh, dh)
    bits = {"float": None, "bf16": None, "int8": 8, "int4": 4}[fmt]
    group = group or dh
    if bits is None:
        kv = {n: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              for n in ("k", "v")}
        if fmt == "bf16":
            kv = {n: a.to(torch.bfloat16) for n, a in kv.items()}
    else:
        kv = {}
        for n in ("k", "v"):
            kv[n] = torch.from_numpy(
                (rng.integers(0, 2 ** bits, shape) - 2 ** (bits - 1)).astype(np.int8))
            kv[n + "_scale"] = torch.from_numpy(rng.uniform(
                0.002, 0.2 / 2 ** (bits - 4), shape[:-1] + (dh // group,)).astype(np.float32))
            kv[n + "_zero"] = torch.from_numpy(np.round(rng.uniform(
                -(2 ** bits), 0, shape[:-1] + (dh // group,))).astype(np.float32))
    kv = {n: a.to(dev) for n, a in kv.items()}
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, n_cols), np.int32)
    for i, ln in enumerate(lens):
        bt[i, :-(-ln // t)] = perm[i * n_cols:i * n_cols + -(-ln // t)]
    q = torch.from_numpy(rng.standard_normal((b, s, kh * g, dh)).astype(np.float32))
    q = q.to(dev).to(q_dtype)
    qpos = torch.tensor([list(range(max(ln - s, 0), max(ln - s, 0) + s)) for ln in lens],
                        dtype=torch.int32, device=dev)
    args = (q, kv, torch.from_numpy(bt).to(dev), qpos,
            torch.tensor(lens, dtype=torch.int32, device=dev))
    return args, dict(rope_theta=10000.0 if bits else None, kv_bits=bits,
                      kv_group=group if bits else None)


def _attention_case(dev, fmt, t, s, g, dh, lens, n_cols, kv_splits=None,
                    q_dtype=torch.float32, group=None, kh=2):
    """The kernel against its plain version on one seeded case; returns the
    kernel's output. One launch, which merges the splits when there are
    several."""
    args, kw = _attention_inputs(dev, fmt, t, s, g, dh, lens, n_cols, q_dtype, group, kh)
    kw["kv_splits"] = kv_splits
    splits = PA.resolve_tiling(s, kh, n_cols, kv_splits=kv_splits)[1]
    before = dict(PA.LAUNCHES)
    out = kops.paged_attention(*args, **kw)
    assert PA.LAUNCHES["paged_attention"] == before["paged_attention"] + 1
    assert PA.LAUNCHES["combine_partials"] == before["combine_partials"] + (splits > 1)
    with kops.use_kernels(False):
        want = kops.paged_attention(*args, **kw)
    # f32 throughout (3xTF32 products keep f32 accuracy), other summation
    # order, the softmax updated per tile instead of per page
    torch.testing.assert_close(out, want, rtol=0, atol=2e-5)
    for i, ln in enumerate(lens):
        if ln == 0:
            assert bool((out[i] == 0).all())
    return out


@pytest.mark.parametrize("fmt", ["float", "int8", "int4"])
@pytest.mark.parametrize("s,lens,n_cols", [(1, [50, 0, 17], 8), (8, [24, 8, 13], 4)])
@pytest.mark.parametrize("g,dh", [(3, 32), (7, 128)])   # the latter needs > 48 KB
def test_paged_attention_kernel(dev, fmt, s, lens, n_cols, g, dh):
    _attention_case(dev, fmt, 8, s, g, dh, lens, n_cols)


# (fmt, T, S, G, dh, lens, table columns, kv_splits, q dtype, group, rows)
# Contexts end mid-page and mid-tile; 12-column tables hold several tiles, so
# the copy of tile i+1 overlaps tile i; G = 3 and 7 pad a warp's 16 rows; a
# plan of 64 rows per block puts rows of one block in several warps and pads
# S (128 rows: eight row warps, no key warps); explicit splits run with a
# length-0 row.
TILE_CASES = [
    ("int4", 8, 32, 4, 64, [96, 45, 33], 12, None, torch.float32, None, None),
    ("int8", 16, 8, 3, 80, [190, 70, 0], 12, None, torch.bfloat16, None, None),
    ("float", 32, 1, 7, 96, [300, 0, 33], 12, None, torch.float32, None, None),
    ("int4", 16, 32, 7, 128, [180, 100, 40], 12, None, torch.bfloat16, None, None),
    ("int4", 8, 1, 4, 128, [90, 0, 41], 12, 3, torch.float32, None, None),
    ("bf16", 32, 8, 3, 64, [150, 0, 70], 6, 2, torch.bfloat16, None, None),
    ("int4", 16, 1, 4, 64, [500, 0, 260], 32, None, torch.bfloat16, None, None),
    ("float", 16, 32, 4, 96, [192, 33, 0], 12, None, torch.float32, None, None),
    ("bf16", 8, 8, 3, 80, [96, 61, 9], 12, None, torch.float32, None, None),
    ("int8", 16, 8, 4, 64, [170, 100, 16], 12, None, torch.float32, 16, None),
    ("int4", 16, 32, 3, 80, [180, 64, 0], 12, None, torch.float32, None, 64),
    ("bf16", 8, 32, 7, 128, [96, 50, 20], 12, None, torch.bfloat16, None, 64),
    ("float", 32, 8, 4, 64, [350, 8, 200], 12, 3, torch.float32, None, 64),
    ("int4", 16, 32, 4, 64, [180, 100, 40], 12, None, torch.float32, None, 128),
]


@pytest.mark.parametrize(
    "fmt,t,s,g,dh,lens,n_cols,kv_splits,q_dtype,group,rows", TILE_CASES,
    ids=[f"{c[0]}-T{c[1]}-S{c[2]}-G{c[3]}-dh{c[4]}-{i}" for i, c in enumerate(TILE_CASES)])
def test_paged_attention_kernel_tiles(dev, monkeypatch, fmt, t, s, g, dh, lens, n_cols,
                                      kv_splits, q_dtype, group, rows):
    if rows is not None:
        monkeypatch.setattr(PA, "PLAN_ROWS", rows)
        plan = PA.attention_plan(g, s, dh, t, torch.int8 if fmt.startswith("int")
                                 else torch.float32, group=group)
        assert plan.warps > 1
    _attention_case(dev, fmt, t, s, g, dh, lens, n_cols, kv_splits, q_dtype, group)


# The split merge in the kernel's last-arriving block: no split, 2 and 3
# splits, 8 of one column each, 13 over a 16-column table (splits 8-12 lie
# past the table); dead splits and a row of length 0 in every case.
MERGE_SPLITS = [1, 2, 3, 8, 13]


@pytest.mark.parametrize("ks", MERGE_SPLITS)
@pytest.mark.parametrize("fmt", ["int4", "bf16"])
def test_paged_attention_fused_merge(dev, fmt, ks):
    n_cols = 16 if ks == 13 else 8
    _attention_case(dev, fmt, 16, 1, 4, 64, [n_cols * 16 - 6, 0, 37, 113], n_cols, ks,
                    torch.bfloat16, kh=8)


@pytest.mark.parametrize("ks", [2, 8, 13])
def test_paged_attention_merge_is_bit_stable(dev, ks):
    """The splits finish in another order on every launch; the merge reads
    them in split order, so 20 launches give one bit pattern."""
    n_cols = 16 if ks == 13 else 8
    args, kw = _attention_inputs(dev, "int4", 16, 1, 4, 64, [n_cols * 16 - 6, 0, 37, 113],
                                 n_cols, torch.bfloat16, kh=8)
    first = PA.paged_attention(*args, kv_splits=ks, **kw)
    for _ in range(19):
        assert torch.equal(PA.paged_attention(*args, kv_splits=ks, **kw), first)


def _counters_zero():
    return all(not bool(c.any()) for cs in PA._COUNTERS.values() for c in cs)


def test_paged_attention_graph_replay(dev):
    """A split decode call captured in a CUDA graph, then replayed over
    several steps whose lengths, positions and tables change through the
    captured buffers: each replay bit-equal to the eager call on the same
    inputs, and every merge counter zero after every replay."""
    lens0 = [200, 0, 37, 113]
    args, kw = _attention_inputs(dev, "int4", 16, 1, 4, 64, lens0, 16, torch.bfloat16,
                                 kh=8, seed=11)
    q, kv, bt, qpos, lens = args
    assert PA.resolve_tiling(1, 8, 16)[1] > 1
    PA.paged_attention(*args, **kw)              # counters allocated outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = PA.paged_attention(*args, **kw)
    rng = np.random.default_rng(12)
    n_pages = kv["k"].shape[0]
    for step in range(4):
        new_lens = [int(x) for x in rng.integers(0, 16 * 16, 4)]
        new_lens[step % 4] = 0
        table = np.zeros((4, 16), np.int32)
        for i, ln in enumerate(new_lens):
            table[i, :-(-ln // 16)] = rng.choice(np.arange(1, n_pages), -(-ln // 16), False)
        bt.copy_(torch.from_numpy(table))
        lens.copy_(torch.tensor(new_lens, dtype=torch.int32))
        qpos.copy_(torch.tensor([[max(ln - 1, 0)] for ln in new_lens], dtype=torch.int32))
        q.copy_(torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)))
        graph.replay()
        torch.cuda.synchronize()
        assert _counters_zero()
        assert torch.equal(out, PA.paged_attention(*args, **kw))
        assert _counters_zero()


def test_paged_attention_graph_keeps_its_counters(dev, monkeypatch):
    """A graph captured over a split call on 4 rows; then an eager call on
    32 rows grows the merge counters, and tensors of the old array's size
    are allocated and filled - until one lands on the old array's memory, if
    the allocator has it back. The replays must still give the eager result
    bit for bit and leave those tensors alone: the old array stays the
    graph's."""
    monkeypatch.setattr(PA, "_COUNTERS", {})
    lens4 = [120, 0, 37, 113]
    args, kw = _attention_inputs(dev, "int4", 16, 1, 4, 64, lens4, 8, torch.bfloat16, kh=8)
    want = PA.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = PA.paged_attention(*args, **kw)
    key = torch.cuda.current_device()
    (old,) = PA._COUNTERS[key]
    args32, _ = _attention_inputs(dev, "int4", 16, 1, 4, 64, lens4 * 8, 8, torch.bfloat16,
                                  kh=8, seed=3)
    want32 = PA.paged_attention(*args32, **kw)
    assert PA._COUNTERS[key][0].numel() > old.numel()           # it grew
    size, old_ptr = old.numel(), old.data_ptr()
    del old
    pattern = 0x5A5A5A5A
    fills = []
    for _ in range(256):
        fills.append(torch.full((size,), pattern, dtype=torch.int32, device=dev))
        if fills[-1].data_ptr() == old_ptr:
            break
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert all(bool((f == pattern).all()) for f in fills)
    assert torch.equal(PA.paged_attention(*args32, **kw), want32)


@pytest.mark.parametrize("shape,b", [((4, 1, 8192), 16), ((37, 2048), 1),
                                     ((5, 384), 12), ((3, 19200), 64),
                                     ((9, 2048), 2048), ((2, 3, 768), 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_hadamard_kernel(dev, shape, b, dtype):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3)
    x[..., ::29] *= 20.0
    x = x.to(dev).to(dtype)
    before = BH.LAUNCHES["block_hadamard"]
    y = kops.block_hadamard(x, b)
    assert BH.LAUNCHES["block_hadamard"] == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    want = BH.block_hadamard_plain(x, b)
    # a butterfly (or a b-wide dot product) against a dense product: the
    # same f32 sums in another order, within 2e-5 of max|y|; a bf16 output
    # is that f32 value rounded once, so one bf16 ulp (2^-7 relative) more
    atol = 2e-5 * float(want.float().abs().max())
    rtol = 0 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), want.float(), rtol=rtol, atol=atol)
    poisoned = x.clone()
    poisoned[0, ..., 0] = float("nan")
    out = kops.block_hadamard(poisoned, b)
    assert bool(out[0, ..., :b].isnan().all())
    assert bool(out[1:].isfinite().all())


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 2048, 12, 20])
@pytest.mark.parametrize("m", [1, 4, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_hadamard_kernel_orders(dev, b, m, dtype):
    """Every launch-plan kind (registers and shuffles, one block per
    b-block, dense operand) at ragged row counts; a NaN poisons exactly its
    own block."""
    d = 4096 if b & (b - 1) == 0 else 240            # at least two blocks
    rng = np.random.default_rng(b + m)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32) * 3)
    x = x.to(dev).to(dtype)
    y = kops.block_hadamard(x, b)
    want = BH.block_hadamard_plain(x, b)
    atol = 2e-5 * float(want.float().abs().max())
    rtol = 0 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), want.float(), rtol=rtol, atol=atol)
    poisoned = x.clone()
    poisoned[m - 1, b] = float("nan")                # first entry of block 1
    out = kops.block_hadamard(poisoned, b)
    assert bool(out[m - 1, b:2 * b].isnan().all())
    assert int(out.isnan().sum()) == b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_hadamard_kernel_non_contiguous(dev, dtype):
    rng = np.random.default_rng(6)
    base = torch.from_numpy(rng.standard_normal((512, 12)).astype(np.float32))
    x = base.to(dev).to(dtype).t()                   # [12, 512], strided
    assert not x.is_contiguous()
    for b in (16, 512, 4):
        y = kops.block_hadamard(x, b)
        want = BH.block_hadamard_plain(x.contiguous(), b)
        atol = 2e-5 * float(want.float().abs().max())
        rtol = 0 if dtype == torch.float32 else 2 ** -7
        torch.testing.assert_close(y.float(), want.float(), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# The engine's decode step as one captured CUDA graph per variant
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served_gpu():
    """The reduced llama3-1b, seeded and packed on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    cfg = get_config("llama3-1b").reduced()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    packed = pack_dense_params(
        inject_outlier_channels(build_model(cfg).init(gen)), cfg)
    return cfg, packed


# 5 requests over 3 slots, pages of 4 rows: occupancy changes, decode tables
# widen from 1 column to 8 (8 takes attention's split path), at least
# 10 decode steps per request; rid 1 samples with top-k and top-p, rid 3
# without filters
GRAPH_REQUESTS = ((3, dict(max_new=20)),
                  (12, dict(max_new=16, temperature=0.9, top_k=30, top_p=0.9)),
                  (6, dict(max_new=18)),
                  (14, dict(max_new=10, temperature=1.2)),
                  (9, dict(max_new=20)))


def _serve_graphed(served, eager, on_step=None):
    """Serve GRAPH_REQUESTS with every count set to 0 first; probes on every
    third decode dispatch. -> (engine, requests by rid, both tallies)."""
    cfg, packed = served
    qlm = QuantizedDenseLM(cfg, block_size=16, kv_bits=4)
    engine = ServeEngine(as_servable(qlm, packed), n_pages=3 * 8 + 1,
                         page_size=4, max_seqs=3, prefill_chunk=8, seed=5,
                         record_logits=True, eager=eager,
                         quality_probes=QualityProbes(every_k=3))
    rng = np.random.default_rng(6)
    for rid, (n, sampling) in enumerate(GRAPH_REQUESTS):
        engine.submit(EngineRequest(
            rid=rid, prompt=rng.integers(0, cfg.vocab, n).tolist(),
            sampling=SamplingParams(**sampling)))
    kops.reset_kernel_launch_counts()
    kops.reset_dispatch_counts()
    done = []
    while engine.queue or engine.active:
        done.extend(engine.step())
        if on_step is not None:
            on_step(engine)
    torch.cuda.synchronize()
    engine.check_books()
    return engine, {r.rid: r for r in done}, kops.count_snapshot()


def _assert_same_service(got, want):
    assert sorted(got) == sorted(want) == list(range(len(GRAPH_REQUESTS)))
    for rid, r in want.items():
        assert r.outcome == got[rid].outcome == "length"
        assert got[rid].generated == r.generated
        assert len(got[rid].step_logits) == len(r.step_logits)
        for g, w in zip(got[rid].step_logits, r.step_logits):
            assert np.array_equal(g, w)


def test_graphed_decode_bit_equal_to_eager(served_gpu):
    """The same requests served with each decode step replayed from its
    variant's graph and eagerly: tokens (sampled rows included), every
    step's logits and the probe stats bit-equal; launch counts and dispatch
    tallies equal, none of them plain."""
    eager, want, want_counts = _serve_graphed(served_gpu, eager=True)
    graphed, got, got_counts = _serve_graphed(served_gpu, eager=False)
    _assert_same_service(got, want)
    assert got_counts == want_counts
    assert not any(path == "ref" for _, path in got_counts[1])
    snap_e, snap_g = eager.metrics_snapshot(), graphed.metrics_snapshot()
    quality = {k: v for k, v in snap_e["histograms"].items()
               if k.startswith("quality.")}
    assert quality == {k: snap_g["histograms"][k] for k in quality}
    assert snap_g["counters"]["quality.probe_dispatches"] >= 5
    stats = graphed.graph_stats()
    decodes = snap_g["histograms"]["engine.decode.batch_occupancy"]["count"]
    assert decodes >= 16 and 4 <= stats["graphs"] < decodes   # replays ran
    assert {key[2][0] for key in graphed._graphs} >= {1, 4, 8}   # n_cols
    assert stats["pool_bytes"] > 0 and stats["capture_s"] > 0
    assert not eager._graphs


def test_graphed_decode_keeps_its_scratch(served_gpu, monkeypatch):
    """Scratch starts empty; right after the first graph that takes
    attention's split path (8 columns) is captured, eager calls grow
    `int4_matmul`'s workspace and attention's merge counters. The graphs
    captured before keep replaying on their own arrays: the service stays
    bit-equal to the eager engine's."""
    monkeypatch.setattr(I4, "_WORKSPACE", {})
    monkeypatch.setattr(PA, "_COUNTERS", {})
    dev = torch.device("cuda", 0)
    key = torch.cuda.current_device()
    grown = []

    def grow(engine):
        if grown or not any(k[2][0] == 8 and c.graph is not None
                            for k, c in engine._graphs.items()):
            return
        ws, cnt = I4._WORKSPACE[key][0].numel(), PA._COUNTERS[key][0].numel()
        rng = np.random.default_rng(9)
        qa = torch.from_numpy(rng.integers(0, 16, (64, 2048)).astype(np.int8)).to(dev)
        wp = torch.from_numpy(rng.integers(0, 256, (1024, 2048)).astype(np.uint8)).to(dev)
        _integer_part(qa, wp)
        args, kw = _attention_inputs(dev, "int4", 16, 1, 4, 64, [120] * 32, 8,
                                     torch.bfloat16, kh=8)
        PA.paged_attention(*args, **kw)
        assert I4._WORKSPACE[key][0].numel() > ws
        assert PA._COUNTERS[key][0].numel() > cnt
        grown.append(len(engine._graphs))

    _, want, _ = _serve_graphed(served_gpu, eager=True)
    graphed, got, _ = _serve_graphed(served_gpu, eager=False, on_step=grow)
    assert grown
    _assert_same_service(got, want)


FORCED_CAPTURE_ERROR = r"""
import sys
import torch
sys.path.insert(0, "src")
from repro_torch.configs.registry import get_config
from repro_torch.core.synthetic import inject_outlier_channels
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import (EngineRequest, IntegerModelAdapter,
                                      SamplingParams, ServeEngine)
from repro_torch.serve.quantized import QuantizedDenseLM, pack_dense_params


class ReadsTheHost(IntegerModelAdapter):
    # a forward that reads the device on the host, as the plain versions do
    def forward_chunk(self, params, tokens, *a, **k):
        int(tokens.max())
        return super().forward_chunk(params, tokens, *a, **k)


cfg = get_config("llama3-1b").reduced()
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
packed = pack_dense_params(inject_outlier_channels(build_model(cfg).init(gen)), cfg)
engine = ServeEngine(ReadsTheHost(QuantizedDenseLM(cfg, block_size=16, kv_bits=4), packed),
                     n_pages=9, page_size=4, max_seqs=2, prefill_chunk=8)
engine.submit(EngineRequest(rid=0, prompt=[1, 2, 3], sampling=SamplingParams(max_new=4)))
engine.step()                     # the prefill, eager
try:
    engine.step()                 # the first decode: warm-up, then capture
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0])
    sys.exit(0)
print("no error")
sys.exit(1)
"""


def test_forced_capture_error_raises(served_gpu):
    """A decode step whose forward reads the device on the host cannot be
    captured: the step raises, with no eager fallback. In a process of its
    own, because a failed capture may leave the CUDA context unusable."""
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", FORCED_CAPTURE_ERROR], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "raised:" in out.stdout


# ---------------------------------------------------------------------------
# Engine robustness on the card: the swap tier, preemption, COW, captures
# ---------------------------------------------------------------------------

def _card_pool(dev, n_pages=40, page=16, layers=4):
    """A page pool in the int4 page format's leaves, random contents."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    codes = (layers, n_pages, page, 8, 64)
    aux = (layers, n_pages, page, 8, 1)
    return {"k": torch.randint(-8, 8, codes, generator=gen, device=dev,
                               dtype=torch.int8),
            "v": torch.randint(-8, 8, codes, generator=gen, device=dev,
                               dtype=torch.int8),
            "k_scale": torch.rand(aux, generator=gen, device=dev),
            "v_zero": torch.rand(aux, generator=gen, device=dev)}


def test_swap_round_trip_survives_page_reuse(dev):
    """Swap-out, then the victim's freed pages reallocated and written by
    another sequence at once (no synchronise in between), then swap-in:
    the victim's bytes come back equal. The host tier is pinned memory and
    both copies ran on the side stream, ordered by events."""
    from repro_torch.serve.engine import PagedKVCache
    kv = PagedKVCache(_card_pool(dev), 40, 16)
    host = kv.attach_host_pool(64)
    assert all(b.is_pinned() for b in host.buf.values())
    kv.open(0)
    kv.ensure(0, 16 * 12)
    before = {k: leaf[:, kv.tables[0]].clone() for k, leaf in kv.pool.items()}
    freed = list(kv.tables[0])
    n, _ = kv.swap_out(0)
    assert n == 12 and kv._stream is not None
    kv.open(1)
    kv.ensure(1, 16 * 12)
    assert sorted(kv.tables[1]) == sorted(freed)      # the same pages, reused
    for leaf in kv.pool.values():
        leaf[:, kv.tables[1]] = 5
    kv.swap_in(0)
    torch.cuda.synchronize()
    for k, leaf in kv.pool.items():
        assert torch.equal(leaf[:, kv.tables[0]], before[k])
        assert bool((leaf[:, kv.tables[1]] == 5).all())
    start, end = kv.last_transfer
    assert start.elapsed_time(end) >= 0.0
    kv.release(0)
    kv.release(1)
    kv.settle()
    assert host.in_use == 0 and kv.allocator.in_use == 0


def _robust_requests(cfg):
    rng = np.random.default_rng(8)
    shared = rng.integers(0, cfg.vocab, 10).tolist()
    return [shared + rng.integers(0, cfg.vocab, n).tolist()
            for n in (3, 9, 5, 2, 7)]


def _serve_robust(served, eager, **kw):
    """Five requests with a shared 10-token prefix over 2 slots, pages of 4
    rows, the prefix cache on and injected exhaustions, with every pool
    write's capture state recorded. -> (engine, requests, tallies, log)."""
    from repro_torch.serve.engine import FaultPlan
    cfg, packed = served
    qlm = QuantizedDenseLM(cfg, block_size=16, kv_bits=4)
    engine = ServeEngine(as_servable(qlm, packed), n_pages=40, page_size=4,
                         max_seqs=2, prefill_chunk=8, seed=2,
                         record_logits=True, eager=eager, prefix_cache=True,
                         max_preemptions=10,
                         faults=FaultPlan(exhaust_steps=(5, 9, 14, 20)), **kw)
    writes = []
    for name in ("scrub", "cow_copy", "swap_out", "swap_in"):
        fn = getattr(engine.kv, name)

        def logged(*a, _fn=fn, _name=name, **k):
            writes.append((_name, torch.cuda.is_current_stream_capturing()))
            return _fn(*a, **k)
        setattr(engine.kv, name, logged)
    for rid, p in enumerate(_robust_requests(cfg)):
        engine.submit(EngineRequest(rid=rid, prompt=p, sampling=SamplingParams(
            max_new=12, temperature=0.7 if rid == 3 else 0.0)))
    kops.reset_kernel_launch_counts()
    kops.reset_dispatch_counts()
    done = []
    while engine.queue or engine.active:
        done.extend(engine.step())
        engine.check_books()
    torch.cuda.synchronize()
    return engine, {r.rid: r for r in done}, kops.count_snapshot(), writes


def test_preemption_and_cow_between_replays_match_eager(served_gpu):
    """Preemptions and COW copies land between replays of the same captured
    variants: tokens, every step's logits and the tallies equal those of
    the eager engine, bit for bit."""
    eager, want, want_counts, _ = _serve_robust(served_gpu, eager=True)
    graphed, got, got_counts, _ = _serve_robust(served_gpu, eager=False)
    assert sorted(got) == sorted(want) == list(range(5))
    for rid, r in want.items():
        assert r.outcome == got[rid].outcome == "length"
        assert got[rid].generated == r.generated
        for g, w in zip(got[rid].step_logits, r.step_logits):
            assert np.array_equal(g, w)
    assert got_counts == want_counts
    c = graphed.metrics.counter
    assert c("engine.preemptions").value >= 1
    assert c("engine.prefix.cow_copies").value >= 1
    assert c("engine.prefix.hits").value >= 1
    decodes = graphed.metrics.histogram("engine.decode.batch_occupancy").count
    assert 1 <= graphed.graph_stats()["graphs"] < decodes     # replays ran


def test_no_pool_write_inside_a_capture(served_gpu, dev):
    """Scrub, COW and the swap transfers of a graphed run with preemption,
    the prefix cache and the swap tier all run outside any capture; called
    inside one, a pool write raises before touching the device."""
    from repro_torch.serve.engine import PagedKVCache
    engine, done, _, writes = _serve_robust(served_gpu, eager=False,
                                            swap_host_mb=8,
                                            swap_policy="always")
    assert all(r.outcome == "length" for r in done.values())
    assert {name for name, _ in writes} >= {"scrub", "cow_copy", "swap_out",
                                            "swap_in"}
    assert not any(capturing for _, capturing in writes)
    assert engine.graph_stats()["graphs"] >= 1
    kv = PagedKVCache(_card_pool(dev, n_pages=8, layers=1), 8, 16)
    kv.open(0)
    kv.ensure(0, 32)
    src, dst = kv.tables[0]
    x = torch.zeros(4, device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x.add_(1)
        with pytest.raises(RuntimeError, match="captured"):
            kv.cow_copy(src, dst)
        with pytest.raises(RuntimeError, match="captured"):
            kv.release(0)
    graph.replay()
    torch.cuda.synchronize()
    assert float(x.sum()) == 4.0


# ---------------------------------------------------------------------------
# The bf16 / fake-quant Model path: f32 pages, the PTQ pipeline on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,lens", [(1, [120, 0, 37, 113]), (32, [128])],
                         ids=["decode", "prefill"])
def test_paged_attention_f32_pages_at_the_model_paths_shapes(dev, s, lens):
    """The `Model` path's attention: bf16 queries (32 heads of 64 over 8 KV
    heads) over f32 post-RoPE pages, no in-walk rotation."""
    _attention_case(dev, "float", 16, s, 4, 64, lens, 8, None, torch.bfloat16,
                    kh=8)


@pytest.mark.parametrize("s,lens", [(1, [120, 0, 37, 113]), (32, [128])],
                         ids=["decode", "prefill"])
@pytest.mark.parametrize("kh,dh", [(16, 128), (32, 64)],
                         ids=["deepseek-moe", "zamba2"])
def test_paged_attention_f32_pages_at_the_families_widths(dev, s, lens, kh, dh):
    """The MoE and hybrid families' attention through the fake-quant
    `Model`: f32 queries, one query head per KV head (16 of 128 for
    deepseek-moe-16b, 32 of 64 for zamba2-1.2b's shared block) over f32
    pages."""
    _attention_case(dev, "float", 16, s, 1, dh, lens, 8, None, torch.float32,
                    kh=kh)


def _ptq_inputs(device):
    from repro_torch.core import pipeline as TP
    cfg = get_config("llama3-1b").reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = inject_outlier_channels(build_model(cfg).init(gen))
    rng = np.random.default_rng(1)
    calib = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 128)))
    held = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 64)))
    move = lambda tree: {k: move(v) if isinstance(v, dict) else v.to(device)  # noqa: E731
                         for k, v in tree.items()}
    return TP, cfg, move(params), calib.to(device), held.to(device)


@pytest.mark.parametrize("name", ["rtn_only", "perq_star", "mr_gptq"])
def test_quantize_model_on_the_card_matches_the_cpu(dev, name):
    """`quantize_model` on the card against the port on the CPU from the
    same params and tokens: the per-layer block mass before the permutation
    within 1e-5 relative, after it within 1e-3 (the captures differ in
    their last f32 bits, so the greedy may place two near-equal coordinates
    the other way); rtn_only's weights on the same grid points but at ties
    (<= 0.1 %); for
    the error-diffusing presets the fake-quant logit MSE against the bf16
    model within 5 % (the rounding is chaotic in the inputs' last bits)."""
    out = {}
    for device in ("cpu", dev):
        TP, cfg, params, calib, held = _ptq_inputs(device)
        model = build_model(cfg)
        res = TP.quantize_model(model, params, [{"tokens": calib}],
                                TP.preset(name, block_size=16))
        want = model.forward(params, {"tokens": held})
        got = TP.build_quantized_model(model, res).forward(
            res.params, {"tokens": held})
        assert bool(torch.isfinite(got).all())
        out[str(device)] = (res, float(((got - want) ** 2).mean()))
    (cpu, e_cpu), (card, e_card) = out["cpu"], out[str(dev)]
    for a, b in zip(cpu.report["per_layer"], card.report["per_layer"]):
        for k, frac in (("max_block_l1_before", 1e-5),
                        ("max_block_l1_after", 1e-3)):
            assert abs(b[k] - a[k]) <= frac * abs(a[k])
    if name == "rtn_only":
        w_cpu = cpu.params["layers"]["ffn"]["w_down"]
        w_card = card.params["layers"]["ffn"]["w_down"].cpu()
        off = ~torch.isclose(w_card, w_cpu, rtol=1e-5,
                             atol=1e-6 * float(w_cpu.abs().max()))
        assert float(off.float().mean()) <= 1e-3
    assert abs(e_card - e_cpu) <= 0.05 * e_cpu


def test_bf16_model_decode_graphed_bit_equal_to_eager(dev):
    """The `DenseModelAdapter` (bf16 model, f32 pages) served with each
    decode step replayed from a captured graph and eagerly: tokens and
    every step's logits bit-equal, launch counts equal, attention on the
    kernel."""
    cfg = get_config("llama3-1b").reduced()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = build_model(cfg)
    params = inject_outlier_channels(model.init(gen))
    runs = []
    for eager in (True, False):
        engine = ServeEngine(as_servable(model, params), n_pages=3 * 8 + 1,
                             page_size=4, max_seqs=3, prefill_chunk=8,
                             record_logits=True, eager=eager)
        rng = np.random.default_rng(6)
        for rid, (n, _) in enumerate(GRAPH_REQUESTS):
            engine.submit(EngineRequest(
                rid=rid, prompt=rng.integers(0, cfg.vocab, n).tolist(),
                sampling=SamplingParams(max_new=12)))
        kops.reset_kernel_launch_counts()
        kops.reset_dispatch_counts()
        done = {r.rid: r for r in engine.run()}
        torch.cuda.synchronize()
        engine.check_books()
        runs.append((engine, done, kops.count_snapshot()))
    (_, want, c_eager), (graphed, got, c_graph) = runs
    assert graphed.graph_stats()["graphs"] >= 1
    assert c_graph == c_eager and c_graph[0]["paged_attention"] > 0
    assert not [k for k in c_graph[1] if k[1] == "ref"]
    for rid, r in want.items():
        assert got[rid].generated == r.generated
        for g, w in zip(got[rid].step_logits, r.step_logits):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b",
                                  "deepseek-moe-16b"])
def test_family_decode_graphed_bit_equal_to_eager(dev, arch):
    """The SSM (register slots), hybrid (register slots and kv pages) and
    MoE (capacity dispatch, gather combine) families served with each
    decode step replayed from a captured graph and eagerly: tokens and
    every step's logits bit-equal, launch counts equal; attention, where
    the family has it, on the kernel."""
    cfg = get_config(arch).reduced()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = build_model(cfg)
    params = inject_outlier_channels(model.init(gen))
    runs = []
    for eager in (True, False):
        engine = ServeEngine(as_servable(model, params), n_pages=3 * 8 + 1,
                             page_size=4, max_seqs=3, prefill_chunk=8,
                             record_logits=True, eager=eager)
        rng = np.random.default_rng(6)
        for rid, (n, _) in enumerate(GRAPH_REQUESTS):
            engine.submit(EngineRequest(
                rid=rid, prompt=rng.integers(0, cfg.vocab, n).tolist(),
                sampling=SamplingParams(max_new=12)))
        kops.reset_kernel_launch_counts()
        kops.reset_dispatch_counts()
        done = {r.rid: r for r in engine.run()}
        torch.cuda.synchronize()
        engine.check_books()
        runs.append((engine, done, kops.count_snapshot()))
    (_, want, c_eager), (graphed, got, c_graph) = runs
    assert graphed.graph_stats()["graphs"] >= 1
    assert c_graph == c_eager
    assert (c_graph[0]["paged_attention"] > 0) == (cfg.family != "ssm")
    assert not [k for k in c_graph[1] if k[1] == "ref"]
    assert graphed.kv.registers is None or graphed.kv.registers.in_use == 0
    for rid, r in want.items():
        assert got[rid].generated == r.generated
        for g, w in zip(got[rid].step_logits, r.step_logits):
            assert np.array_equal(g, w)


def test_a_dead_engines_graphs_do_not_break_a_capture(dev):
    """An engine and its captured calls refer to each other, so a dropped
    engine's graphs are freed by Python's cycle collector, whenever it
    runs. With the collector running at nearly every allocation, a second
    engine's captures must still succeed (a graph destroyed inside a
    capture would invalidate it) and serve the first engine's tokens."""
    import gc
    cfg = get_config("zamba2-1.2b").reduced()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = build_model(cfg)
    params = model.init(gen)
    prompts = [list(range(3, 3 + n)) for n, _ in GRAPH_REQUESTS[:3]]

    def serve():
        engine = ServeEngine(as_servable(model, params), n_pages=3 * 8 + 1,
                             page_size=4, max_seqs=3, prefill_chunk=8)
        for rid, p in enumerate(prompts):
            engine.submit(EngineRequest(rid=rid, prompt=p,
                                        sampling=SamplingParams(max_new=10)))
        done = {r.rid: r.generated for r in engine.run()}
        assert engine.graph_stats()["graphs"] >= 1
        return done

    first = serve()                  # leaves a dead engine with graphs
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        assert serve() == first
    finally:
        gc.set_threshold(*thresholds)


def _train_inputs(device):
    """The reduced llama3 (f32) from one CPU seed, its AdamW state and one
    numpy batch, on `device`."""
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map
    cfg = get_config("llama3-1b").reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 32)).astype(
        np.int32)).to(device) for k in ("tokens", "labels")}
    params = tree_map(lambda t: t.to(device), params)
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    return cfg, params, adamw.init_state(opt_cfg, params), batch, opt_cfg


@pytest.mark.parametrize("n_micro,remat", [(1, False), (2, True)])
def test_train_step_on_the_card_matches_the_cpu(dev, n_micro, remat):
    """One train step on the card against the same step on the CPU from the
    same state (f32): loss and grad norm rel 1e-5, gradients within 1e-4 of
    each leaf's largest; updated params within 1e-5 of each leaf's largest
    where the gradient is above 1e-3 of the leaf's largest or exactly zero,
    and within AdamW's own bound (4·lr) where it is cancellation noise
    (there lr·g/(|g| + eps) takes any value in [-lr, lr])."""
    from repro_torch.train.step import TrainConfig, make_train_step
    from repro_torch.tree import leaves, unflatten
    out = {}
    for device in ("cpu", dev):
        cfg, params, opt, batch, opt_cfg = _train_inputs(device)
        model = build_model(cfg)
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, _ = model.loss_fn(unflatten(params, flat), batch)
        grads = [g.cpu() for g in torch.autograd.grad(loss, flat)]
        step = make_train_step(model, opt_cfg,
                               TrainConfig(num_microbatches=n_micro,
                                           remat=remat))
        p1, o1, m = step(params, opt, batch)
        out[str(device)] = (grads, [t.cpu() for t in leaves(p1)],
                            {k: float(v) for k, v in m.items()})
    (g_cpu, p_cpu, m_cpu), (g_card, p_card, m_card) = out["cpu"], out[str(dev)]
    for k in ("loss", "grad_norm", "lr"):
        assert abs(m_card[k] - m_cpu[k]) <= 1e-5 * abs(m_cpu[k])
    lr = m_cpu["lr"]
    for gc, gg, pc, pg in zip(g_cpu, g_card, p_cpu, p_card):
        top = float(gc.abs().max())
        assert float((gg - gc).abs().max()) <= 1e-4 * max(top, 1e-30)
        cond = (gc.abs() >= 1e-3 * top) | (gc == 0)
        diff = (pg - pc).abs()
        assert float(diff[cond].max()) <= 1e-5 * float(pc.abs().max())
        assert float(diff.max()) <= 4 * lr


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_of_card_tensors(dev, tmp_path, dtype):
    from repro_torch.checkpoint.manager import CheckpointManager
    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {"w": torch.randn(3, 5, generator=g, device="cuda").to(dtype),
            "opt": {"step": torch.tensor(4, dtype=torch.int32, device="cuda")}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    mgr.wait()
    like = {"w": torch.zeros(3, 5, dtype=dtype, device="cuda"),
            "opt": {"step": torch.zeros((), dtype=torch.int32, device="cuda")}}
    got = mgr.restore(target=like)
    assert got["w"].device.type == "cuda" and got["w"].dtype == dtype
    bits = (lambda t: t.view(torch.int16)) if dtype == torch.bfloat16 \
        else (lambda t: t)
    assert torch.equal(bits(got["w"]), bits(tree["w"]))
    assert int(got["opt"]["step"]) == 4
