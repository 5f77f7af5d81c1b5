#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one CUDA device

Builds the CUDA kernels from `src/repro_torch/kernels/csrc/`, holds each
against its plain PyTorch version on the card at the serving path's
full-width shapes, serves llama3-1b (16 layers, seeded random weights)
through `repro_torch.launch.serve` with true-integer W4A4 arithmetic and an
int4 KV page pool - once plain, once observed (`--probe-every 4 --trace
--metrics-json`, which runs `block_hadamard` in the rotation-quality probe),
each decode step one replay of a captured CUDA graph - and checks the
kernels' logits against the plain versions' on the same state and the
graphed decode against the eager one. Phases print one JSON line each:

    device   card name and power limit (nvidia-smi)
    build    seconds nvcc took
    kernels  per kernel: error against the plain version, times, bound; the
             split merge (the reference's `_combine_kernel`) inside the
             attention launch, bit-equal over 20 launches
    serve    the launcher at full width and depth, plain and observed, then
             two short runs
    parity   one prefill chunk and one decode step, kernels vs plain, and
             the probed decode step against the unprobed one
    graph    the engine's decode step replayed from captured CUDA graphs
             (its dispatch on the card) against the same engine run eagerly:
             tokens, logits and counts equal; graphs captured, their pool's
             memory, capture time; host ms per pure decode step of both,
             interleaved
    profile  (only with --profile) where a pure decode step's time goes,
             eager and graphed, without and with the probe
    ptxas    (only with --ptxas) registers, spills and shared memory of
             every kernel, from a compile of its own (also when the library
             was already built)
    sweep    (only with --sweep) the attention kernel under other launch
             plans (block rows, warps per block, keys per tile), then
             `int4_matmul` (target blocks, tile rows), `block_hadamard`
             (elements per thread, blocks) and `hadamard_quant` (slices per
             row, elements per thread) under theirs

then the card's `name, power.limit`, then one `{"kernels": [...]}` object
with the per-kernel record of this run, then as the last line
`{"ok": true, "device": {...}}`. Any failing phase ends the run with a
non-zero exit code; without a CUDA device it exits at once.

Bounds use the published peaks of one H100 SXM: 3.35 TB/s of device memory,
1979 TOP/s int8, 495 TFLOP/s TF32 on the tensor cores (attention's
products), 67 TFLOP/s float32 outside the tensor cores.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
          file=sys.stderr)
    sys.exit(1)

import numpy as np  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import block_hadamard as BH  # noqa: E402
from repro_torch.kernels import hadamard_quant as HQ  # noqa: E402
from repro_torch.kernels import int4_matmul as I4  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402

DEV = torch.device("cuda", 0)
PEAK_BYTES_S = 3.35e12
PEAK_INT8_OPS_S = 1979e12
PEAK_TF32_FLOPS_S = 495e12
PEAK_F32_FLOPS_S = 67e12
L2_BYTES = 50 * 2 ** 20

KERNEL_META = {
    "hadamard_quant": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hadamard_quant.cu",
        "replaces": "src/repro/kernels/hadamard_quant.py:51"},
    "int4_matmul": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int4_matmul.cu",
        "replaces": "src/repro/kernels/int4_matmul.py:97"},
    "paged_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:360"},
    "combine_partials": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:352",
        "note": "folded into paged_attention.cu's last-arriving split"},
    "block_hadamard": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_hadamard.cu",
        "replaces": "src/repro/kernels/block_hadamard.py:79"},
}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def time_ms(fns, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call by CUDA events; `fns` is a list of
    equivalent closures over distinct buffers, taken in turn so that a call
    finds its large operands cold in L2 as the serving path does."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fns, reps: int = 20) -> float:
    """Mean milliseconds of device time per call: the calls are captured
    once into a CUDA graph and the graph is replayed, so the host's launch
    path (Python, allocation, the ctypes call) is outside the measurement.
    `time_ms` on the same closures gives the eager call time."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def n_copies(nbytes: int) -> int:
    """Copies of an operand to rotate through so the set exceeds L2 twice."""
    return max(1, min(32, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound(nbytes: float, ops: float, peak_ops: float):
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def hadamard_quant_agrees(got, plain):
    """The rule `hadamard_quant` is held to against its plain version:
    scale to 1e-6 relative; zero equal (or off by one where min/s sits on a
    rounding tie); codes equal except at rounding ties, which the
    butterfly's different summation order can flip: at most 0.1 % of
    entries, never by more than one step. -> (ok, scale relative error,
    zero error, share of codes that differ)."""
    (codes, s, z), (pc, ps, pz) = got, plain
    s_err = float(((s - ps).abs() / ps.abs()).max())
    z_err = float((z - pz).abs().max())
    diff = (codes.to(torch.int32) - pc.to(torch.int32)).abs()
    mism = float((diff != 0).float().mean())
    ok = (s_err <= 1e-6 and z_err <= 1.0 and mism <= 1e-3
          and int(diff.max()) <= 1 + int(z_err))
    return ok, s_err, z_err, mism


def check_hadamard_quant(rng, m, d, b, dtype):
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32) * 3.0)
    x[:, :: max(1, d // 16)] *= 12.0          # a few outlier channels
    x = x.to(DEV).to(dtype)
    codes, s, z = HQ.hadamard_quant(x, b, bits=4)
    torch.cuda.synchronize()
    pc, ps, pz = HQ.hadamard_quant_plain(x, b, 4)
    ok, s_err, z_err, mism = hadamard_quant_agrees((codes, s, z), (pc, ps, pz))
    deq = s * (codes.float() + z)
    pdeq = ps * (pc.float() + pz)
    err = float((deq - pdeq).abs().max())
    # f32 input, power-of-two b: block_hadamard runs the same butterfly and
    # the plain quantiser divides as the kernel does - bit-equal
    exact = None
    if dtype == torch.float32 and b & (b - 1) == 0:
        wc, ws, wz = HQ.quantize_act_plain(BH.block_hadamard(x, b), 4)
        exact = (bool(torch.equal(codes, wc)) and bool(torch.equal(s, ws))
                 and bool(torch.equal(z, wz)))
    # a NaN in one row: its scale is NaN, every other row as without it
    bad = x.clone()
    bad[m // 2, d // 3] = float("nan")
    nc, ns, nz = HQ.hadamard_quant(bad, b, bits=4)
    keep = torch.arange(m, device=DEV) != m // 2
    nan_ok = (bool(ns[m // 2].isnan().all()) and bool(torch.equal(nc[keep], codes[keep]))
              and bool(torch.equal(ns[keep], s[keep]))
              and bool(torch.equal(nz[keep], z[keep])))
    xs = [x.clone() for _ in range(n_copies(x.numel() * x.element_size()))]
    fns = [lambda t=t: HQ.hadamard_quant(t, b, bits=4) for t in xs]
    ms, call_ms = device_ms(fns), time_ms(fns, 50)
    plain = time_ms([lambda t=t: HQ.hadamard_quant_plain(t, b, 4) for t in xs], 10)
    nbytes = m * d * x.element_size() + m * d + 8 * m
    ops = m * d * (math.log2(b) if b > 1 else 0) + 4 * m * d
    bms, by = bound(nbytes, ops, PEAK_F32_FLOPS_S)
    return {"shape": f"x[{m},{d}] {str(dtype).split('.')[-1]} b={b} bits=4",
            "ok": ok and exact is not False and nan_ok,
            "plan": HQ.hadamard_quant_plan(m, d, b).__dict__,
            "scale_rel_err": s_err, "zero_abs_err": z_err,
            "code_mismatch_share": mism, "max_abs_err": err,
            "equal_to_block_hadamard_then_quantize": exact,
            "nan_stays_in_its_row": nan_ok,
            "tolerance": "scale 1e-6 rel; codes differ at <= 0.1% of "
                         "entries (rounding ties), by one step; f32 input "
                         "with power-of-two b: bit-equal to block_hadamard "
                         "+ the plain quantiser",
            "ms": ms, "call_ms": call_ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "library_ms": None}


def check_int4_matmul(rng, m, k, n):
    qa = torch.from_numpy(rng.integers(0, 16, (m, k)).astype(np.int8)).to(DEV)
    wc = torch.from_numpy(rng.integers(-7, 8, (k, n)).astype(np.int8)).to(DEV)
    wp = I4.int4_pack(wc)
    sa = torch.from_numpy(rng.uniform(0.01, 0.2, (m, 1)).astype(np.float32)).to(DEV)
    za = torch.from_numpy(np.round(rng.uniform(-12, 0, (m, 1))).astype(np.float32)).to(DEV)
    sw = torch.from_numpy(rng.uniform(0.001, 0.02, (n,)).astype(np.float32)).to(DEV)
    cs = I4.int4_colsum(wp)
    one = torch.ones_like(sa)
    # integer part: unit scales and zero offset leave float(acc), exact
    # below 2^24
    acc = I4.int4_matmul(qa, one, torch.zeros_like(za), wp, torch.ones_like(sw), cs)
    out = I4.int4_matmul(qa, sa, za, wp, sw, cs)
    torch.cuda.synchronize()
    want_acc = (qa.double() @ wc.double())
    int_exact = bool(torch.equal(acc.double(), want_acc))
    plain = I4.int4_matmul_plain(qa, sa, za, wp, sw, cs)
    denom = plain.abs().clamp_min(1e-30)
    rel = float(((out - plain).abs() / denom).max())
    err = float((out - plain).abs().max())
    ok = int_exact and rel <= 1e-6
    wps = [wp.clone() for _ in range(n_copies(wp.numel()))]
    fns = [lambda w=w: I4.int4_matmul(qa, sa, za, w, sw, cs) for w in wps]
    ms, call_ms = device_ms(fns), time_ms(fns, 60)
    pms = time_ms([lambda w=w: I4.int4_matmul_plain(qa, sa, za, w, sw, cs)
                   for w in wps], 10)
    # yardstick: one library int8 GEMM on the unpacked weights (integer part
    # only). It needs M > 16 and takes M, K and N in multiples of 8, so other
    # row counts are zero-padded to the next multiple of 8 from 32 up and the
    # record says so; the ragged case reports none.
    lib, lib_note = None, None
    if k % 8 == 0 and n % 8 == 0:
        qa_lib, lib_note = qa, "torch._int_mm on unpacked int8 weights"
        rows = max(32, -(-m // 8) * 8)
        if rows != m:
            qa_lib = torch.zeros((rows, k), dtype=torch.int8, device=DEV)
            qa_lib[:m] = qa
            lib_note += f", q_a zero-padded from {m} to {rows} rows"
        w8s = [wc.clone() for _ in range(n_copies(wc.numel()))]
        if not torch.equal(torch._int_mm(qa_lib, wc)[:m].double(), want_acc):
            fail("torch._int_mm disagrees with the exact integer product")
        lib = device_ms([lambda w=w: torch._int_mm(qa_lib, w) for w in w8s])
    nbytes = m * k + k * n // 2 + 8 * m + 8 * n + 4 * m * n
    bms, by = bound(nbytes, 2.0 * m * k * n, PEAK_INT8_OPS_S)
    return {"shape": f"q_a[{m},{k}] w[{k // 2},{n}]", "ok": ok,
            "plan": I4.int4_plan(m, n, k).__dict__,
            "integer_part_exact": int_exact, "max_rel_err": rel,
            "max_abs_err": err,
            "tolerance": "integer accumulator exact; output 1e-6 relative",
            "ms": ms, "call_ms": call_ms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib, "library": lib_note}


def make_pool(rng, n_layers, n_pages, t, kh, dh, fmt):
    """A seeded page pool stack [n_layers, n_pages, T, KH, Dh] in one of the
    three page formats, as a kv dict."""
    shp = (n_layers, n_pages, t, kh, dh)
    if fmt == "bf16":
        return {"k": torch.from_numpy(rng.standard_normal(shp).astype(np.float32)).to(DEV).to(torch.bfloat16),
                "v": torch.from_numpy(rng.standard_normal(shp).astype(np.float32)).to(DEV).to(torch.bfloat16)}
    bits = 8 if fmt == "int8" else 4
    off = 2 ** (bits - 1)
    kv = {}
    for nm in ("k", "v"):
        kv[nm] = torch.from_numpy(
            (rng.integers(0, 2 ** bits, shp) - off).astype(np.int8)).to(DEV)
        kv[nm + "_scale"] = torch.from_numpy(rng.uniform(
            0.01, 0.3 if bits == 4 else 0.02, shp[:-1] + (1,)).astype(np.float32)).to(DEV)
        kv[nm + "_zero"] = torch.from_numpy(np.round(rng.uniform(
            -(2 ** bits), 0, shp[:-1] + (1,))).astype(np.float32)).to(DEV)
    return kv


MERGE_LAUNCHES = 20     # launches of a split call that must agree bit for bit


def check_attention(rng, label, fmt, b, s, lens, n_cols, theta, kv_splits=None,
                    live_pool=False):
    """The attention kernel against its plain version on one seeded case of
    the served model's widths, then timed over 16 layers' pools. A split
    call (the default splits at decode, or `kv_splits`) must launch once and
    merge in that launch, and give one bit pattern over `MERGE_LAUNCHES`
    launches. The pool holds a page per table column of every row, or with
    `live_pool` only the live pages."""
    h, kh, dh, t, n_layers = 32, 8, 64, 16, 16
    used = [-(-ln // t) for ln in lens]
    n_pages = 1 + (sum(used) if live_pool else b * n_cols)
    pool = make_pool(rng, n_layers, n_pages, t, kh, dh, fmt)
    bits = {"bf16": None, "int8": 8, "int4": 4}[fmt]
    q = torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(np.float32)).to(DEV)
    q = q.to(torch.bfloat16)
    perm = rng.permutation(np.arange(1, n_pages))
    offs = np.cumsum([0] + used)[:-1] if live_pool else np.arange(b) * n_cols
    bt = np.zeros((b, n_cols), np.int32)
    for i, u in enumerate(used):
        bt[i, :u] = perm[offs[i]:offs[i] + u]
    bt = torch.from_numpy(bt).to(DEV)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    if s == 1:
        qpos = torch.tensor([[max(ln - 1, 0)] for ln in lens], dtype=torch.int32, device=DEV)
    else:
        qpos = torch.stack([torch.arange(ln - s, ln, dtype=torch.int32)
                            for ln in lens]).to(DEV)
    kw = dict(rope_theta=theta if bits else None, kv_bits=bits,
              kv_group=dh if bits else None, kv_splits=kv_splits)
    _, splits, _, split_cols = PA.resolve_tiling(s, kh, n_cols, kv_splits=kv_splits)
    layer = lambda l: {k_: v_[l] for k_, v_ in pool.items()}  # noqa: E731
    before = dict(PA.LAUNCHES)
    out = PA.paged_attention(q, layer(0), bt, qpos, lens_t, **kw)
    torch.cuda.synchronize()
    used_combine = PA.LAUNCHES["combine_partials"] > before["combine_partials"]
    one_launch = (PA.LAUNCHES["paged_attention"] == before["paged_attention"] + 1
                  and used_combine == (splits > 1))
    want = PA.paged_attention_plain(q, layer(0), bt, qpos, lens_t, **kw)
    err = float((out - want).abs().max())
    zero_rows_ok = all(bool((out[i] == 0).all()) for i, ln in enumerate(lens) if ln == 0)
    finite = bool(torch.isfinite(out).all())
    # the splits finish in another order on every launch; the merge reads
    # them in split order, so the output must not change by a bit
    stable = None
    if splits > 1:
        stable = all(torch.equal(PA.paged_attention(q, layer(0), bt, qpos, lens_t, **kw), out)
                     for _ in range(MERGE_LAUNCHES - 1))
    # Pass rule: 2e-5 absolute in f32 - the kernel sums the head dimension
    # and the keys in another order than the plain einsum, on the tensor
    # cores in the 3xTF32 split (f32 accuracy), and updates the softmax per
    # tile of pages instead of per page; both are f32 throughout.
    ok = err <= 2e-5 and zero_rows_ok and finite and one_launch and stable is not False
    fns = [lambda l=l: PA.paged_attention(q, layer(l), bt, qpos, lens_t, **kw)
           for l in range(n_layers)]
    ms, call_ms = device_ms(fns), time_ms(fns, 48)
    pms = time_ms([lambda l=l: PA.paged_attention_plain(q, layer(l), bt, qpos, lens_t, **kw)
                   for l in range(2)], 4, warmup=1)
    lib = None
    if fmt == "bf16":
        # yardstick: SDPA on a slab gathered beforehand (the gather is not timed)
        kk = pool["k"][0][bt.long()].reshape(b, n_cols * t, kh, dh)
        vv = pool["v"][0][bt.long()].reshape(b, n_cols * t, kh, dh)
        kk = kk.repeat_interleave(h // kh, dim=2).transpose(1, 2)
        vv = vv.repeat_interleave(h // kh, dim=2).transpose(1, 2)
        qq = q.transpose(1, 2)
        mask = (torch.arange(n_cols * t, device=DEV)[None, None, None, :]
                <= qpos[:, None, :, None])
        lib = device_ms([lambda: torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask)])
    # Bound: the rows the causal walk needs are the first `len` of each
    # sequence (the rest of the last page is masked, never needed), each with
    # its K and V and, for integer pages, their scale and zero; a query at
    # position p multiplies and accumulates against keys 0..p only.
    per_row = kh * dh * pool["k"].element_size() * 2
    if bits:
        per_row += kh * 4 * 4
    nbytes = sum(lens) * per_row + q.numel() * 2 + out.numel() * 4 + bt.numel() * 4
    live_pairs = int(torch.minimum(qpos + 1, lens_t[:, None]).clamp_min(0).sum())
    flops = 4.0 * h * dh * live_pairs
    bms, by = bound(nbytes, flops, PEAK_TF32_FLOPS_S)
    plan = PA.attention_plan(h // kh, s, dh, t, pool["k"].dtype,
                             group=dh if bits else None)
    # the merge alone, as the reference's second kernel did it: the partials
    # (m, l, acc of every split's rows) read once, `out` written once; its
    # plain version on the plain walk's partials
    merge = {}
    if splits > 1:
        parts = PA._partials_plain(q, layer(0), bt, qpos, lens_t, rope_theta=kw["rope_theta"],
                                   kv_bits=bits, kv_group=kw["kv_group"], kv_splits=splits,
                                   split_cols=split_cols)
        m_p, l_p, acc_p = (torch.stack([p[i].reshape(b, h, s, *([dh] if i == 2 else []))
                                        for p in parts], dim=1) for i in range(3))
        mb = (m_p.numel() + l_p.numel() + acc_p.numel() + out.numel()) * 4
        mbms, mby = bound(mb, 3.0 * acc_p.numel(), PEAK_F32_FLOPS_S)
        merge = {"merge_bound_ms": mbms, "merge_bound_by": mby,
                 "merge_plain_ms": time_ms([lambda: PA.combine_partials_plain(
                     m_p, l_p, acc_p)], 20),
                 "bit_equal_over_launches": stable, "launches_compared": MERGE_LAUNCHES}
    return {"shape": f"{label}: q[{b},{s},{h},{dh}] bf16, {fmt} pages T={t}, "
                     f"lens={lens}, table {n_cols} cols"
                     + (f", kv_splits={kv_splits}" if kv_splits else ""),
            "ok": ok, "max_abs_err": err, "used_combine": used_combine,
            "one_launch": one_launch, "splits": splits, **merge,
            "pool_mib_per_layer": sum(v_[0].numel() * v_.element_size()
                                      for v_ in pool.values()) / 2 ** 20,
            "plan": {"q_rows": plan.q_rows, "warps": plan.warps,
                     "key_warps": plan.key_warps, "threads": plan.threads,
                     "pages_per_tile": plan.pages_per_tile,
                     "smem_bytes": plan.smem_bytes},
            "library_over_ms": lib / ms if lib is not None else None,
            "tolerance": "2e-5 absolute (f32, different summation order)",
            "ms": ms, "call_ms": call_ms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib,
            "library": ("scaled_dot_product_attention on a slab gathered "
                        "beforehand" if lib is not None else None)}


def check_block_hadamard(rng, shape, b, dtype):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3.0)
    x[..., :: max(1, shape[-1] // 16)] *= 12.0  # a few outlier channels
    x = x.to(DEV).to(dtype)
    y = BH.block_hadamard(x, b)
    torch.cuda.synchronize()
    want = BH.block_hadamard_plain(x, b)
    err = float((y.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    # Pass rule: the kernel's butterfly (or b-wide dot product) and the plain
    # dense product are the same f32 sums in another order: 2e-5 of max|y|;
    # a bf16 output is that value rounded once, so one bf16 ulp (2^-7
    # relative) more. A NaN poisons its block of its row and nothing else.
    tol = 2e-5 * top + (2 ** -7 * want.float().abs()
                        if dtype == torch.bfloat16 else 0.0)
    ok = bool(((y.float() - want.float()).abs() <= tol).all())
    poisoned = x.clone()
    poisoned.view(-1, shape[-1])[0, 0] = float("nan")
    out = BH.block_hadamard(poisoned, b).view(-1, shape[-1])
    nan_ok = bool(out[0, :b].isnan().all()) and bool(out[1:].isfinite().all()) \
        and bool(out[0, b:].isfinite().all())
    d = shape[-1]
    m = x.numel() // d
    xs = [x.clone() for _ in range(n_copies(x.numel() * x.element_size()))]
    fns = [lambda t=t: BH.block_hadamard(t, b) for t in xs]
    ms, call_ms = device_ms(fns), time_ms(fns, 50)
    plain = time_ms([lambda t=t: BH.block_hadamard_plain(t, b) for t in xs], 10)
    # yardstick: one torch.matmul against the block-diagonal operand (the
    # plain version's product without its casts and reshapes)
    td = HQ.column_tile(b, d)
    op = HQ.rotation_operand(b, td, DEV).to(dtype)
    lib = device_ms([lambda t=t: torch.matmul(t.view(-1, d // td, td), op)
                     for t in xs])
    pow2 = b & (b - 1) == 0
    nbytes = 2 * x.numel() * x.element_size() + (0 if pow2 else 4 * b * b)
    ops = x.numel() * (math.log2(b) + 1 if pow2 else 2 * b)
    bms, by = bound(nbytes, ops, PEAK_F32_FLOPS_S)
    return {"shape": f"x[{','.join(map(str, shape))}] "
                     f"{str(dtype).split('.')[-1]} b={b}",
            "ok": ok and nan_ok, "max_abs_err": err, "max_abs_y": top,
            "plan": BH.hadamard_plan(m, d, b).__dict__,
            "nan_poisons_its_block_only": nan_ok,
            "tolerance": "2e-5 of max|y| (+ one bf16 ulp for bf16 output)",
            "ms": ms, "call_ms": call_ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "library_ms": lib,
            "library": f"torch.matmul of x against I (x) H_{b}/sqrt({b}) "
                       f"tiles of {td} columns, in {str(dtype).split('.')[-1]}"}


def phase_kernels():
    rng = np.random.default_rng(0)
    cases = {"hadamard_quant": [], "int4_matmul": [], "paged_attention": [],
             "combine_partials": [], "block_hadamard": []}
    for shape, b, dt in (((4, 1, 8192), 16, torch.float32),   # the probe
                         ((32, 8192), 16, torch.float32),     # prefill chunk
                         ((32, 8192), 16, torch.bfloat16),
                         ((32, 3072), 12, torch.float32),     # Paley order
                         ((32, 8192), 256, torch.float32),
                         ((32, 2048), 2048, torch.float32),   # b = D
                         ((37, 2048), 32, torch.bfloat16)):   # ragged M
        cases["block_hadamard"].append(check_block_hadamard(rng, shape, b, dt))
    for m in (4, 32):
        for d, b, dt in ((2048, 1, torch.bfloat16), (8192, 16, torch.bfloat16),
                         (8192, 32, torch.bfloat16), (8192, 16, torch.float32),
                         (8192, 1, torch.float32)):
            cases["hadamard_quant"].append(check_hadamard_quant(rng, m, d, b, dt))
    cases["hadamard_quant"].append(
        check_hadamard_quant(rng, 4, 3072, 12, torch.float32))   # Paley order
    for m, d, b, dt in ((1, 2048, 1, torch.bfloat16),      # one row
                        (37, 8192, 16, torch.bfloat16),    # ragged M
                        (37, 8192, 16, torch.float32),
                        (4, 19200, 64, torch.float32),     # > 48 KB rows, uneven slices
                        (4, 8192, 8192, torch.float32)):   # one slice is the row
        cases["hadamard_quant"].append(check_hadamard_quant(rng, m, d, b, dt))
    for m in (4, 32, 16, 17):
        for k, n in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)):
            cases["int4_matmul"].append(check_int4_matmul(rng, m, k, n))
    cases["int4_matmul"].append(check_int4_matmul(rng, 5, 250, 514))  # ragged
    theta = 500000.0
    for fmt in ("int4", "int8", "bf16"):
        cases["paged_attention"].append(check_attention(
            rng, "decode", fmt, 4, 1, [120, 0, 37, 113], 8, theta))
    for fmt in ("int4", "int8", "bf16"):
        cases["paged_attention"].append(check_attention(
            rng, "prefill", fmt, 1, 32, [128], 8, theta))
    # the serve path's own shapes: a 32-token prefill chunk of 4 sequences
    # over ~170 cached tokens, and a decode step over a 32-column table (the
    # full 8 splits of 4 columns)
    cases["paged_attention"].append(check_attention(
        rng, "prefill chunk", "int4", 4, 32, [202, 190, 171, 185], 13, theta))
    cases["paged_attention"].append(check_attention(
        rng, "decode, 32-column table", "int4", 4, 1, [500, 0, 311, 129], 32,
        theta))
    # long contexts: 4096 cached tokens and a 256-column table, so 8 splits
    # of 32 columns; the pools hold the live pages only (~10 MB a layer of
    # int4 pages)
    for fmt in ("int4", "bf16"):
        cases["paged_attention"].append(check_attention(
            rng, "decode, 256-column table", fmt, 4, 1, [4096, 0, 2900, 1500], 256,
            theta, live_pool=True))
    # the split merge in the kernel's last-arriving block (the reference's
    # `_combine_kernel`): explicit 2 and 8 splits over 8 columns and 13 over
    # 16 (splits 8-12 past the table), dead splits and a row of length 0
    for ks, n_cols, lens in ((2, 8, [120, 0, 37, 113]), (8, 8, [120, 0, 37, 113]),
                             (13, 16, [250, 0, 37, 113])):
        cases["combine_partials"].append(check_attention(
            rng, f"merge KS={ks}", "int4", 4, 1, lens, n_cols, theta, kv_splits=ks))
    if not cases["paged_attention"][0]["used_combine"]:
        fail("the decode attention case did not take the split path")
    bad = [(k, c["shape"]) for k, cs in cases.items() for c in cs if not c["ok"]]
    emit("kernels", ok=not bad, cases=cases)
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    return cases


def phase_sweep():
    """The attention kernel under other launch plans (`PLAN_ROWS` block
    rows; warps per block and keys per tile, set for decode and prefill
    alike) at the prefill and decode cases. Every plan must still agree with the plain version; the
    defaults are restored afterwards."""
    theta = 500000.0
    prefill = [("prefill", "bf16", 1, 32, [128], 8),
               ("prefill", "int4", 1, 32, [128], 8),
               ("prefill chunk", "int4", 4, 32, [202, 190, 171, 185], 13)]
    decode = [("decode", "int4", 4, 1, [120, 0, 37, 113], 8),
              ("decode, 32-column table", "int4", 4, 1, [500, 0, 311, 129], 32)]
    knobs = ("PLAN_ROWS", "PLAN_DECODE", "PLAN_PREFILL")
    default = tuple(getattr(PA, k) for k in knobs)
    plans = sorted({(r, w, keys) for r in (16, 32, 64) for w in (4, 8)
                    for keys in (64, 128)} | {(32, 8, 32)})
    out = []
    try:
        for cases, decoding in ((prefill, False), (decode, True)):
            for plan in plans:
                if decoding and plan[0] != default[0]:
                    continue          # one row per query head at decode
                rows, warps, keys = plan
                for k, v in zip(knobs, (rows, (warps, keys), (warps, keys))):
                    setattr(PA, k, v)
                for case in cases:
                    c = check_attention(np.random.default_rng(5), *case, theta)
                    out.append({"plan_rows": rows, "plan_warps": warps,
                                "tile_keys": keys, "shape": c["shape"],
                                "plan": c["plan"], "ok": c["ok"],
                                "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                                "library_ms": c["library_ms"]})
    finally:
        for k, v in zip(knobs, default):
            setattr(PA, k, v)
    ok = all(r["ok"] for r in out)
    emit("sweep", ok=ok, defaults=dict(zip(knobs, default)), runs=out)
    if not ok:
        fail("an attention plan disagrees with the plain version")
    sweep_int4()
    sweep_hadamard()
    sweep_hadamard_quant()


def _with_knobs(module, knobs: dict, fn):
    """fn() with module-level plan knobs set, restored afterwards."""
    old = {k: getattr(module, k) for k in knobs}
    try:
        for k, v in knobs.items():
            setattr(module, k, v)
        return fn()
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def sweep_int4():
    """`int4_matmul` under other plans at the serve path's shapes and M = 4,
    8, 16, 17, 32: the target block count (which sets the K splits) and the
    tile rows. Every plan must give the exact integer product."""
    rng = np.random.default_rng(7)
    grid = [{"PLAN_BLOCKS": bl, "PLAN_ROWS": r}
            for bl in (132, 264, 528) for r in (32, 64)]
    runs = []
    for m in (4, 8, 16, 17, 32):
        for k, n in ((2048, 8192), (8192, 2048), (2048, 512)):
            qa = torch.from_numpy(rng.integers(0, 16, (m, k)).astype(np.int8)).to(DEV)
            wc = torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.int8)).to(DEV)
            wps = [I4.int4_pack(wc) for _ in range(n_copies(k * n // 2))]
            one_m = torch.ones((m, 1), device=DEV)
            zero_m = torch.zeros((m, 1), device=DEV)
            one_n = torch.ones((n,), device=DEV)
            cs = I4.int4_colsum(wps[0])
            want = qa.double() @ wc.double()
            for knobs in grid:
                def run():
                    got = I4.int4_matmul(qa, one_m, zero_m, wps[0], one_n, cs)
                    exact = bool(torch.equal(got.double(), want))
                    ms = device_ms([lambda w=w: I4.int4_matmul(qa, one_m, zero_m, w,
                                                               one_n, cs) for w in wps])
                    return exact, ms, I4.int4_plan(m, n, k).__dict__
                exact, ms, plan = _with_knobs(I4, knobs, run)
                runs.append({"shape": f"q_a[{m},{k}] w[{k // 2},{n}]", "knobs": knobs,
                             "plan": plan, "ok": exact, "ms": ms})
    ok = all(r["ok"] for r in runs)
    emit("sweep_int4_matmul", ok=ok, runs=runs)
    if not ok:
        fail("an int4_matmul plan gave a wrong integer product")


def sweep_hadamard():
    """`block_hadamard` under other plans: elements per thread and the
    target block count, at the three cases held against `torch.matmul` and
    at b = D (the block kernel)."""
    rng = np.random.default_rng(8)
    runs = []
    for shape, b, dt in (((4, 1, 8192), 16, torch.float32),
                         ((32, 8192), 16, torch.bfloat16),
                         ((37, 2048), 32, torch.bfloat16),
                         ((32, 2048), 2048, torch.float32)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(DEV).to(dt)
        want = BH.block_hadamard_plain(x, b).float()
        # the kernels phase's rule: 2e-5 of max|y|, + one bf16 ulp for bf16
        tol = 2e-5 * float(want.abs().max()) + (
            2 ** -7 * want.abs() if dt == torch.bfloat16 else 0.0)
        xs = [x.clone() for _ in range(n_copies(x.numel() * x.element_size()))]
        for elems in (4, 8, 16):
            for blocks in (33, 66, 132, 264, 528):
                knobs = {"PLAN_ELEMS": elems, "PLAN_BLOCKS": blocks}

                def run():
                    diff = (BH.block_hadamard(x, b).float() - want).abs()
                    ms = device_ms([lambda t=t: BH.block_hadamard(t, b) for t in xs])
                    d = shape[-1]
                    return (bool((diff <= tol).all()), float(diff.max()), ms,
                            BH.hadamard_plan(x.numel() // d, d, b).__dict__)
                ok, err, ms, plan = _with_knobs(BH, knobs, run)
                runs.append({"shape": f"x[{','.join(map(str, shape))}] "
                                      f"{str(dt).split('.')[-1]} b={b}",
                             "knobs": knobs, "plan": plan, "ok": ok,
                             "max_abs_err": err, "ms": ms})
    ok = all(r["ok"] for r in runs)
    emit("sweep_block_hadamard", ok=ok, runs=runs)
    if not ok:
        fail("a block_hadamard plan disagrees with the plain version")


def sweep_hadamard_quant():
    """`hadamard_quant` under other plans: slices (cluster size) per row and
    elements per thread, at the decode and prefill shapes. Every plan must
    agree with the plain version by the kernels phase's rule."""
    rng = np.random.default_rng(9)
    runs = []
    for m, d, b in ((4, 2048, 1), (4, 8192, 16), (32, 2048, 1), (32, 8192, 16)):
        x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32) * 3.0)
        x = x.to(DEV).to(torch.bfloat16)
        plain = HQ.hadamard_quant_plain(x, b, 4)
        xs = [x.clone() for _ in range(n_copies(x.numel() * x.element_size()))]
        for cluster in (1, 2, 4, 8):
            for elems in (4, 8, 16):
                knobs = {"PLAN_CLUSTER": cluster, "PLAN_ELEMS": elems}

                def run():
                    ok = hadamard_quant_agrees(HQ.hadamard_quant(x, b, bits=4), plain)[0]
                    ms = device_ms([lambda t=t: HQ.hadamard_quant(t, b, bits=4)
                                    for t in xs])
                    return ok, ms, HQ.hadamard_quant_plan(m, d, b).__dict__
                ok, ms, plan = _with_knobs(HQ, knobs, run)
                runs.append({"shape": f"x[{m},{d}] bfloat16 b={b}", "knobs": knobs,
                             "plan": plan, "ok": ok, "ms": ms})
    ok = all(r["ok"] for r in runs)
    emit("sweep_hadamard_quant", ok=ok, runs=runs)
    if not ok:
        fail("a hadamard_quant plan disagrees with the plain version")


# ---------------------------------------------------------------------------
# phase: serve
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--arch", "llama3-1b", "--integer-path", "--block-size", "16",
              "--admission", "reserve", "--slots", "4", "--page-size", "16",
              "--prefill-chunk", "32", "--max-len", "512", "--device", "cuda"]
# the kernels every serve run launches; block_hadamard runs only in the
# rotation-quality probe (--probe-every)
MAIN_PATH_KERNELS = ("hadamard_quant", "int4_matmul", "paged_attention",
                     "combine_partials")
PROBE_EVERY = 4


def run_launcher(label, extra, expect=MAIN_PATH_KERNELS):
    """One launcher run with every count set to 0 just before and read just
    after; every kernel in `expect` must have launched. Returns (the
    launcher's result, record)."""
    from repro_torch.launch import serve as serve_cli
    buf = io.StringIO()
    kops.reset_kernel_launch_counts()
    kops.reset_dispatch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = serve_cli.main(SERVE_ARGS + extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kops.kernel_launch_counts()
    plain = {f"{e}": n for (e, path), n in kops.dispatch_counts().items()
             if path == "ref"}
    lines = [ln for ln in buf.getvalue().splitlines()
             if "served" in ln or ln.startswith(("summary:", "quality:"))]
    done, engine, snap = result["done"], result["engine"], result["snapshot"]
    alloc = engine.kv.allocator
    steps = snap["counters"]["engine.steps"]
    step_s = snap["histograms"]["engine.step.wall_s"]["sum"]
    toks = snap["counters"]["engine.generated_tokens"]
    rec = {
        "label": label, "args": extra, "requests": len(done),
        "outcomes": sorted({r.outcome for r in done}),
        "prompt_tokens": [len(r.prompt) for r in sorted(done, key=lambda r: r.rid)],
        "engine_steps": steps, "generated_tokens": toks,
        "tokens_per_s": toks / max(step_s, 1e-9),
        "ms_per_engine_step": 1e3 * step_s / max(steps, 1),
        "wall_s_with_setup": wall, "kernel_launches": launches,
        "plain_dispatches": plain, "pages_in_use_at_end": alloc.in_use,
        "launcher_lines": lines,
        "peak_device_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    problems = []
    if len(done) != int(extra[extra.index("--requests") + 1]):
        problems.append("not every request came back")
    if rec["outcomes"] != ["length"]:
        problems.append(f"outcomes {rec['outcomes']} (a non-finite logit "
                        "row ends as 'failed')")
    if alloc.in_use != 0 or alloc.n_free != alloc.capacity or engine.kv.tables:
        problems.append("pages left in use")
    engine.check_books()
    for name in expect:
        if launches[name] <= 0:
            problems.append(f"kernel {name} was never launched")
    if plain:
        problems.append(f"plain versions ran on the main path: {plain}")
    for r in done:
        if len(r.generated) != r.sampling.max_new or \
                not all(0 <= t < engine.adapter.cfg.vocab for t in r.generated):
            problems.append(f"request {r.rid}: bad token stream")
    rec["ok"] = not problems
    rec["problems"] = problems
    return result, rec


def check_observed(rec, result, plain_tokens, trace_path, metrics_path):
    """The gates of the observed run (`--probe-every --trace
    --metrics-json`) beyond those of every run: appended to
    rec["problems"]."""
    from repro_torch.serve.telemetry import (PROBE_STATS, validate_snapshot,
                                             validate_trace)
    problems = rec["problems"]
    tokens = [r.generated for r in sorted(result["done"], key=lambda r: r.rid)]
    if tokens != plain_tokens:
        problems.append("probes and tracing changed the generated tokens")
    snap = result["snapshot"]
    n_layers = result["engine"].adapter.cfg.n_layers
    probed = snap["counters"]["quality.probe_dispatches"]
    decodes = snap["histograms"]["engine.decode.batch_occupancy"]["count"]
    if probed != -(-decodes // PROBE_EVERY):
        problems.append(f"{probed} probed of {decodes} decode dispatches")
    if rec["kernel_launches"]["block_hadamard"] != n_layers * probed:
        problems.append(f"block_hadamard launched "
                        f"{rec['kernel_launches']['block_hadamard']} times, "
                        f"not {n_layers} x {probed}")
    quality = {}
    for stat in PROBE_STATS:
        h = snap["histograms"][f"quality.{stat}"]
        layers = [snap["gauges"][f"quality.layer{l:02d}.{stat}"]
                  for l in range(n_layers)]
        quality[stat] = {"count": h["count"], "min": h["min"],
                         "p50": h["p50"], "max": h["max"]}
        if h["count"] != n_layers * probed or not all(
                math.isfinite(v) for v in layers + [h["min"], h["max"]]):
            problems.append(f"quality.{stat}: {h['count']} observations, "
                            "or a value that is not finite")
        if stat.startswith("l1_imbalance") and h["min"] < 1.0:
            problems.append(f"quality.{stat} below 1: {h['min']}")
    with open(trace_path) as f:
        trace = json.load(f)
    try:
        with open(metrics_path) as f:
            validate_snapshot(json.load(f))
        n_events = validate_trace(trace)
    except ValueError as e:
        problems.append(f"artifact refused: {e}")
        n_events = None
    spans = [e for e in trace["traceEvents"]
             if e["name"] in ("dispatch.decode", "dispatch.prefill")]
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.telemetry.check",
         metrics_path, "--trace", trace_path], capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if cli.returncode != 0:
        problems.append(f"check CLI exit {cli.returncode}: {cli.stderr}")
    probe_ms = [e["dur"] / 1e3 for e in spans
                if e["name"] == "dispatch.decode" and e["args"]["probe"]]
    plain_ms = [e["dur"] / 1e3 for e in spans
                if e["name"] == "dispatch.decode" and not e["args"]["probe"]]
    rec.update(probe_dispatches=probed, decode_dispatches=decodes,
               quality=quality, trace_events=n_events,
               check_cli=cli.stdout.strip().splitlines(),
               traced_decode_ms_median={
                   "probed": float(np.median(probe_ms)) if probe_ms else None,
                   "unprobed": float(np.median(plain_ms)) if plain_ms else None})
    rec["ok"] = not problems


def phase_serve():
    torch.cuda.reset_peak_memory_stats()
    full_args = ["--kv-bits", "4", "--requests", "8", "--max-new", "16",
                 "--prompt-len", "40-160"]
    result, full = run_launcher("llama3-1b, 16 layers, int4 KV pages",
                                full_args)
    plain_tokens = [r.generated
                    for r in sorted(result["done"], key=lambda r: r.rid)]
    del result
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "trace.json")
        metrics_path = os.path.join(tmp, "metrics.json")
        result, observed = run_launcher(
            "the same, observed: probes every 4 decode dispatches, traced",
            full_args + ["--probe-every", str(PROBE_EVERY), "--trace",
                         trace_path, "--metrics-json", metrics_path],
            expect=MAIN_PATH_KERNELS + ("block_hadamard",))
        check_observed(observed, result, plain_tokens, trace_path,
                       metrics_path)
    runs = [full, observed]
    adapter = result["engine"].adapter
    del result
    for label, extra in (
            ("llama3-1b widths, 2 layers, int8 KV pages",
             ["--kv-bits", "8", "--layers", "2"]),
            ("llama3-1b widths, 2 layers, bf16 KV pages", ["--layers", "2"])):
        _, rec = run_launcher(label, extra + [
            "--requests", "4", "--max-new", "8", "--prompt-len", "70-100"])
        runs.append(rec)
    emit("serve", ok=all(r["ok"] for r in runs), runs=runs)
    bad = [(r["label"], r["problems"]) for r in runs if not r["ok"]]
    if bad:
        fail(f"serve phase: {bad}")
    return {**full["kernel_launches"],
            "block_hadamard": observed["kernel_launches"]["block_hadamard"]}, \
        adapter


# ---------------------------------------------------------------------------
# phase: parity
# ---------------------------------------------------------------------------

# Kernels and plain versions run the same f32 arithmetic in other summation
# orders. Each kernel is held to its plain version within 2e-5 in the
# `kernels` phase, and on this seeded state the whole model's logits have
# come out equal bit for bit, so the bound on the logits is 0.1 % of
# max|logit|: a kernel that is off in the second decimal fails here. The
# greedy token must be the same on every row whose top-2 gap exceeds twice
# that bound, and a step where no row is so decided fails the phase.
PARITY_FRAC = 1e-3


def phase_parity(adapter):
    qlm, params = adapter.qlm, adapter.params
    cfg = qlm.cfg
    rng = np.random.default_rng(1)
    page, n_pages, b = 16, 16, 4
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 97))).to(DEV)
    table = list(range(1, 8))

    def bt_for(n_cols, rows):
        t = torch.zeros((rows, n_cols), dtype=torch.int32, device=DEV)
        t[0, :min(n_cols, len(table))] = torch.tensor(
            table[:n_cols], dtype=torch.int32, device=DEV)
        return t

    def compare(tag, got, want):
        got, want = got.float(), want.float()
        top = float(want.abs().max())
        err = float((got - want).abs().max())
        srt = want.sort(dim=-1).values
        gap = srt[..., -1] - srt[..., -2]
        decided = gap > 2 * PARITY_FRAC * top
        same = got.argmax(-1) == want.argmax(-1)
        ok = (err <= PARITY_FRAC * top and bool(decided.any())
              and bool(same[decided].all())
              and bool(torch.isfinite(got).all()))
        return {"step": tag, "ok": ok, "max_abs_err": err, "max_abs_logit": top,
                "bound": PARITY_FRAC * top,
                "rows_with_decided_argmax": int(decided.sum()),
                "rows": int(decided.numel()),
                "greedy_equal_all_rows": bool(same.all())}

    pool_k = qlm.init_cache(n_pages, page, device=DEV)
    pool_p = {k: v.clone() for k, v in pool_k.items()}
    lens = torch.tensor([32], dtype=torch.int32, device=DEV)
    out = []
    lk, _ = qlm.forward_chunk(params, toks[:, :32], pool_k, 0, bt_for(2, 1), lens)
    with kops.use_kernels(False):
        lp, _ = qlm.forward_chunk(params, toks[:, :32], pool_p, 0, bt_for(2, 1), lens)
    out.append(compare("prefill chunk [1, 32] at position 0", lk[0], lp[0]))
    for start in (32, 64):      # fill 96 positions, kernels only
        n_cols = 1
        while n_cols * page < start + 32:
            n_cols *= 2
        qlm.forward_chunk(
            params, toks[:, start:start + 32], pool_k, start, bt_for(n_cols, 1),
            torch.tensor([start + 32], dtype=torch.int32, device=DEV))
    for k_ in pool_k:
        pool_p[k_].copy_(pool_k[k_])            # the same state for both
    nxt = torch.zeros((b, 1), dtype=torch.int64, device=DEV)
    nxt[0, 0] = toks[0, 96]
    fill = torch.tensor([96, 0, 0, 0], dtype=torch.int32, device=DEV)
    dl = torch.tensor([97, 0, 0, 0], dtype=torch.int32, device=DEV)
    pool_q = {k_: v.clone() for k_, v in pool_k.items()}
    before = kops.kernel_launch_counts()["combine_partials"]
    lk, _ = qlm.forward_chunk(params, nxt, pool_k, fill, bt_for(8, b), dl)
    took_split = kops.kernel_launch_counts()["combine_partials"] > before
    # the probed decode step from the same state: its logits must be those
    # of the unprobed step bit for bit, and its stats those of the plain
    # versions' probed step within 1e-4 relative (sat_rate: or within one
    # code of the layer's b x d_ff codes, for a code on a rounding tie)
    lq, _, sq = qlm.forward_chunk(params, nxt, pool_q, fill, bt_for(8, b), dl,
                                  probe=True)
    with kops.use_kernels(False):
        lp, _, sp = qlm.forward_chunk(params, nxt, pool_p, fill, bt_for(8, b),
                                      dl, probe=True)
    torch.cuda.synchronize()
    out.append(compare("decode step [4, 1], row 0 at position 96, rows 1-3 "
                       "of length 0", lk[:, 0], lp[:, 0]))
    probe_neutral = bool(torch.equal(lk, lq))
    numel = b * cfg.d_ff
    stats = {}
    for name in sq:
        got, want = sq[name].double(), sp[name].double()
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        fine = rel <= 1e-4 or (name == "sat_rate" and float(
            (got - want).abs().max()) <= 1.0 / numel + 1e-7)
        stats[name] = {"max_rel_err": rel, "ok": fine and bool(
            torch.isfinite(got).all()), "kernels": got.tolist()}
    ok = (all(c["ok"] for c in out) and took_split and probe_neutral
          and all(v["ok"] for v in stats.values()))
    emit("parity", ok=ok, layers=cfg.n_layers, kv_bits=qlm.kv_bits,
         decode_took_split_path=took_split, steps=out,
         probed_decode_logits_equal_unprobed=probe_neutral,
         probe_stats_kernels_vs_plain=stats,
         tolerance=f"{PARITY_FRAC} of max|logit|, greedy tokens equal where "
                   "the top-2 gap is over twice that (see source); probed "
                   "logits bit-equal; probe stats 1e-4 relative")
    if not ok:
        fail(f"parity phase: {out}, split path {took_split}, probe neutral "
             f"{probe_neutral}, probe stats {stats}")


# ---------------------------------------------------------------------------
# phase: profile (optional)
# ---------------------------------------------------------------------------

# the device kernels of each hand-written kernel, by the names that
# torch.profiler's keys contain; combine_partials has none of its own - the
# split merge runs inside paged_attention_kernel, in its last-arriving split
HAND_WRITTEN_KERNELS = {
    "int4_matmul": ("i4_mma_kernel",),
    "hadamard_quant": ("hq_cluster_kernel",),
    "paged_attention": ("paged_attention_kernel",),
    "block_hadamard": ("bh_warp_kernel", "bh_block_kernel", "bh_dense_kernel"),
}


def _decoding_engine(adapter, *, eager: bool):
    """An engine whose 4 sequences of 64 prompt tokens are prefilled, so
    each further step is a pure decode step. The first row decodes from ~73
    cached tokens, the last from 65; tables stay at 8 columns up to 128
    cached tokens, past the ~50 steps the callers time, so no capture of a
    new variant falls inside a timed window."""
    from repro_torch.serve.engine import (EngineRequest, SamplingParams,
                                          ServeEngine)
    engine = ServeEngine(adapter, n_pages=4 * 16 + 1, page_size=16, max_seqs=4,
                         prefill_chunk=32, eager=eager)
    rng = np.random.default_rng(3)
    for rid in range(4):
        engine.submit(EngineRequest(
            rid=rid, prompt=rng.integers(0, adapter.cfg.vocab, 64).tolist(),
            sampling=SamplingParams(max_new=150)))
    while engine.queue or engine.prefilling:
        engine.step()
    return engine


def _step_ms(engine, n: int) -> list[float]:
    """Host milliseconds of each of n engine steps; every step ends in the
    transfer of its tokens, which waits for the device."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        engine.step()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


class _TimedReplay:
    """Stands in for a captured graph and records CUDA events around each
    replay: the device time of the replay, whatever the profiler shows of
    the kernels inside it."""

    def __init__(self, graph):
        self.graph, self.events = graph, []

    def replay(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        self.events.append((start, end))


def phase_graph(adapter):
    """The engine's decode dispatch captured as CUDA graphs, against the
    same engine dispatching eagerly (its test-only `eager=True`): the same
    requests - three greedy, one sampled row with top-k and top-p - served
    by both with every count set to 0 just before each run and read just
    after. Tokens and every step's logits must be equal bit for bit, the
    launch counts and dispatch tallies equal, plain dispatches none. Then
    host ms per pure decode step of both engines, interleaved."""
    from repro_torch.serve.engine import (EngineRequest, SamplingParams,
                                          ServeEngine)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, adapter.cfg.vocab, n).tolist()
               for n in (70, 150, 33, 110)]
    samplings = [SamplingParams(max_new=24),
                 SamplingParams(max_new=12, temperature=0.8, top_k=50,
                                top_p=0.95),
                 SamplingParams(max_new=24), SamplingParams(max_new=20)]

    def serve(eager):
        engine = ServeEngine(adapter, n_pages=4 * 12 + 1, page_size=16,
                             max_seqs=4, prefill_chunk=32, seed=3,
                             record_logits=True, eager=eager)
        for rid, (p, sp) in enumerate(zip(prompts, samplings)):
            engine.submit(EngineRequest(rid=rid, prompt=p, sampling=sp))
        kops.reset_kernel_launch_counts()
        kops.reset_dispatch_counts()
        done = engine.run()
        torch.cuda.synchronize()
        launches, dispatch = kops.count_snapshot()
        engine.check_books()
        return engine, {r.rid: r for r in done}, launches, dispatch

    _, want, want_launches, want_dispatch = serve(eager=True)
    graphed, got, launches, dispatch = serve(eager=False)
    problems = []
    tokens_equal = all(got[r].generated == want[r].generated for r in want)
    steps = [(g, w) for r in want
             for g, w in zip(got[r].step_logits, want[r].step_logits)]
    unequal = [float(np.abs(g - w).max()) for g, w in steps
               if not np.array_equal(g, w)]
    if sorted(got) != sorted(want) or not tokens_equal:
        problems.append("tokens differ between the graphed and eager engines")
    if any(len(got[r].step_logits) != len(want[r].step_logits) for r in want):
        problems.append("a request recorded another number of logits rows")
    if unequal:
        problems.append(f"{len(unequal)} of {len(steps)} logits rows differ")
    if launches != want_launches or dispatch != want_dispatch:
        problems.append(f"counts differ: graphed {launches} {dispatch}, "
                        f"eager {want_launches} {want_dispatch}")
    plain = {e: n for (e, path), n in dispatch.items() if path == "ref"}
    if plain:
        problems.append(f"plain versions ran: {plain}")
    for name in MAIN_PATH_KERNELS:
        if launches[name] <= 0:
            problems.append(f"kernel {name} was never launched")
    if any(r.outcome != "length" for r in got.values()):
        problems.append("a request did not end 'length'")
    stats = graphed.graph_stats()
    decodes = graphed.metrics.histogram("engine.decode.batch_occupancy").count
    variants = sorted(key[2] for key in graphed._graphs)
    del graphed
    # host ms per pure decode step, the two engines interleaved (ABBA)
    engines = {"eager": _decoding_engine(adapter, eager=True),
               "graphed": _decoding_engine(adapter, eager=False)}
    for engine in engines.values():
        _step_ms(engine, 3)        # the graphed engine captures here
    ms = {"eager": [], "graphed": []}
    for order in (("eager", "graphed"), ("graphed", "eager")) * 2:
        for name in order:
            ms[name].append(_step_ms(engines[name], 6))
    host = {name: {"median": float(np.median(sum(runs, []))),
                   "mean": float(np.mean(sum(runs, []))),
                   "block_means": [float(np.mean(r)) for r in runs]}
            for name, runs in ms.items()}
    ok = not problems
    emit("graph", ok=ok, problems=problems, requests=len(got),
         decode_dispatches=decodes, graphs_captured=stats["graphs"],
         variants=[list(v) for v in variants],
         variant_fields=["n_cols", "probe", "samples", "filtered"],
         pool_mib=stats["pool_bytes"] / 2 ** 20, capture_s=stats["capture_s"],
         tokens_equal=tokens_equal, logits_rows=len(steps),
         logits_rows_unequal=len(unequal),
         logits_max_abs_diff=max(unequal, default=0.0),
         kernel_launches=launches, eager_kernel_launches=want_launches,
         plain_dispatches=plain,
         host_ms_per_decode_step=host,
         graphed_over_eager=host["graphed"]["median"] / host["eager"]["median"],
         tolerance="tokens equal, logits bit-equal, counts equal")
    if not ok:
        fail(f"graph phase: {problems}")


def phase_profile(adapter):
    """Where a pure decode step's time goes, eager and graphed: 4 sequences
    of ~65-125 cached tokens, host ms per step (median of steps timed one
    by one), then the same steps under torch.profiler for the device-busy
    time and the kernels by share - unprobed, then with the
    rotation-quality probe on every decode step; the two engines in turns
    (eager, graphed, graphed, eager). For the graphed engine CUDA events
    around each replay of the host-timed steps give the replay's device
    span (outside the profiler, whose tracing slows a replay) beside the
    profiler's kernel sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.telemetry import QualityProbes
    engines = {"eager": _decoding_engine(adapter, eager=True),
               "graphed": _decoding_engine(adapter, eager=False)}

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def measure(engine, n=10, warmup=3):
        _step_ms(engine, warmup)
        torch.cuda.synchronize()
        variants = len(engine._graphs)
        timed = {}
        for key, call in engine._graphs.items():
            if call.graph is not None:
                call.graph = timed[key] = _TimedReplay(call.graph)
        host = _step_ms(engine, n)
        for key, t in timed.items():
            engine._graphs[key].graph = t.graph
        replays = [s.elapsed_time(e) for t in timed.values() for s, e in t.events]
        kops.reset_kernel_launch_counts()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                engine.step()
            torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t0) / n
        launches = kops.kernel_launch_counts()
        # kernel events only: an aten op's own row repeats the device time
        # of the kernels it launched, so summing every row counts it twice
        rows = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows) / 1e3 / n
        hand = {name: sum(us for key, us, _ in rows
                          if any(kn in key for kn in names)) / 1e3 / n
                for name, names in HAND_WRITTEN_KERNELS.items()}
        wall_ms = float(np.median(host))
        return dict(
            decode_rows=len(engine.decoding), steps=n,
            ms_per_decode_step=wall_ms,
            ms_per_decode_step_mean=float(np.mean(host)),
            ms_per_decode_step_profiled=prof_wall_ms,
            device_busy_ms_per_step=busy_ms,
            device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
            variants_new_in_window=len(engine._graphs) - variants,
            replays_timed=len(replays),
            replay_device_ms=float(np.mean(replays)) if replays else None,
            device_kernels_per_step=sum(r[2] for r in rows) / n,
            hand_written_launches_per_step={k: v / n
                                            for k, v in launches.items()},
            hand_written_device_ms_per_step=hand,
            merged_inside={"combine_partials": "paged_attention_kernel"},
            int4_matmul_share_of_busy=(hand["int4_matmul"] / busy_ms
                                       if busy_ms else None),
            top_device_kernels=[{"name": k[:90], "ms_per_step": us / 1e3 / n,
                                 "calls_per_step": c / n}
                                for k, us, c in rows[:14]])

    out = {"eager": {}, "graphed": {}}
    for name in ("eager", "graphed"):
        out[name]["plain"] = measure(engines[name])
    # from here on every decode step runs the probe variant (its capture
    # is the graphed engine's warm-up step)
    for name in ("graphed", "eager"):
        engine = engines[name]
        engine.quality_probes = QualityProbes(every_k=1)
        engine.quality_probes.bind(engine.metrics)
        out[name]["probed_every_step"] = measure(engine, warmup=1)
    emit("profile", **out, order="eager, graphed, then probed: graphed, eager",
         graphed_over_eager_host_ms={
             k: out["graphed"][k]["ms_per_decode_step"]
             / out["eager"][k]["ms_per_decode_step"] for k in out["eager"]},
         probe_cost_ms_per_step={
             name: o["probed_every_step"]["ms_per_decode_step"]
             - o["plain"]["ms_per_decode_step"] for name, o in out.items()},
         probe_cost_device_ms_per_step={
             name: o["probed_every_step"]["device_busy_ms_per_step"]
             - o["plain"]["device_busy_ms_per_step"] for name, o in out.items()})


# ---------------------------------------------------------------------------

# the case of each kernel that the closing record reports: the shape a
# decode step of the served model gives it
REPORTED = {
    "hadamard_quant": "x[4,8192] bfloat16 b=16 bits=4",
    "int4_matmul": "q_a[4,2048] w[1024,8192]",
    "paged_attention": "decode: q[4,1,32,64] bf16, int4 pages",
    "combine_partials": "merge KS=2:",
    "block_hadamard": "x[4,1,8192] float32 b=16",
}


def kernel_record(cases, launches):
    """One row per kernel at its `REPORTED` case. combine_partials has no
    launch of its own: its `ms` and `call_ms` are of the one launch that
    walks and merges, its bound and plain time those of the merge alone."""
    rows = []
    for name, meta in KERNEL_META.items():
        case = next(c for c in cases[name] if c["shape"].startswith(REPORTED[name]))
        merge = name == "combine_partials"
        rows.append({"name": name, **meta, "launches": launches[name],
                     "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                     "plain_ms": case["merge_plain_ms" if merge else "plain_ms"],
                     "bound_ms": case["merge_bound_ms" if merge else "bound_ms"],
                     "bound_by": case["merge_bound_by" if merge else "bound_by"],
                     "library_ms": case["library_ms"],
                     "library": case.get("library"), "shape": case["shape"],
                     "call_ms": case["call_ms"]})
    return {"kernels": rows}


def phase_device():
    line = nvidia_smi_line()
    emit("device", nvidia_smi=line, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return line


def phase_build(ptxas: bool):
    _build.load()
    info = _build.BUILD_INFO
    emit("build", seconds=info["seconds"], library=info["library"],
         sources=[s.name for s in _build.sources()])
    if ptxas:
        # compiled again for the report alone, so it comes also when the
        # library was already built
        rows, log = _build.ptxas_report()
        emit("ptxas", kernels=rows)
        print(log, file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also break a decode step down with torch.profiler")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the attention, int4_matmul, block_hadamard "
                         "and hadamard_quant kernels under other plans")
    ap.add_argument("--ptxas", action="store_true",
                    help="report ptxas -v per kernel (a JSON phase, the raw "
                         "log on stderr)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_device()
    phase_build(args.ptxas)
    cases = phase_kernels()
    if args.sweep:
        phase_sweep()
    launches, adapter = phase_serve()
    phase_parity(adapter)
    phase_graph(adapter)
    if args.profile:
        phase_profile(adapter)
    print(smi, flush=True)
    print(json.dumps(kernel_record(cases, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
