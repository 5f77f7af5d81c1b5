#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one CUDA device

Builds the CUDA kernels from `src/repro_torch/kernels/csrc/`, holds each
against its plain PyTorch version on the card at the serving path's
full-width shapes, serves llama3-1b (16 layers, seeded random weights,
`rtn_only` through the PTQ pipeline) through `repro_torch.launch.serve`
with true-integer W4A4 arithmetic and an int4 KV page pool - once plain,
once observed (`--probe-every 4 --trace --metrics-json`, which runs
`block_hadamard` in the rotation-quality probe), each decode step one
replay of a captured CUDA graph - checks the kernels' logits against the
plain versions' on the same state and the graphed decode against the eager
one, then runs the paper's PTQ pipeline on the card and serves its results
on all three paths. Phases print one JSON line each:

    device   card name and power limit (nvidia-smi)
    build    seconds nvcc took
    kernels  per kernel: error against the plain version, times, bound; the
             split merge (the reference's `_combine_kernel`) inside the
             attention launch, bit-equal over 20 launches; attention also at
             the MoE and hybrid families' widths (16 heads of 128, 32 of 64,
             one query head per KV head, f32 pages)
    serve    the launcher at full width and depth, plain and observed, then
             two short runs
    parity   one prefill chunk and one decode step, kernels vs plain, and
             the probed decode step against the unprobed one
    graph    the engine's decode step replayed from captured CUDA graphs
             (its dispatch on the card) against the same engine run eagerly:
             tokens, logits and counts equal; graphs captured, their pool's
             memory, capture time; host ms per pure decode step of both,
             interleaved
    robust   the engine's robustness at full width and depth, decode graphed:
             a reserve baseline, optimistic admission on a pool of 60 % of
             the worst case (preemption and replay), the same with the host
             swap tier, the prefix cache on a shared 64-token prefix, a
             seeded fault plan ending in drain(), and one launcher run with
             the prefix cache, the swap tier and --drain-after; books every
             step, tiers empty at the end, tokens against the baseline
    ptq      `quantize_model` at llama3-1b's full width and depth (one
             [4, 128] calibration batch, as the launcher): rtn_only,
             perq_star with and without MassDiff, quarot and the RTN gate
             pair (MassDiff against identity), then the three Qronos runs
             again on 8 batches; per run seconds, peak device
             memory, per-layer max block l1 and the fake-quant logit MSE
             against the bf16 model on a held-out [2, 64] batch, and the
             share of the rtn_only-to-quarot gap recovered; the Model's
             paged path (f32 pages) against its plain version and
             Model.forward in bf16 and f32; then the launcher: perq_star on
             the integer path (int4 pages, 16 layers), --no-quant (16
             layers), the fake-quant default (4 layers), each decode
             graphed, and --legacy-scheduler (2 layers)
    train    the training path at llama3-1b's full width and depth: seeded
             bf16 params, 8 AdamW steps of [4, 512] Markov-Zipf batches
             (drawn beforehand; the draw timed alone and through the
             Prefetcher) in 2 micro-batches with remat; ms per step (CUDA
             events), tokens/s, model-FLOPs share of the bf16 peak, peak
             memory; the loss must fall, the same step without remat must
             give the same loss, and an async checkpoint of the trained
             params must restore bit for bit; with --profile one more step
             under torch.profiler (device-busy ms, idle share, kernels)
    families the MoE, SSM and hybrid families through the launcher, decode
             graphed: mamba2-1.3b and zamba2-1.2b at full size (--no-quant,
             then the default perq_star), deepseek-moe-16b at full width
             (4 layers rtn_only, 1 layer perq_star); per run tokens/s, ms
             per engine step, peak memory, register MiB per slot, PTQ
             seconds and the fake-quant logit MSE against bf16; graphed
             decode against eager bit for bit with the attention launches
             of a pure decode step; on an f32 twin the kernels' whole-model
             logits against the plain versions from one state (zamba2,
             deepseek-moe), mamba2's chunked prefill against one token at a
             time, and zamba2's preemption and replay over register slots
             against a reserve run
    paper    the paper's tables on the surrogate trained on the card
             (`repro_torch.paper`): bf16 perplexity, Tables 1 (Qronos) and
             5 (RTN) at b = 8..256 with full-vector, Table 6, Table 2,
             Tables 3/4, MassDiff's speed at Llama3-8B's geometry, the
             Figure 3-5 summaries, the paper's orderings with `holds`
             flags and the share of the No-Permute-to-full-vector gap PeRQ
             closes at b = 16; then `examples/serve_quantized` on the card,
             whose attention must run on the kernel alone
    launch_train  the training entry point: `repro_torch.launch.train` at
             qwen1.5-0.5b's full size ([4, 512], 2 micro-batches, remat,
             checkpoints every 4 steps), 4 steps and then 2 resumed from its
             own step-4 checkpoint (ms per step, tokens/s, peak memory,
             seconds of each save and the restore, the host's batch draw and
             the driver's wait for it); the fault-tolerant driver on the
             paper's surrogate under deterministic algorithms (two fault-free
             runs, a transient failure, a persistent one: the same params,
             the restored state equal to its checkpoint); at qwen's size
             train steps plain, plain while a Prefetcher draws, and with
             int8 error-feedback compression, in turns, the compression's
             error bounds, and `compressed_psum` on a one-rank NCCL group
    dryrun   the dry run (`repro_torch.launch.dryrun`: meta tensors over a
             fake world of 256 or 512 ranks) of llama3-1b and qwen1.5-0.5b
             over every shape on both production meshes and their integer
             decode, in processes that see no card, every cell ok; the
             card's achieved bf16 GEMM and copy rates beside the roofline's
             datasheet figures; the train phase's step counted on one rank
             against the real step (FLOPs op by op against FlopCounterMode,
             argument + temp bytes within 20 % of the peak allocation, the
             step no faster than its roofline) and the integer decode step
             (batch 4, 128 cached positions) no faster than its roofline
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
1979 TOP/s int8, 989 TFLOP/s bf16 (the train step's model-FLOPs share),
495 TFLOP/s TF32 on the tensor cores (attention's products), 67 TFLOP/s
float32 outside the tensor cores.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
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
PEAK_BF16_FLOPS_S = 989e12
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
    if fmt in ("bf16", "f32"):
        dt = torch.bfloat16 if fmt == "bf16" else torch.float32
        return {"k": torch.from_numpy(rng.standard_normal(shp).astype(np.float32)).to(DEV).to(dt),
                "v": torch.from_numpy(rng.standard_normal(shp).astype(np.float32)).to(DEV).to(dt)}
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
                    live_pool=False, h=32, kh=8, dh=64, t=16,
                    q_dtype=torch.bfloat16):
    """The attention kernel against its plain version on one seeded case,
    by default of the served llama3-1b's widths (`h` query and `kh` KV
    heads of `dh`, pages of `t` rows, bf16 queries), then timed over 16 layers' pools. A
    split call (the default splits at decode, or `kv_splits`) must launch
    once and merge in that launch, and give one bit pattern over
    `MERGE_LAUNCHES` launches. The pool holds a page per table column of
    every row, or with `live_pool` only the live pages."""
    n_layers = 16
    used = [-(-ln // t) for ln in lens]
    n_pages = 1 + (sum(used) if live_pool else b * n_cols)
    pool = make_pool(rng, n_layers, n_pages, t, kh, dh, fmt)
    bits = {"bf16": None, "f32": None, "int8": 8, "int4": 4}[fmt]
    q = torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(np.float32)).to(DEV)
    q = q.to(q_dtype)
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
    if not bits:
        # yardstick: SDPA on a slab gathered beforehand (the gather is not
        # timed), in the pages' dtype
        kk = pool["k"][0][bt.long()].reshape(b, n_cols * t, kh, dh)
        vv = pool["v"][0][bt.long()].reshape(b, n_cols * t, kh, dh)
        kk = kk.repeat_interleave(h // kh, dim=2).transpose(1, 2)
        vv = vv.repeat_interleave(h // kh, dim=2).transpose(1, 2)
        qq = q.to(kk.dtype).transpose(1, 2)
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
    nbytes = (sum(lens) * per_row + q.numel() * q.element_size()
              + out.numel() * 4 + bt.numel() * 4)
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
    qdt = {torch.bfloat16: "bf16", torch.float32: "f32"}[q_dtype]
    return {"shape": f"{label}: q[{b},{s},{h},{dh}] {qdt}, {fmt} pages T={t}, "
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
    # f32 pages, no in-walk rotation: the bf16 / fake-quant Model's path
    for fmt in ("int4", "int8", "bf16", "f32"):
        cases["paged_attention"].append(check_attention(
            rng, "decode", fmt, 4, 1, [120, 0, 37, 113], 8, theta))
    for fmt in ("int4", "int8", "bf16", "f32"):
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
    # the served example's shapes (`examples/serve_quantized`: the reduced
    # qwen1.5-0.5b's heads, f32 pages of 8 rows, 4 slots, prefill chunks of
    # 8; the fake-quant model computes in f32): a decode step over two-page
    # tables and a chunk at position 0 and 8
    from repro_torch.configs.registry import get_config
    from repro_torch.examples import serve_quantized as SQ
    ex = get_config(SQ.ARCH).reduced()
    ex = dict(h=ex.n_heads, kh=ex.n_kv_heads, dh=ex.head_dim, t=SQ.PAGE_SIZE)
    c = SQ.PREFILL_CHUNK
    for label, b, s, lens, n_cols in (
            ("example decode", SQ.MAX_SEQS, 1, [15, 0, 9, 12], 2),
            ("example prefill", 1, c, [c], 1),
            ("example prefill", 1, c, [2 * c], 2)):
        cases["paged_attention"].append(check_attention(
            rng, label, "f32", b, s, lens, n_cols, theta, q_dtype=torch.float32,
            **ex))
    # the MoE and hybrid families' widths over f32 pages (the fake-quant
    # Model's path, one query head per KV head): deepseek-moe-16b's 16 heads
    # of 128 and zamba2-1.2b's shared block's 32 heads of 64, with f32
    # queries (phase families' f32 twin) and bf16 ones (the served models)
    for h, dh in ((16, 128), (32, 64)):
        for qdt in (torch.float32, torch.bfloat16):
            for label, b, s, lens in (("families decode", 4, 1, [120, 0, 37, 113]),
                                      ("families prefill", 1, 32, [128])):
                cases["paged_attention"].append(check_attention(
                    rng, label, "f32", b, s, lens, 8, theta, h=h, kh=h, dh=dh,
                    q_dtype=qdt))
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

# the engine's shape of every launcher run; SERVE_ARGS packs `rtn_only`
# through the PTQ pipeline (folded norms, MSE-searched scales) for the
# integer path, as the reference's launcher does
ENGINE_ARGS = ["--arch", "llama3-1b", "--block-size", "16", "--slots", "4",
               "--page-size", "16", "--prefill-chunk", "32", "--max-len", "512",
               "--device", "cuda"]
SERVE_ARGS = ENGINE_ARGS + ["--integer-path", "--preset", "rtn_only"]
# the kernels every serve run launches; block_hadamard runs only in the
# rotation-quality probe (--probe-every)
MAIN_PATH_KERNELS = ("hadamard_quant", "int4_matmul", "paged_attention",
                     "combine_partials")
PROBE_EVERY = 4


def run_launcher(label, extra, expect=MAIN_PATH_KERNELS, drained=False,
                 base=SERVE_ARGS):
    """One launcher run (`base + extra`) with every count set to 0 just
    before and read just after; every kernel in `expect` must have
    launched, and decode must have been graphed. Every request ends
    `length` - or, with `drained` (`--drain-after`), `cancelled` with no
    token when the drain found it never admitted. Returns (the launcher's
    result, record)."""
    from repro_torch.launch import serve as serve_cli
    buf = io.StringIO()
    kops.reset_kernel_launch_counts()
    kops.reset_dispatch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = serve_cli.main(base + extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kops.kernel_launch_counts()
    plain = {f"{e}": n for (e, path), n in kops.dispatch_counts().items()
             if path == "ref"}
    lines = [ln for ln in buf.getvalue().splitlines()
             if "served" in ln or ln.startswith(("quantized", "summary:",
                                                 "quality:"))]
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
        "launcher_lines": lines, "graphs": engine.graph_stats()["graphs"],
        "peak_device_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    problems = []
    if len(done) != int(extra[extra.index("--requests") + 1]):
        problems.append("not every request came back")
    allowed = ["cancelled", "length"] if drained else ["length"]
    if not set(rec["outcomes"]) <= set(allowed) or any(
            r.outcome == "cancelled" and (r.generated or r.t_admit)
            for r in done):
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
    if rec["graphs"] < 1:
        problems.append("no decode step was captured in a graph")
    for r in done:
        if r.outcome == "cancelled":
            continue
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
        adapter, plain_tokens


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
# phase: robust
# ---------------------------------------------------------------------------

# Replays re-prefill `prompt + generated` in chunks and a prefix hit starts
# prefill mid-stream, where the undisturbed run decoded position by position
# or chunked from 0: other summation orders. A request whose tokens differ
# from the baseline's is held at its first differing position, where both
# runs saw the same tokens: the logits there agree within REPLAY_FRAC of
# max|logit| and the baseline's top-2 gap is within twice that (a near tie
# decided the other way). Later positions follow other tokens and are not
# compared.
REPLAY_FRAC = 5e-3
ROBUST_NEW = 16
ROBUST_HOST_MB = 256


def robust_prompts(vocab, shared=0):
    """The launcher's prompts for `--requests 8 --prompt-len 40-160 --seed 0
    [--shared-prefix N]`: the serve phase's full run serves the same."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, size=shared).tolist()
    return [system + rng.integers(0, vocab, size=int(rng.integers(40, 161))
                                  ).tolist() for _ in range(8)]


class SwapLog:
    """Wraps an engine's swap-out and swap-in: pages and bytes each way,
    host ms of each call, and the device time of its copy from the CUDA
    events the page cache records around it (`kv.last_transfer`)."""

    def __init__(self, kv):
        self.calls = {"out": [], "in": []}
        for way, name in (("out", "swap_out"), ("in", "swap_in")):
            setattr(kv, name, self._wrap(kv, way, getattr(kv, name)))

    def _wrap(self, kv, way, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            n, nbytes = fn(*a, **k)
            host = time.perf_counter() - t0
            if n:
                self.calls[way].append((n, nbytes, host, kv.last_transfer))
            return n, nbytes
        return timed

    def summary(self) -> dict:
        """Per direction: the totals, host ms per page of the first call
        (which carries the process's first use of the copy path) and of
        the later ones, and each call's pages, host ms, copy device ms (the
        events bracket the copies as Python issues them, so they bound the
        copy's device time from above) and GB/s."""
        torch.cuda.synchronize()
        out = {}
        for way, calls in self.calls.items():
            rows = [{"pages": n, "host_ms": 1e3 * host,
                     "copy_device_ms": ev[0].elapsed_time(ev[1])
                     if ev is not None else None}
                    for n, _, host, ev in calls]
            for row, (_, nbytes, _, _) in zip(rows, calls):
                ms = row["copy_device_ms"]
                row["copy_gb_s"] = nbytes / ms / 1e6 if ms else None
            pages = sum(c[0] for c in calls)
            later = rows[1:]
            out[way] = {
                "calls": len(calls), "pages": pages,
                "bytes": sum(c[1] for c in calls),
                "host_ms_per_page_first_call": (
                    rows[0]["host_ms"] / rows[0]["pages"] if rows else None),
                "host_ms_per_page_later_calls": (
                    sum(r["host_ms"] for r in later)
                    / sum(r["pages"] for r in later) if later else None),
                "per_call": rows}
        return out


def first_divergence(got, want):
    """None when the tokens are equal; else the first differing position
    with the logits of both runs there, held to REPLAY_FRAC."""
    if got.generated == want.generated:
        return None
    i = next(j for j, (a, b) in enumerate(zip(got.generated, want.generated))
             if a != b)
    g, w = got.step_logits[i], want.step_logits[i]
    bound = REPLAY_FRAC * float(np.abs(w).max())
    top2 = np.sort(w)[-2:]
    err = float(np.abs(g - w).max())
    gap = float(top2[1] - top2[0])
    return {"rid": got.rid, "position": i, "max_abs_diff": err,
            "bound": bound, "baseline_top2_gap": gap,
            "ok": err <= bound and gap <= 2 * bound}


def robust_run(label, adapter, prompts, *, base=None, drain_at=None,
               expect=None, **engine_kw):
    """Serve `prompts` (16 new tokens each) through a fresh engine with the
    counts set to 0 just before and read just after; books checked after
    every step; optionally drain after `drain_at` steps. Gates: each
    request's outcome (`expect`: rid -> outcome, else "length"), both tiers
    empty at the end, the main path's kernels launched and no plain
    version, decode graphed, and tokens against `base` (rid -> request) as
    `first_divergence` says. Returns (requests by rid, record)."""
    from repro_torch.serve.engine import (EngineRequest, SamplingParams,
                                          ServeEngine)
    engine = ServeEngine(adapter, page_size=16, max_seqs=4, prefill_chunk=32,
                         record_logits=True, **engine_kw)
    swaps = SwapLog(engine.kv)
    for rid, p in enumerate(prompts):
        engine.submit(EngineRequest(
            rid=rid, prompt=p, sampling=SamplingParams(max_new=ROBUST_NEW)))
    kops.reset_kernel_launch_counts()
    kops.reset_dispatch_counts()
    problems, done = [], []
    t0 = time.perf_counter()
    while (engine.queue or engine.active) and (
            drain_at is None or engine.n_steps < drain_at):
        done.extend(engine.step())
        engine.check_books()
    if drain_at is not None:
        done.extend(engine.drain())      # asserts books and empty tiers
    elif engine.prefix_cache is not None:
        engine.prefix_cache.clear()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, dispatch = kops.count_snapshot()
    engine.check_books()
    done = {r.rid: r for r in done}
    alloc, host = engine.kv.allocator, engine.kv.host_pool
    if sorted(done) != list(range(len(prompts))):
        problems.append("not every request came back")
    outcomes = {rid: r.outcome for rid, r in done.items()}
    want = {rid: (expect or {}).get(rid, "length") for rid in done}
    if outcomes != want:
        problems.append(f"outcomes {outcomes}, expected {want}")
    if alloc.in_use or engine.kv.tables or (host and host.in_use):
        problems.append("pages or host slots left in use")
    for name in MAIN_PATH_KERNELS:
        if launches[name] <= 0:
            problems.append(f"kernel {name} was never launched")
    plain = {e: n for (e, path), n in dispatch.items() if path == "ref"}
    if plain:
        problems.append(f"plain versions ran: {plain}")
    stats = engine.graph_stats()
    if not stats["graphs"]:
        problems.append("decode was not graphed")
    divergences = []
    if base is not None:
        for rid, r in done.items():
            if r.outcome == "length" and base[rid].outcome == "length":
                d = first_divergence(r, base[rid])
                if d is not None:
                    divergences.append(d)
        if not all(d["ok"] for d in divergences):
            problems.append(f"tokens differ beyond a near tie: {divergences}")
    c = engine.metrics.counter
    rec = {
        "label": label, "n_pages": alloc.n_pages,
        "admission": engine.admission, "outcomes": outcomes,
        "engine_steps": engine.n_steps, "wall_s": wall,
        "preemptions": c("engine.preemptions").value,
        "replayed_prefill_tokens": c("engine.replayed_prefill_tokens").value,
        "prefill_tokens": engine.n_prefill_tokens,
        "prefix_hits": c("engine.prefix.hits").value,
        "prefix_hit_tokens": c("engine.prefix.hit_tokens").value,
        "cow_copies": c("engine.prefix.cow_copies").value,
        "dispatch_faults": c("engine.dispatch.faults").value,
        "swap": swaps.summary(),
        "swap_counts": {k: c(f"engine.swap.{k}").value
                        for k in ("out", "in", "retries", "fallbacks")},
        "page_bytes": engine.kv.page_bytes,
        "graphs_captured": stats["graphs"],
        "kernel_launches": {k: launches[k] for k in MAIN_PATH_KERNELS},
        "plain_dispatches": plain,
        "tokens_equal_to_baseline": (None if base is None else sum(
            done[r].generated == base[r].generated for r in done
            if done[r].outcome == "length")),
        "divergences": divergences,
    }
    rec["problems"] = problems
    return done, rec


def phase_robust(adapter, serve_tokens):
    """The engine's robustness at full width and depth, decode graphed (see
    the module docstring), and the serve phase's full run - optimistic
    admission, the launcher's default - against a reserve run of the same
    requests: the same tokens."""
    from repro_torch.serve.engine import FaultPlan, pages_for
    vocab = adapter.cfg.vocab
    prompts = robust_prompts(vocab)
    worst = max(pages_for(len(p) + ROBUST_NEW, 16) for p in prompts)
    runs = []
    base, rec = robust_run("reserve, worst-case pool", adapter, prompts,
                           n_pages=4 * worst + 1, admission="reserve")
    if [base[r].generated for r in sorted(base)] != serve_tokens:
        rec["problems"].append("the serve phase's optimistic run gave other "
                               "tokens than this reserve run")
    runs.append(rec)
    # 60 % of the worst case, no headroom watermark: four prompts fit, and
    # their decode growth exhausts the pool
    tight = dict(n_pages=int(0.6 * 4 * worst) + 1, headroom_pages=0,
                 max_preemptions=10)
    _, rec = robust_run("optimistic, 60 % pool", adapter, prompts, base=base,
                        **tight)
    if not (rec["preemptions"] > 0 and rec["replayed_prefill_tokens"] > 0):
        rec["problems"].append("no preemption and replay")
    runs.append(rec)
    _, rec = robust_run("optimistic, 60 % pool, host swap tier (always)",
                        adapter, prompts, base=base, swap_host_mb=ROBUST_HOST_MB,
                        swap_policy="always", **tight)
    if not (rec["swap_counts"]["out"] > 0 and rec["swap_counts"]["in"] > 0):
        rec["problems"].append("no swap-out and swap-in")
    runs.append(rec)
    shared = robust_prompts(vocab, shared=64)
    worst_s = max(pages_for(len(p) + ROBUST_NEW, 16) for p in shared)
    cold, rec = robust_run("shared 64-token prefix, no cache", adapter, shared,
                           n_pages=4 * worst_s + 1)
    runs.append(rec)
    _, rec = robust_run("shared 64-token prefix, prefix cache", adapter,
                        shared, base=cold, n_pages=4 * worst_s + 1,
                        prefix_cache=True)
    if not (rec["prefix_hits"] > 0
            and rec["prefill_tokens"] < runs[-1]["prefill_tokens"]):
        rec["problems"].append("no prefix hit, or no prefill token saved")
    runs.append(rec)
    plan = FaultPlan(seed=5, exhaust_steps=(6, 14, 30),
                     dispatch_fail_steps=(4, 18), dispatch_delay_steps=(9,),
                     dispatch_delay_s=0.002, cancel_at={3: (1,)},
                     expire_at={2: (6,)})
    # rid 1 cancelled mid-flight, rid 6 expired in the queue, rid 7 never
    # admitted before the drain at step 24 (so cancelled by it)
    _, rec = robust_run("fault plan, drain after 24 steps", adapter, prompts,
                        base=base, n_pages=4 * worst + 1, faults=plan,
                        max_preemptions=10, drain_at=24,
                        expect={1: "cancelled", 6: "expired", 7: "cancelled"})
    if not (rec["preemptions"] > 0 and rec["dispatch_faults"] == 3):
        rec["problems"].append("the plan's exhaustions or dispatch faults "
                               "did not fire")
    runs.append(rec)
    result, rec = run_launcher(
        "launcher: --prefix-cache --shared-prefix 32 --swap-host-mb 64 "
        "--drain-after 20, 2 layers",
        ["--layers", "2", "--kv-bits", "4", "--requests", "8", "--max-new",
         "8", "--prompt-len", "60-100", "--prefix-cache", "--shared-prefix",
         "32", "--swap-host-mb", "64", "--drain-after", "20"], drained=True)
    snap = result["snapshot"]
    rec["prefix_hits"] = snap["counters"]["engine.prefix.hits"]
    rec["host_pages_capacity"] = snap["gauges"]["engine.swap.host_pages_capacity"]
    if not (rec["prefix_hits"] > 0 and rec["host_pages_capacity"] > 0
            and result["engine"].kv.host_pool.in_use == 0):
        rec["problems"].append("no prefix hit, or the host tier missing or "
                               "not empty")
    runs.append(rec)
    for r in runs:
        r["ok"] = not r["problems"]
    ok = all(r["ok"] for r in runs)
    emit("robust", ok=ok, runs=runs,
         tolerance=f"tokens equal, or at the first differing position logits "
                   f"within {REPLAY_FRAC} of max|logit| and the baseline's "
                   "top-2 gap within twice that")
    if not ok:
        fail(f"robust phase: {[(r['label'], r['problems']) for r in runs]}")


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
# phase: ptq
# ---------------------------------------------------------------------------

# (label, preset or None for a bare PTQConfig, overrides, calibration
# batches of [4, 128]); b = 16 for all. One batch is the launcher's
# calibration; 8 batches (4096 tokens, still fewer than w_down's 8192
# inputs) show how the error-diffusing presets move with more of it.
PTQ_RUNS = (
    ("rtn_only", "rtn_only", {}, 1),
    ("perq_star", "perq_star", {}, 1),
    ("perq_star, identity P3", "perq_star", {"permutation": "identity"}, 1),
    ("quarot (full-vector R3)", "quarot", {}, 1),
    ("gate: quarot R1/R2 + block R3 + RTN, massdiff P3", None,
     {"permutation": "massdiff", "rotation": "quarot", "rounding": "rtn"}, 1),
    ("gate: quarot R1/R2 + block R3 + RTN, identity P3", None,
     {"permutation": "identity", "rotation": "quarot", "rounding": "rtn"}, 1),
    ("perq_star, 8 batches", "perq_star", {}, 8),
    ("perq_star, identity P3, 8 batches", "perq_star",
     {"permutation": "identity"}, 8),
    ("quarot (full-vector R3), 8 batches", "quarot", {}, 8),
)
# The Model's paged forward_chunk on f32 pages, kernel against plain (each
# step from the same pool) and against Model.forward over the whole
# sequence. In f32 the 16 layers carry the attention's roundoff (the kernel
# sums in another order) to ~1e-4 of max|logit| (measured, H100): bound
# 5e-4. In bf16 every activation is rounded to 8 bits and the random,
# outlier-injected model amplifies one rounding step layer by layer: the
# plain version itself lies ~0.17 of max|logit| from Model.forward at 16
# layers (measured, H100), so the served bf16 model is held to being no
# further from Model.forward than 1.5x the plain version is.
MODEL_F32_FRAC = 5e-4
MODEL_BF16_RATIO = 1.5


def check_model_paged(model, params, vocab):
    """A 32-token and a 15-token prefill chunk, then one per-slot decode
    step, 2 sequences over 16-row f32 pages: the kernels' logits against
    the plain versions' from the same pool at every step, and against
    Model.forward; the plain versions' against Model.forward too."""
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, vocab, (2, 48))).to(DEV)
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32,
                      device=DEV)
    pool = model.init_paged_state(9, 16, 0, dtype=torch.float32,
                                  device=DEV)["kv"]
    plain_pool = {k: v.clone() for k, v in pool.items()}
    steps = ((0, 32, 0), (32, 47, 32),
             (47, 48, torch.tensor([47, 47], dtype=torch.int32, device=DEV)))
    kops.reset_kernel_launch_counts()
    got, plain_run, errs = [], [], []
    for start, stop, index in steps:
        chunk = toks[:, start:stop]
        lens = torch.full((2,), stop, dtype=torch.int32, device=DEV)
        twin = {k: v.clone() for k, v in pool.items()}
        with kops.use_kernels(False):
            plain, _ = model.forward_chunk(params, chunk, twin, index, bt, lens)
            alone, _ = model.forward_chunk(params, chunk, plain_pool, index,
                                           bt, lens)
        logits, _ = model.forward_chunk(params, chunk, pool, index, bt, lens)
        logits, plain = logits.float(), plain.float()
        errs.append(float((logits - plain).abs().max() / plain.abs().max()))
        got.append(logits)
        plain_run.append(alone.float())
    launches = kops.kernel_launch_counts()["paged_attention"]
    want = model.forward(params, {"tokens": toks}).float()
    got, plain_run = torch.cat(got, dim=1), torch.cat(plain_run, dim=1)
    top = want.abs().max()
    return {"dtype": str(model.pdt).split(".")[-1],
            "steps": ["prefill 0-32", "prefill 32-47", "decode 47"],
            "kernel_vs_plain_same_pool_of_max_logit": errs,
            "kernel_vs_forward_of_max_logit": float((got - want).abs().max() / top),
            "plain_vs_forward_of_max_logit": float(
                (plain_run - want).abs().max() / top),
            "argmax_agree_kernel_vs_forward": float(
                (got.argmax(-1) == want.argmax(-1)).float().mean()),
            "attention_launches": launches,
            "launches_ok": launches == 3 * model.cfg.n_layers,
            "finite": bool(torch.isfinite(got).all())}


def run_legacy(extra):
    """The launcher's --legacy-scheduler run: every request gets its tokens
    (no kernel: the dense slot cache is plain PyTorch)."""
    from repro_torch.launch import serve as serve_cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = serve_cli.main(ENGINE_ARGS + extra)
    torch.cuda.synchronize()
    done = result["done"]
    vocab = result["scheduler"].model.cfg.vocab
    n = int(extra[extra.index("--requests") + 1])
    new = int(extra[extra.index("--max-new") + 1])
    ok = len(done) == n and all(
        len(r.generated) == new and all(0 <= t < vocab for t in r.generated)
        for r in done)
    return {"label": "bf16, --legacy-scheduler, 2 layers", "args": extra,
            "requests": len(done), "wall_s_with_setup":
            time.perf_counter() - t0, "ok": ok,
            "launcher_lines": [ln for ln in buf.getvalue().splitlines()
                               if "served" in ln]}


def phase_ptq():
    """The paper's PTQ pipeline on the card at llama3-1b's published widths
    and depth, then the launcher's three serving paths over its results."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import pipeline as PL
    from repro_torch.core.synthetic import inject_outlier_channels
    from repro_torch.models.transformer import build_model
    from repro_torch.tree import tree_map
    cfg = get_config("llama3-1b")
    model = build_model(cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    params = inject_outlier_channels(model.init(gen))
    # the launcher's calibration batch for --seed 0 first, and a held-out
    # batch
    crng = np.random.default_rng(1)
    calib = [{"tokens": torch.from_numpy(
        crng.integers(0, cfg.vocab, (4, 128))).to(DEV)} for _ in range(8)]
    held = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 64))).to(DEV)}
    want = model.forward(params, held).float()
    runs, problems = [], []
    for label, name, over, n_batches in PTQ_RUNS:
        ptq = PL.preset(name, block_size=16, **over) if name \
            else PL.PTQConfig(block_size=16, **over)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = PL.quantize_model(model, params, calib[:n_batches], ptq)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = PL.build_quantized_model(model, res).forward(res.params,
                                                           held).float()
        rec = {"label": label, "preset": name, "calibration_tokens":
               512 * n_batches,
               "config": {k: getattr(ptq, k) for k in (
                   "permutation", "rotation", "rounding", "block_size",
                   "full_vector_r3")},
               "seconds": secs, "peak_device_memory_gib": peak,
               "logit_mse": float(((got - want) ** 2).mean()),
               "finite": bool(torch.isfinite(got).all()),
               "per_layer": res.report["per_layer"]}
        if not rec["finite"]:
            problems.append(f"{label}: a logit is not finite")
        if ptq.permutation == "massdiff" and not ptq.full_vector_r3:
            worse = [i for i, e in enumerate(res.report["per_layer"])
                     if e["max_block_l1_after"]
                     > e["max_block_l1_before"] * (1 + 1e-6)]
            if worse:
                problems.append(f"{label}: MassDiff raised the max block "
                                f"l1 of layers {worse}")
        runs.append(rec)
        del res, got
    mse = {r["label"]: r["logit_mse"] for r in runs}
    recovered, gap = {}, {}
    for tag in ("", ", 8 batches"):
        gap[tag.lstrip(", ") or "1 batch"] = g = \
            mse["rtn_only"] - mse["quarot (full-vector R3)" + tag]
        for k in ("perq_star", "perq_star, identity P3"):
            recovered[k + tag] = (mse["rtn_only"] - mse[k + tag]) / g \
                if g else None
    gate = [mse[r[0]] for r in PTQ_RUNS[4:6]]
    if not gate[0] < gate[1]:
        problems.append(f"gate pair: MassDiff's MSE {gate[0]} is not below "
                        f"identity's {gate[1]}")
    paged = [check_model_paged(model, params, cfg.vocab)]
    b = paged[0]
    b["bound"] = (f"kernel_vs_forward <= {MODEL_BF16_RATIO} x "
                  "plain_vs_forward")
    b["ok"] = (b["launches_ok"] and b["finite"]
               and b["kernel_vs_forward_of_max_logit"]
               <= MODEL_BF16_RATIO * b["plain_vs_forward_of_max_logit"])
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    del params
    paged.append(check_model_paged(build_model(cfg32), params32, cfg.vocab))
    f = paged[1]
    f["bound"] = MODEL_F32_FRAC
    f["ok"] = (f["launches_ok"] and f["finite"]
               and max(f["kernel_vs_plain_same_pool_of_max_logit"])
               <= MODEL_F32_FRAC
               and f["kernel_vs_forward_of_max_logit"] <= MODEL_F32_FRAC)
    del params32
    torch.cuda.empty_cache()
    for rec in paged:
        if not rec["ok"]:
            problems.append(f"the {rec['dtype']} Model's paged path: {rec}")

    full = ["--requests", "8", "--max-new", "16", "--prompt-len", "40-160"]
    served = []
    for label, extra, expect in (
            ("perq_star, integer path, int4 KV pages, 16 layers",
             ["--preset", "perq_star", "--integer-path", "--kv-bits", "4"],
             MAIN_PATH_KERNELS),
            ("bf16 (--no-quant), f32 pages, 16 layers", ["--no-quant"],
             ("paged_attention",)),
            ("fake-quant perq_star (the default), f32 pages, 4 layers",
             ["--layers", "4"], ("paged_attention",))):
        torch.cuda.reset_peak_memory_stats()
        result, rec = run_launcher(label, extra + full, expect=expect,
                                  base=ENGINE_ARGS)
        del result
        served.append(rec)
    served.append(run_legacy(["--no-quant", "--legacy-scheduler", "--layers",
                              "2", "--requests", "8", "--max-new", "8",
                              "--prompt-len", "40-160"]))
    problems += [f"{r['label']}: {r.get('problems')}" for r in served
                 if not r["ok"]]
    emit("ptq", ok=not problems, model="llama3-1b, 16 layers, d_model 2048, "
         "d_ff 8192, vocab 128256, bf16, seeded, outliers injected",
         calibration="[4, 128] token batches", held_out="[2, 64] tokens",
         runs=runs, recovered_share=recovered,
         rtn_only_to_quarot_gap=gap, model_paged=paged,
         served=served, problems=problems)
    if problems:
        fail(f"ptq phase: {problems}")


# ---------------------------------------------------------------------------
# phase: families
# ---------------------------------------------------------------------------

FAMILY_ARGS = ["--slots", "4", "--page-size", "16", "--prefill-chunk", "32",
               "--max-len", "512", "--device", "cuda"]
FAMILY_SERVE = ["--requests", "8", "--max-new", "16", "--prompt-len",
                "48-158"]
# (label, arch, launcher args, the checks run on the run's adapter);
# deepseek-moe-16b at full width, its depth cut to 4 layers (rtn_only) and
# to 1 (perq_star: GPTQ/Qronos over 64 experts x 3 weights a layer)
FAMILY_RUNS = (
    ("mamba2-1.3b, bf16 (--no-quant)", "mamba2-1.3b", ["--no-quant"],
     ("graph", "chunked")),
    ("mamba2-1.3b, fake-quant perq_star (the default)", "mamba2-1.3b", [],
     ("graph",)),
    ("zamba2-1.2b, bf16 (--no-quant)", "zamba2-1.2b", ["--no-quant"],
     ("graph", "parity", "replay")),
    ("zamba2-1.2b, fake-quant perq_star (the default)", "zamba2-1.2b", [],
     ("graph",)),
    ("deepseek-moe-16b, 4 layers, fake-quant rtn_only", "deepseek-moe-16b",
     ["--layers", "4", "--preset", "rtn_only"], ("graph", "parity")),
    ("deepseek-moe-16b, 1 layer, fake-quant perq_star (the default)",
     "deepseek-moe-16b", ["--layers", "1"], ("graph",)),
)


class PTQProbe:
    """Wraps `core.pipeline.quantize_model` for one launcher run: its
    seconds and peak device memory, and the fake-quant model's logit MSE
    against the bf16 model on a held-out [2, 64] batch. The peak memory
    statistic restarts after it, so the launcher record's peak is the
    serving one."""

    def __init__(self):
        from repro_torch.core import pipeline as PL
        self.PL, self.real, self.rec = PL, PL.quantize_model, None

    def __enter__(self):
        def timed(model, params, calib, cfg):
            held = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
                0, model.cfg.vocab, (2, 64))).to(DEV)}
            want = model.forward(params, held).float()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = self.real(model, params, calib, cfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            got = self.PL.build_quantized_model(model, res).forward(
                res.params, held).float()
            self.rec = {"ptq_seconds": secs, "ptq_peak_device_memory_gib": peak,
                        "logit_mse_vs_bf16": float(((got - want) ** 2).mean()),
                        "logits_finite": bool(torch.isfinite(got).all()),
                        "held_out": "[2, 64] tokens"}
            del want, got
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return res
        self.PL.quantize_model = timed
        return self

    def __exit__(self, *exc):
        self.PL.quantize_model = self.real


def _family_prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def _family_serve(adapter, prompts, max_new=16, **engine_kw):
    """Serve `prompts` greedily on a fresh engine (4 slots, pages of 16,
    chunks of 32) with the books checked every step; returns (engine,
    requests by rid, the counts of the whole run, the counts of the first
    step with every sequence decoding)."""
    from repro_torch.serve.engine import (EngineRequest, SamplingParams,
                                          ServeEngine)
    kw = dict(n_pages=4 * 12 + 1, page_size=16, max_seqs=4,
              prefill_chunk=32, record_logits=True)
    kw.update(engine_kw)
    engine = ServeEngine(adapter, **kw)
    for rid, p in enumerate(prompts):
        engine.submit(EngineRequest(rid=rid, prompt=p,
                                    sampling=SamplingParams(max_new=max_new)))
    kops.reset_kernel_launch_counts()
    kops.reset_dispatch_counts()
    done, per_step = [], None
    while engine.queue or engine.active:
        pure = not engine.queue and not engine.prefilling and engine.decoding
        before = kops.count_snapshot()
        done.extend(engine.step())
        if pure and per_step is None:
            per_step = kops.counts_since(before)
        engine.check_books()
    torch.cuda.synchronize()
    return engine, {r.rid: r for r in done}, kops.count_snapshot(), per_step


def _slots_clean(engine) -> bool:
    regs = engine.kv.registers
    return regs is not None and regs.in_use == 0 and not engine.kv.slots \
        and all(float(leaf[:, 1:].abs().max()) == 0.0
                for leaf in engine.kv._reg_leaves)


def family_graph(adapter, attn_per_step):
    """The same 4 requests served with decode graphed and eagerly: tokens
    and every step's logits bit-equal, counts equal, `attn_per_step`
    attention launches in a pure decode step, no plain dispatch."""
    prompts = _family_prompts(adapter.cfg.vocab, (70, 90, 33, 60), 4)
    _, want, c_eager, _ = _family_serve(adapter, prompts, max_new=24,
                                        eager=True)
    engine, got, c_graph, per_step = _family_serve(adapter, prompts,
                                                   max_new=24)
    steps = [(g, w) for r in want
             for g, w in zip(got[r].step_logits, want[r].step_logits)]
    unequal = sum(not np.array_equal(g, w) for g, w in steps)
    plain = {e: n for (e, path), n in c_graph[1].items() if path == "ref"}
    step_attn = (per_step or ({}, {}))[0].get("paged_attention", 0)
    rec = {"tokens_equal": all(got[r].generated == want[r].generated
                               for r in want),
           "logits_rows": len(steps), "logits_rows_unequal": unequal,
           "counts_equal": c_graph == c_eager,
           "graphs": engine.graph_stats()["graphs"],
           "attention_launches_per_decode_step": step_attn,
           "attention_launches_expected": attn_per_step,
           "plain_dispatches": plain,
           "register_slots_clean": (_slots_clean(engine)
                                    if engine.spec.register else None)}
    rec["ok"] = (rec["tokens_equal"] and not unequal and rec["counts_equal"]
                 and rec["graphs"] >= 1 and per_step is not None
                 and step_attn == attn_per_step and not plain
                 and rec["register_slots_clean"] is not False)
    return rec


def _f32_twin(adapter):
    """The served model's plain f32 twin (no PTQ hooks) over f32 copies of
    its parameters, as an engine adapter with f32 pages and registers. MoE
    evaluates every expert (`moe_dense_oracle`): capacity drops depend on
    the chunk's length, so chunked and whole-sequence runs would route
    differently."""
    from repro_torch.models.transformer import build_model
    from repro_torch.serve.engine import as_servable
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(adapter.cfg, param_dtype="float32",
                              compute_dtype="float32")
    return as_servable(build_model(cfg, moe_dense_oracle=cfg.uses_moe),
                       tree_map(lambda t: t.float(), adapter.params))


def family_parity(adapter):
    """Whole-model logits with the attention kernel against
    `use_kernels(False)` from one state, on the f32 twin: a 32-token and a
    15-token prefill chunk of 2 sequences, then one per-slot decode step,
    each from a copy of the same state; and the kernels' run against
    `Model.forward` over the whole sequence. Bound: MODEL_F32_FRAC of
    max|logit| (phase ptq's, for the dense Model's f32 pages)."""
    from repro_torch.tree import tree_map
    twin = _f32_twin(adapter)
    model, params = twin.model, twin.params
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab, (2, 48))).to(DEV)
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32,
                      device=DEV)
    reg = torch.tensor([1, 2], dtype=torch.int32, device=DEV) \
        if twin.spec.register else None
    state = twin.init_state(9, 16, 3)
    kops.reset_kernel_launch_counts()
    errs, got = [], []
    for start, stop, index in ((0, 32, 0), (32, 47, 32),
                               (47, 48, torch.tensor([47, 47], dtype=torch.int32,
                                                     device=DEV))):
        chunk = toks[:, start:stop]
        lens = torch.full((2,), stop, dtype=torch.int32, device=DEV)
        copy = tree_map(torch.clone, state)
        with kops.use_kernels(False):
            plain, _ = twin.forward_chunk(params, chunk, copy, index, bt, lens,
                                          reg)
        logits, _ = twin.forward_chunk(params, chunk, state, index, bt, lens,
                                       reg)
        errs.append(float((logits - plain).abs().max() / plain.abs().max()))
        got.append(logits)
    launches = kops.kernel_launch_counts()["paged_attention"]
    want = model.forward(params, {"tokens": toks})
    got = torch.cat(got, dim=1)
    n_attn = model.cfg.n_layers if model.cfg.family == "moe" \
        else model._hybrid_groups()[0]
    rec = {"steps": ["prefill 0-32", "prefill 32-47", "decode 47"],
           "kernel_vs_plain_same_state_of_max_logit": errs,
           "kernel_vs_forward_of_max_logit": float(
               (got - want).abs().max() / want.abs().max()),
           "argmax_agree_kernel_vs_forward": float(
               (got.argmax(-1) == want.argmax(-1)).float().mean()),
           "attention_launches": launches, "bound": MODEL_F32_FRAC,
           "finite": bool(torch.isfinite(got).all())}
    rec["ok"] = (rec["finite"] and launches == 3 * n_attn
                 and max(errs) <= MODEL_F32_FRAC
                 and rec["kernel_vs_forward_of_max_logit"] <= MODEL_F32_FRAC)
    del twin, params, state
    torch.cuda.empty_cache()
    return rec


def family_chunked(adapter):
    """mamba2: chunked prefill (32 tokens a chunk, the SSD scan) against
    prefill one token at a time (the recurrent step) on the f32 twin, 2
    requests: the same tokens, or a first difference at a near tie
    (`first_divergence`)."""
    twin = _f32_twin(adapter)
    prompts = _family_prompts(adapter.cfg.vocab, (75, 50), 5)
    _, chunked, _, _ = _family_serve(twin, prompts, max_new=8)
    _, stepwise, _, _ = _family_serve(twin, prompts, max_new=8,
                                      prefill_chunk=1)
    divs = [d for d in (first_divergence(chunked[r], stepwise[r])
                        for r in chunked) if d is not None]
    first_err = max(float(np.abs(chunked[r].step_logits[0]
                                 - stepwise[r].step_logits[0]).max()
                          / np.abs(stepwise[r].step_logits[0]).max())
                    for r in chunked)
    del twin
    torch.cuda.empty_cache()
    return {"tokens_equal": sum(chunked[r].generated == stepwise[r].generated
                                for r in chunked), "requests": len(chunked),
            "first_token_logits_diff_of_max": first_err,
            "divergences": divs, "ok": all(d["ok"] for d in divs)}


# 24 pages: the first three prompts fill them, so the first page growth
# preempts (the four need 34 at worst, 70 % more)
REPLAY_PAGES = 4 * 6 + 1


def family_replay(adapter):
    """zamba2: optimistic admission on a short pool preempts; the victims'
    register slots are scrubbed with their pages and the replays
    re-prefill over fresh slots. On the f32 twin (the replay's chunked SSD
    against the undisturbed run's recurrent steps: in bf16 the conv taps
    round differently and 38 random layers amplify it past any near tie),
    tokens against a reserve run, as phase robust holds them
    (`first_divergence`)."""
    twin = _f32_twin(adapter)
    prompts = _family_prompts(adapter.cfg.vocab, (120, 100, 140, 90), 6)
    _, base, _, _ = _family_serve(twin, prompts, admission="reserve")
    short, got, _, _ = _family_serve(twin, prompts, n_pages=REPLAY_PAGES,
                                     admission="optimistic", headroom_pages=0)
    divs = [d for d in (first_divergence(got[r], base[r]) for r in got)
            if d is not None]
    pre = short.metrics.counter("engine.preemptions").value
    rec = {"n_pages": REPLAY_PAGES, "preemptions": pre,
           "replayed_prefill_tokens": short.metrics.counter(
               "engine.replayed_prefill_tokens").value,
           "slots_scrubbed": short.kv.slots_scrubbed,
           "tokens_equal_to_reserve": sum(got[r].generated == base[r].generated
                                          for r in got),
           "divergences": divs,
           "register_slots_clean": _slots_clean(short)}
    rec["ok"] = (pre >= 1 and all(r.outcome == "length" for r in got.values())
                 and all(d["ok"] for d in divs) and rec["register_slots_clean"]
                 and short.kv.slots_scrubbed >= len(prompts) + pre)
    del twin, short
    torch.cuda.empty_cache()
    return rec


def phase_families():
    """The MoE, SSM and hybrid families through the launcher on the card:
    mamba2-1.3b and zamba2-1.2b at full size, deepseek-moe-16b at full
    width (4 and 1 layers), each `--no-quant` or through
    `quantize_model`, decode graphed; then on each run's adapter the
    checks `FAMILY_RUNS` names."""
    from repro_torch.tree import leaves as tree_leaves
    runs, problems = [], []
    for label, arch, extra, checks in FAMILY_RUNS:
        expect = () if arch.startswith("mamba2") else ("paged_attention",)
        torch.cuda.reset_peak_memory_stats()
        probe = PTQProbe()
        with probe:
            result, rec = run_launcher(label, extra + FAMILY_SERVE,
                                       expect=expect,
                                       base=["--arch", arch] + FAMILY_ARGS)
        engine = result["engine"]
        adapter, cfg = engine.adapter, engine.adapter.cfg
        rec.update(probe.rec or {})
        rec["model"] = (f"{cfg.name}: {cfg.n_layers} layers, d_model "
                        f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.param_dtype}")
        rec["params_billion"] = sum(
            t.numel() for t in tree_leaves(adapter.params)) / 1e9
        rec["register_mib_per_slot"] = engine.kv.slot_bytes / 2 ** 20
        rec["register_slots_clean"] = (_slots_clean(engine)
                                       if engine.spec.register else None)
        if rec["register_slots_clean"] is False:
            rec["problems"].append("register slots left in use or unscrubbed")
        if probe.rec is not None and not probe.rec["logits_finite"]:
            rec["problems"].append("fake-quant logits not finite")
        del result, engine
        attn = {"ssm": 0, "hybrid": adapter.model._hybrid_groups()[0]}.get(
            cfg.family, cfg.n_layers)
        for check in checks:
            t0 = time.perf_counter()
            out = {"graph": lambda: family_graph(adapter, attn),
                   "parity": lambda: family_parity(adapter),
                   "chunked": lambda: family_chunked(adapter),
                   "replay": lambda: family_replay(adapter)}[check]()
            out["seconds"] = time.perf_counter() - t0
            rec[check] = out
            if not out["ok"]:
                rec["problems"].append(f"{check}: {out}")
        rec["ok"] = not rec["problems"]
        del adapter
        torch.cuda.empty_cache()
        runs.append(rec)
        problems += [f"{label}: {p}" for p in rec["problems"]]
    emit("families", ok=not problems, runs=runs, problems=problems,
         tolerance=f"graphed decode bit-equal to eager; kernel vs plain and vs "
                   f"Model.forward {MODEL_F32_FRAC} of max|logit| on the f32 "
                   "twin; replay and chunked tokens as phase robust "
                   f"({REPLAY_FRAC} of max|logit| at a first difference, a "
                   "near tie)")
    if problems:
        fail(f"families phase: {problems}")


# ---------------------------------------------------------------------------
# phase: train
# ---------------------------------------------------------------------------

TRAIN_STEPS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 4, 512, 2
# the remat=False step against the remat=True step from the same params and
# batch. The forward is the same arithmetic either way, so the loss can only
# differ by a fault; remat's risk is in the backward, which recomputes each
# layer through torch.utils.checkpoint over `unstack` views. Held to one
# bf16 rounding (2^-8 relative): the loss, the grad norm, and in l2 norm
# every gradient leaf of one micro-batch and every updated param leaf.
REMAT_REL = 2.0 ** -8


def loss_grads(model, params, batch, remat: bool) -> list:
    """The gradient of `Model.loss_fn` for every leaf of `params`."""
    from repro_torch.tree import leaves, unflatten
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, _ = model.loss_fn(unflatten(params, flat), batch, remat=remat)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(flat, grads)]


def rel_norm_diffs(a: list, b: list) -> list[float]:
    """Per leaf, ||a - b|| / ||b|| in f32 (0 where both are 0)."""
    out = []
    for x, y in zip(a, b):
        d = float((x.float() - y.float()).norm())
        n = float(y.float().norm())
        out.append(d / n if n > 0 else (0.0 if d == 0 else math.inf))
    return out


def tree_bits_equal(a, b) -> bool:
    from repro_torch.tree import leaves

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return all(x.device == y.device and x.dtype == y.dtype
               and torch.equal(bits(x), bits(y))
               for x, y in zip(leaves(a), leaves(b)))


def model_flops_per_step(cfg, n_matmul_params: int, tokens: int) -> float:
    """6·N·tokens (N: the parameters in matmuls, i.e. all but the embedding
    table, which is a gather) plus causal-blind attention, 12·L·H·Dh·S per
    token (PaLM's model-FLOPs count, appendix B)."""
    return (6 * n_matmul_params
            + 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim
            * TRAIN_SEQ) * tokens


def profile_train_step(step, params, opt, batch, step_ms: float) -> dict:
    """One more train step under torch.profiler: device-busy ms, the idle
    share against the timed steps' mean, kernels and the top kernels by
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = step(params, opt, batch)
        torch.cuda.synchronize()
    del out
    # kernel events only: an aten op's row repeats its kernels' time
    rows = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e3
    gemm = sum(us for k, us, _ in rows
               if any(w in k.lower()
                      for w in ("gemm", "xmma", "cutlass", "nvjet"))) / 1e3
    return {"device_busy_ms": busy, "idle_share_vs_timed_step":
            max(0.0, 1 - busy / step_ms), "kernels": sum(r[2] for r in rows),
            "gemm_ms": gemm,
            "top_kernels": [{"name": k[:90], "ms": us / 1e3, "calls": c}
                            for k, us, c in rows[:15]]}


def phase_train(profile: bool = False):
    """The training path at llama3-1b's full width and depth: seeded bf16
    params on the card, AdamW, `make_train_step` with remat and two
    micro-batches on [4, 512] batches drawn beforehand by the port's corpus;
    then the same step without remat, and a checkpoint round trip. With
    `profile`, one more step under torch.profiler."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                           SyntheticCorpus, batch_iterator)
    from repro_torch.models.transformer import build_model
    from repro_torch.optim import adamw
    from repro_torch.paper.common import to_device
    from repro_torch.train.step import TrainConfig, make_train_step
    from repro_torch.tree import leaves
    cfg = get_config("llama3-1b")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    params = model.init(gen)
    n_params = sum(p.numel() for p in leaves(params))
    n_matmul = n_params - params["embed"].numel() \
        - sum(t.numel() for k in ("attn_norm", "ffn_norm")
              for t in leaves(params["layers"][k])) \
        - params["final_norm"]["scale"].numel()

    # the batches, drawn before the timed window (the corpus is a Python
    # loop over numpy draws); the draw timed alone and through a Prefetcher
    corpus = SyntheticCorpus(cfg.vocab, seed=0)
    dcfg = DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    it = batch_iterator(corpus, dcfg)
    t0 = time.perf_counter()
    host = [next(it) for _ in range(TRAIN_STEPS)]
    draw_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    pf = Prefetcher(batch_iterator(corpus, dcfg), depth=2)
    t0 = time.perf_counter()
    for _ in range(4):
        next(pf)
    prefetch_ms = (time.perf_counter() - t0) * 1e3 / 4
    pf.close()
    batches = [to_device(b, DEV) for b in host]

    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2,
                                total_steps=TRAIN_STEPS)
    step = make_train_step(model, opt_cfg, TrainConfig(
        num_microbatches=TRAIN_MICRO, remat=True))
    opt = adamw.init_state(opt_cfg, params)
    start = [torch.cuda.Event(enable_timing=True) for _ in batches]
    end = [torch.cuda.Event(enable_timing=True) for _ in batches]
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        start[i].record()
        params, opt, m = step(params, opt, batch)
        end[i].record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    step_ms = [s.elapsed_time(e) for s, e in zip(start, end)]
    peak_train = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    steady = step_ms[1:]
    ms = sum(steady) / len(steady)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops_per_step(cfg, n_matmul, tokens)
    prof = profile_train_step(step, params, opt, batches[0], ms) \
        if profile else None

    # the same step without remat, from the trained params and the first
    # batch, against the remat'd step from the same (REMAT_REL)
    rstep = {r: make_train_step(model, opt_cfg, TrainConfig(
        num_microbatches=TRAIN_MICRO, remat=r)) for r in (True, False)}
    check, updated = {}, {}
    for r in (True, False):
        new, _, m = rstep[r](params, opt, batches[0])
        check[r] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])}
        updated[r] = leaves(new)
        del new, _, m
    update_rel = rel_norm_diffs(updated[True], updated[False])
    del updated
    mb = {k: v[:TRAIN_BATCH // TRAIN_MICRO] for k, v in batches[0].items()}
    grads = {r: loss_grads(model, params, mb, r) for r in (True, False)}
    grad_rel = rel_norm_diffs(grads[True], grads[False])
    del grads
    torch.cuda.empty_cache()

    # a checkpoint round trip of the trained params, async, in the
    # checkout's (git-ignored) build directory
    root = _build.build_dir()
    root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root, prefix="ckpt.") as tmp:
        mgr = CheckpointManager(tmp, keep=1)
        t0 = time.perf_counter()
        mgr.save(TRAIN_STEPS, {"params": params})
        save_s = time.perf_counter() - t0
        mgr.wait()
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = mgr.restore(target={"params": params})["params"]
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ckpt_ok = tree_bits_equal(back, params)
        del back

    rec = {
        "model": "llama3-1b, 16 layers, d_model 2048, d_ff 8192, 32/8 "
                 "heads of 64, vocab 128256, bf16 params, seeded",
        "parameters": n_params, "matmul_parameters": n_matmul,
        "batch": [TRAIN_BATCH, TRAIN_SEQ], "microbatches": TRAIN_MICRO,
        "remat": True, "steps": TRAIN_STEPS,
        "optimizer": dataclasses.asdict(opt_cfg),
        "losses": losses, "grad_norms": gnorms,
        "step_ms": step_ms, "ms_per_step": ms,
        "wall_s_all_steps": wall_s,
        "tokens_per_s": tokens / (ms / 1e3),
        "model_flops_per_step": flops,
        "model_flops_formula": "6*N_matmul*tokens + 12*L*H*Dh*S*tokens",
        "model_flops_share_of_989_tflops": flops / (ms / 1e3)
        / PEAK_BF16_FLOPS_S,
        "peak_device_memory_gib": peak_train,
        "host_ms_per_batch_draw": draw_ms,
        "host_ms_per_batch_through_prefetcher": prefetch_ms,
        "remat_vs_no_remat": {
            "loss": [check[True]["loss"], check[False]["loss"]],
            "grad_norm": [check[True]["grad_norm"],
                          check[False]["grad_norm"]],
            "max_leaf_grad_rel_norm_diff": max(grad_rel),
            "max_leaf_update_rel_norm_diff": max(update_rel),
            "bound_rel": REMAT_REL},
        "checkpoint": {"save_return_s": save_s, "save_until_wait_s": write_s,
                       "restore_s": restore_s, "bit_equal": ckpt_ok,
                       "gib": sum(p.numel() * p.element_size()
                                  for p in leaves(params)) / 2 ** 30},
        "profile": prof}
    problems = []
    if not all(math.isfinite(v) for v in losses + gnorms):
        problems.append("a loss or grad norm is not finite")
    if not (losses[-1] + losses[-2]) / 2 < losses[0]:
        problems.append(f"the loss did not fall: {losses}")
    for k in ("loss", "grad_norm"):
        if abs(check[True][k] - check[False][k]) \
                > REMAT_REL * abs(check[False][k]):
            problems.append(f"remat changed the {k}: {check}")
    if not max(grad_rel) <= REMAT_REL:
        problems.append(f"remat changed a gradient leaf: {grad_rel}")
    if not max(update_rel) <= REMAT_REL:
        problems.append(f"remat changed an updated param leaf: {update_rel}")
    if not ckpt_ok:
        problems.append("the restored params differ from the saved ones")
    emit("train", ok=not problems, **rec, problems=problems)
    del params, opt, batches, metrics
    torch.cuda.empty_cache()
    if problems:
        fail(f"train phase: {problems}")


# ---------------------------------------------------------------------------
# phase: paper
# ---------------------------------------------------------------------------

def ordering_flags(t1, t6):
    """The paper's orderings on the surrogate, each with a `holds` flag
    (findings, not gates)."""
    out = {}
    for rounding, rows in t1.items():
        ppl = {(m, b): v for m, b, v in rows}
        bs = sorted(b for m, b in ppl if m == "perq")
        full = ppl[("full_vector", "-")]
        out[rounding] = {
            "perq_le_no_permute_at_every_b": all(
                ppl[("perq", b)] <= ppl[("no_permute", b)] for b in bs),
            "both_approach_full_vector": all(
                abs(ppl[(m, bs[-1])] - full) <= abs(ppl[(m, bs[0])] - full)
                for m in ("perq", "no_permute")),
            "headline_b16_gap_share_closed_by_perq": (
                (ppl[("no_permute", 16)] - ppl[("perq", 16)])
                / (ppl[("no_permute", 16)] - full)
                if ppl[("no_permute", 16)] != full else None),
        }
    ppl6 = dict(t6)
    chain = ["identity", "random", "absmax", "zigzag", "massdiff"]
    out["table6_identity_random_absmax_zigzag_massdiff"] = {
        "ppl": [ppl6[m] for m in chain],
        "holds": all(ppl6[a] > ppl6[b] for a, b in zip(chain[:3], chain[1:4]))
        and ppl6["zigzag"] >= ppl6["massdiff"]}
    return out


def phase_paper():
    """The paper's tables on the surrogate trained on the card, then the
    served example (fake-quant model, f32 pages through the attention
    kernel)."""
    from repro_torch.examples import serve_quantized
    from repro_torch.paper import (common, fig3_delta, fig45_bounds,
                                   massdiff_speed, table1_blocksize,
                                   table2_formats, table6_permutations,
                                   table34_opcounts)
    secs = {}

    def timed(name, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    bench = timed("bench_model_train_and_cache", common.bench_model,
                  refresh=True, device="cuda")
    cfg, model, params, corpus = bench
    bf16_ppl = timed("bf16_ppl", common.eval_ppl, model, params, corpus)
    t1 = {r: timed(f"table1_{r}", table1_blocksize.run, r, bench=bench)
          for r in ("qronos", "rtn")}
    t6 = timed("table6", table6_permutations.run, bench=bench)
    t2 = timed("table2", table2_formats.run, bench=bench)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        table34_opcounts.main()
    t34 = buf.getvalue().splitlines()
    md_s = massdiff_speed.run()
    fig3 = timed("fig3", fig3_delta.run, bench)
    fig45 = timed("fig45", fig45_bounds.run, bench=bench)

    kops.reset_kernel_launch_counts()
    kops.reset_dispatch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        served = timed("serve_example", serve_quantized.main, device="cuda")
    launches = kops.kernel_launch_counts()
    plain = {f"{e}.{p}": n for (e, p), n in kops.dispatch_counts().items()
             if p == "ref"}
    done = served["done"]
    # the same model and requests served by the plain versions (eager, no
    # graphs): the same greedy tokens for every request
    with kops.use_kernels(False):
        plain_done, _ = timed("serve_example_plain", serve_quantized.serve,
                              served["qmodel"], served["params"])
    tokens = {r.rid: r.generated for r in done}
    same_tokens = tokens == {r.rid: r.generated for r in plain_done}

    ppls = [bf16_ppl] + [v for rows in t1.values() for *_, v in rows] \
        + [v for _, v in t6] + [v for *_, v in t2]
    problems = []
    if not all(math.isfinite(v) for v in ppls):
        problems.append("a perplexity is not finite")
    if not bf16_ppl < cfg.vocab / 2:
        problems.append(f"bf16 perplexity {bf16_ppl} is not below "
                        f"{cfg.vocab / 2}")
    if not launches["paged_attention"] > 0 or plain:
        problems.append(f"served example: attention launches "
                        f"{launches['paged_attention']}, plain {plain}")
    if len(done) != 6 or any(len(r.generated) != serve_quantized.MAX_NEW
                             for r in done):
        problems.append("served example: not every request got "
                        f"{serve_quantized.MAX_NEW} tokens")
    if not same_tokens:
        problems.append("served example: the kernels' tokens differ from "
                        "the plain versions'")
    emit("paper", ok=not problems,
         surrogate="llama3 4 layers, d_model 128, d_ff 256, vocab 512, f32, "
                   "300 AdamW steps of [16, 64] Markov-Zipf batches, "
                   "outliers injected", seconds=secs, bf16_ppl=bf16_ppl,
         uniform_ppl=cfg.vocab, table1_qronos=t1["qronos"],
         table5_rtn=t1["rtn"], table6=t6, table2=t2,
         orderings=ordering_flags(t1, t6), table34=t34,
         massdiff_llama3_8b_host_s=md_s, fig3=fig3, fig45=fig45,
         served_example={"requests": len(done),
                         "paged_attention_launches":
                             launches["paged_attention"],
                         "plain_dispatches": plain,
                         "tokens_equal_plain_run": same_tokens,
                         "lines": buf.getvalue().splitlines()[:1]},
         problems=problems)
    if problems:
        fail(f"paper phase: {problems}")


# ---------------------------------------------------------------------------
# phase: launch_train
# ---------------------------------------------------------------------------

LAUNCH_ARCH = "qwen1.5-0.5b"
LAUNCH_BATCH, LAUNCH_SEQ = 4, 512
LAUNCH_ARGS = ["--arch", LAUNCH_ARCH, "--batch", str(LAUNCH_BATCH),
               "--seq", str(LAUNCH_SEQ), "--microbatches", "2", "--remat",
               "--checkpoint-every", "4"]
LAUNCH_KEEP = 3          # the launcher's CheckpointManager keeps three


@contextlib.contextmanager
def recorded(owner, name: str, into: list, what):
    """Wrap `owner.name` for the block: each call appends `what(args,
    result, seconds)` to `into`."""
    orig = getattr(owner, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        into.append(what(args, kwargs, out, time.perf_counter() - t0))
        return out

    setattr(owner, name, wrapper)
    try:
        yield into
    finally:
        setattr(owner, name, orig)


def tree_max_dist(a, b) -> float:
    from repro_torch.tree import leaves
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(leaves(a), leaves(b)))


def launch_runs(root: Path, model):
    """(a): the launcher at qwen1.5-0.5b's full size, 4 steps from scratch,
    then 2 more resumed from its step-4 checkpoint. The driver's step
    times, the losses, how long the driver waits for each batch, and every
    save, write and restore are recorded by wrapping their functions for
    the run."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as LT
    from repro_torch.runtime import driver as RD
    from repro_torch.tree import leaves
    shapes = model.init_shapes()
    n_params = sum(t.numel() for t in leaves(shapes))
    ckpt_bytes = sum(t.numel() * t.element_size() for t in leaves(shapes)) \
        + 2 * 4 * n_params + 4
    free = shutil.disk_usage(root).free
    if free < LAUNCH_KEEP * ckpt_bytes * 1.05:
        fail(f"launch_train: {free / 1e9:.1f} GB free under {root}, the "
             f"launcher keeps {LAUNCH_KEEP} checkpoints of "
             f"{ckpt_bytes / 1e9:.2f} GB")
    work = tempfile.mkdtemp(dir=root, prefix="launch_train.")
    runs, dts, losses, saves, writes, restores = [], [], [], [], [], []

    def step_factory(*a, **k):
        step = make_step(*a, **k)

        def with_loss(p, o, b):
            out = step(p, o, b)
            losses.append(out[-1]["loss"])
            return out
        return with_loss

    def waited(batches, device):
        """`on_device`, timing how long the driver waits for each batch."""
        inner = feed(batches, device)
        while True:
            t0 = time.perf_counter()
            try:
                b = next(inner)
            except StopIteration:
                return
            waits.append((time.perf_counter() - t0) * 1e3)
            yield b

    make_step, feed, waits = LT.make_train_step, LT.on_device, []
    try:
        for steps in (4, 2):
            state = None
            torch.cuda.reset_peak_memory_stats()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.ExitStack() as st:
                st.enter_context(recorded(
                    RD.StepStats, "record", dts,
                    lambda a, k, out, s: a[2]))
                st.enter_context(recorded(
                    CheckpointManager, "save", saves,
                    lambda a, k, out, s: {"step": a[1], "blocking":
                                          k.get("blocking", False),
                                          "return_s": s}))
                st.enter_context(recorded(
                    CheckpointManager, "_write", writes,
                    lambda a, k, out, s: {"step": a[1], "write_s": s}))
                st.enter_context(recorded(
                    CheckpointManager, "restore", restores,
                    lambda a, k, out, s: {"restore_s": s}))
                LT.make_train_step, LT.on_device = step_factory, waited
                st.callback(setattr, LT, "make_train_step", make_step)
                st.callback(setattr, LT, "on_device", feed)
                st.enter_context(contextlib.redirect_stdout(buf))
                out = LT.main(LAUNCH_ARGS + ["--steps", str(steps),
                                             "--workdir", work])
            torch.cuda.synchronize()
            runs.append({"steps": steps, "wall_s": time.perf_counter() - t0,
                         "lines": buf.getvalue().splitlines(),
                         "end": out["step"],
                         "ewma_ms": out["driver"].stats.ewma * 1e3,
                         "failures": out["driver"].failures,
                         "restores": out["driver"].restores,
                         "peak_device_memory_gib":
                             torch.cuda.max_memory_allocated() / 2 ** 30})
            state = (out["params"], out["opt"])
            del out
        step_dir = Path(work) / "ckpt" / "step_000000006"
        disk = sum(f.stat().st_size for f in step_dir.iterdir())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return state, {"runs": runs, "step_ms": [d * 1e3 for d in dts],
                   "batch_wait_ms": waits,
                   "losses": [float(v) for v in losses], "saves": saves,
                   "writes": writes, "restores": restores,
                   "checkpoint_gb_on_disk": disk / 1e9,
                   "checkpoint_gb_expected": ckpt_bytes / 1e9,
                   "parameters": n_params}


def driver_faults(root: Path) -> tuple[dict, list]:
    """(b): the driver on the card at the surrogate's width, deterministic
    algorithms on: two fault-free runs, a flaky one (one transient failure),
    a dying one (three failures in a row with two retries: a restore)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                           batch_iterator)
    from repro_torch.models.transformer import build_model
    from repro_torch.optim import adamw
    from repro_torch.paper.common import BENCH_CFG, to_device
    from repro_torch.runtime.driver import RuntimeConfig, TrainDriver
    from repro_torch.train.step import TrainConfig, make_train_step
    from repro_torch.tree import flatten_with_paths
    cfg = get_config("llama3-1b").reduced(**BENCH_CFG)
    model = build_model(cfg)
    it = batch_iterator(SyntheticCorpus(cfg.vocab, seed=0),
                        DataConfig(cfg.vocab, 64, 16))
    batches = [to_device(next(it), DEV) for _ in range(12)]
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=8)
    step = make_train_step(model, opt_cfg, TrainConfig(remat=False))
    n_steps = 8

    def run(label, fail_on, max_retries):
        gen = torch.Generator(device=DEV)
        gen.manual_seed(0)
        params = model.init(gen)
        opt = adamw.init_state(opt_cfg, params)
        fed = []

        def faulty(p, o, b):
            fed.append((p, o))
            if len(fed) in fail_on:
                raise RuntimeError("injected device error")
            return step(p, o, b)
        mgr = CheckpointManager(str(root / label), keep=2)
        mgr.save(0, {"params": params, "opt": opt}, blocking=True)
        driver = TrainDriver(faulty, mgr, RuntimeConfig(
            checkpoint_every=4, max_retries=max_retries))
        (p, _), end = driver.run(params, opt, iter(batches),
                                 num_steps=n_steps)
        torch.cuda.synchronize()
        return {"params": p, "end": end, "failures": driver.failures,
                "restores": driver.restores, "latest": mgr.latest_step(),
                "fed": fed, "mgr": mgr}

    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        r1, r2 = run("free1", set(), 2), run("free2", set(), 2)
        flaky = run("flaky", {3}, 2)
        dying = run("dying", {6, 7, 8}, 2)
    finally:
        torch.use_deterministic_algorithms(det)
    d12 = tree_max_dist(r1["params"], r2["params"])
    d_flaky = [tree_max_dist(flaky["params"], r["params"]) for r in (r1, r2)]
    # the state handed to the first call after the restore (call 9: steps
    # 0-4 in calls 1-5, step 5 in 6-8) against the step-4 checkpoint
    back = dying["mgr"].restore(4)
    p, o = dying["fed"][8]
    restored_bits = all(
        torch.equal(v.cpu(), back["::".join(map(str, path))])
        for path, v in flatten_with_paths({"params": p, "opt": o}))
    rec = {"surrogate": "llama3 4 layers, d_model 128, vocab 512, f32",
           "steps": n_steps, "fault_free_max_dist": d12,
           "flaky_max_dist_to_fault_free": d_flaky,
           "flaky": {k: flaky[k] for k in ("end", "failures", "restores",
                                           "latest")},
           "dying": {k: dying[k] for k in ("end", "failures", "restores",
                                           "latest")},
           "state_after_restore_bit_equal_to_checkpoint": restored_bits}
    problems = []
    if not (flaky["end"] == n_steps and flaky["failures"] == 1
            and flaky["restores"] == 0):
        problems.append(f"flaky run: {rec['flaky']}")
    if not min(d_flaky) <= d12:
        problems.append(f"the flaky run's params lie {d_flaky} from the "
                        f"fault-free runs', which lie {d12} apart")
    if not (dying["restores"] >= 1 and dying["end"] == n_steps
            and dying["latest"] == n_steps):
        problems.append(f"dying run: {rec['dying']}")
    if not restored_bits:
        problems.append("the state after the restore is not the checkpoint")
    return rec, problems


def compression_at_size(model, params, opt,
                        root: Path) -> tuple[dict, list]:
    """(c): two train steps at the launcher's size plain, plain while a
    `Prefetcher` draws batches at this vocab in the background, and with
    `compress_grads`, in turns; the compression gates on one error-fed
    gradient; `compressed_psum` on a one-rank NCCL group."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                           SyntheticCorpus, batch_iterator)
    from repro_torch.distributed import compression as C
    from repro_torch.distributed.context import Mesh, mesh_context
    from repro_torch.optim import adamw
    from repro_torch.paper.common import to_device
    from repro_torch.train.step import TrainConfig, make_train_step
    from repro_torch.tree import leaves, unflatten
    cfg = model.cfg
    dcfg = DataConfig(cfg.vocab, LAUNCH_SEQ, LAUNCH_BATCH)
    corpus = SyntheticCorpus(cfg.vocab, seed=1)
    it = batch_iterator(corpus, dcfg)
    batches = [to_device(next(it), DEV) for _ in range(2)]
    opt_cfg = adamw.AdamWConfig(lr=3e-3, total_steps=8)
    steps = {c: make_train_step(model, opt_cfg, TrainConfig(
        num_microbatches=2, remat=True, compress_grads=c))
        for c in (False, True)}
    ef = C.init_ef_state(params)
    ef_gib = sum(t.numel() * t.element_size() for t in leaves(ef)) / 2 ** 30
    variants = ("plain", "plain_while_drawing", "compressed")
    ms = {v: [] for v in variants}
    for turn in range(2):
        for v in variants:
            pf = Prefetcher(batch_iterator(corpus, dcfg), depth=16) \
                if v == "plain_while_drawing" else None
            p, o = params, opt
            for b in batches:
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                out = steps[True](p, o, b, ef) if v == "compressed" \
                    else steps[False](p, o, b)
                e.record()
                torch.cuda.synchronize()
                ms[v].append(s.elapsed_time(e))
                p, o = out[0], out[1]
                if v == "compressed":
                    ef = out[2]
                del out
            del p, o
            if pf is not None:
                pf.close()
    # the gates, on the gradient of one micro-batch (f32, as the step's
    # accumulator) fed the error of the steps above
    flat = [t.detach().requires_grad_(True) for t in leaves(params)]
    loss, _ = model.loss_fn(unflatten(params, flat),
                            {k: v[:2] for k, v in batches[0].items()},
                            remat=True)
    grads = unflatten(params, [g.float() for g in
                               torch.autograd.grad(loss, flat)])
    del flat, loss
    deq, new_ef = C.ef_compress_grads(grads, ef)
    worst, ef_exact = 0.0, True
    for g, e, d, n in zip(leaves(grads), leaves(ef), leaves(deq),
                          leaves(new_ef)):
        g32 = g + e
        scale = float(g32.abs().max().clamp_min(1e-30)) / 127
        slack = float(np.spacing(np.float32(scale * 127)))
        worst = max(worst, float((d - g32).abs().max()) / (scale / 2 + slack))
        ef_exact &= torch.equal(n, g32 - d)
    del grads, deq, new_ef, ef
    # compressed_psum on a one-rank NCCL group
    store = root / "nccl_store"
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        x = leaves(params)[-1].detach()
        with mesh_context(Mesh(np.zeros((1,), int), ("pod",), "cuda")):
            got = C.compressed_psum(x, "pod")
        torch.cuda.synchronize()
        q, s = C._quantize_leaf(x.float())
        want = (q.float() * s).to(x.dtype)
        psum_equal = torch.equal(got, want)
    finally:
        dist.destroy_process_group()
    rec = {"step_ms": ms,
           "ef_state_gib": ef_gib,
           "max_deq_err_over_half_scale": worst,
           "new_ef_equals_g32_minus_deq": ef_exact,
           "compressed_psum_one_rank_nccl": {"shape": list(x.shape),
                                             "dtype": str(x.dtype),
                                             "equal": psum_equal}}
    problems = []
    if not worst <= 1.0:
        problems.append(f"|deq - g32| reached {worst} half-scales")
    if not ef_exact:
        problems.append("new_ef != g32 - deq")
    if not psum_equal:
        problems.append("compressed_psum on one rank is not the "
                        "quantize-dequantize of its input")
    return rec, problems


def phase_launch_train():
    """The training entry point on the card: (a) `launch.train` at
    qwen1.5-0.5b's full size, 4 steps then 2 resumed from its own step-4
    checkpoint; (b) the fault-tolerant driver under injected faults at the
    surrogate's width; (c) int8 error-feedback compression at qwen's
    size."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                           batch_iterator)
    from repro_torch.models.transformer import build_model
    t_phase = time.perf_counter()
    secs = {}
    root = _build.build_dir()
    root.mkdir(parents=True, exist_ok=True)
    cfg = get_config(LAUNCH_ARCH)
    model = build_model(cfg)
    # the host's batch draw at this vocab, alone
    it = batch_iterator(SyntheticCorpus(cfg.vocab, seed=0),
                        DataConfig(cfg.vocab, LAUNCH_SEQ, LAUNCH_BATCH))
    t0 = time.perf_counter()
    for _ in range(3):
        next(it)
    draw_ms = (time.perf_counter() - t0) * 1e3 / 3

    t0 = time.perf_counter()
    (params, opt), launch = launch_runs(root, model)
    secs["launcher"] = time.perf_counter() - t0
    problems = []
    lines = [r["lines"] for r in launch["runs"]]
    if not all(math.isfinite(v) for v in launch["losses"]) \
            or len(launch["losses"]) != 6:
        problems.append(f"losses: {launch['losses']}")
    if "resumed from step 4" not in lines[1]:
        problems.append(f"run 2 did not resume from step 4: {lines[1]}")
    if "finished at step 6; failures=0 restores=0" not in lines[1] \
            or launch["runs"][1]["end"] != 6:
        problems.append(f"run 2 did not finish at step 6: {lines[1]}")
    tokens = LAUNCH_BATCH * LAUNCH_SEQ
    steady = launch["step_ms"][1:4] + launch["step_ms"][5:]
    launch["tokens_per_s_steady"] = tokens / (np.mean(steady) / 1e3)
    launch["wall_ms_per_step"] = [r["wall_s"] * 1e3 / r["steps"]
                                  for r in launch["runs"]]
    launch["host_ms_per_batch_draw"] = draw_ms

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root, prefix="faults.") as tmp:
        faults, more = driver_faults(Path(tmp))
    secs["driver_faults"] = time.perf_counter() - t0
    problems += more

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root, prefix="compress.") as tmp:
        comp, more = compression_at_size(model, params, opt, Path(tmp))
    secs["compression"] = time.perf_counter() - t0
    problems += more
    del params, opt
    torch.cuda.empty_cache()
    secs["phase"] = time.perf_counter() - t_phase
    emit("launch_train", ok=not problems,
         model="qwen1.5-0.5b, 24 layers, d_model 1024, d_ff 2816, 16/16 "
               "heads of 64, QKV bias, vocab 151936, untied lm_head, bf16, "
               "seeded", args=LAUNCH_ARGS, seconds=secs, launcher=launch,
         driver_faults=faults, compression=comp, problems=problems)
    if problems:
        fail(f"launch_train phase: {problems}")

# ---------------------------------------------------------------------------
# phase: dryrun
# ---------------------------------------------------------------------------

DRYRUN_ARCHS = ("llama3-1b", "qwen1.5-0.5b")
DRYRUN_TIMEOUT_S = 400
DECODE_BATCH, DECODE_CACHE = 4, 128
RATE_GEMM = 8192
RATE_COPY_BYTES = 2 ** 30


def dryrun_commands(out: Path) -> dict:
    """The dry-run processes of the phase: both archs over every shape on
    both production meshes, their integer decode, and the two cells held
    against real steps on one rank (the train phase's step; the integer
    decode step at batch 4 on a 128-position dense cache)."""
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
            str(out)]
    cmds = {}
    for arch in DRYRUN_ARCHS:
        for pod in ("single", "multi"):
            cmds[f"{arch}/{pod}"] = base + ["--arch", arch, "--multi-pod",
                                            pod]
        cmds[f"{arch}/quantized"] = base + [
            "--arch", arch, "--shape", "decode_32k", "--multi-pod", "both",
            "--quantized-serve", "--tag", "q"]
    cmds["check/train"] = base + [
        "--arch", "llama3-1b", "--shape", "train_4k", "--mesh", "1,1",
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
        "--microbatches", str(TRAIN_MICRO), "--tag", "check"]
    cmds["check/decode"] = base + [
        "--arch", "llama3-1b", "--shape", "decode_32k", "--mesh", "1,1",
        "--batch", str(DECODE_BATCH), "--seq", str(DECODE_CACHE),
        "--quantized-serve", "--tag", "check"]
    return cmds


def measured_rates() -> dict:
    """The achieved dense bf16 GEMM rate (8192^3) and device-to-device copy
    rate (1 GiB, read + write), beside the roofline's datasheet figures."""
    from repro_torch.launch import roofline as R
    n = RATE_GEMM
    g = torch.Generator(device=DEV)
    g.manual_seed(0)
    a = torch.randn(n, n, device=DEV, dtype=torch.bfloat16, generator=g)
    b = torch.randn(n, n, device=DEV, dtype=torch.bfloat16, generator=g)
    gemm_ms = time_ms([lambda: a @ b], 20)
    src = torch.empty(RATE_COPY_BYTES, dtype=torch.uint8, device=DEV)
    dst = torch.empty_like(src)
    copy_ms = time_ms([lambda: dst.copy_(src)], 20)
    del a, b, src, dst
    torch.cuda.empty_cache()
    gemm = 2.0 * n ** 3 / (gemm_ms / 1e3)
    copy = 2.0 * RATE_COPY_BYTES / (copy_ms / 1e3)
    return {"gemm_bf16_flops_s": gemm, "gemm_ms": gemm_ms,
            "datasheet_bf16_flops_s": R.PEAK_FLOPS,
            "gemm_share_of_datasheet": gemm / R.PEAK_FLOPS,
            "copy_bytes_s": copy, "copy_ms": copy_ms,
            "datasheet_hbm_bytes_s": R.HBM_BW,
            "copy_share_of_datasheet": copy / R.HBM_BW,
            "link_bytes_s_datasheet": R.LINK_BW}


def roofline_ms(rec: dict) -> tuple[float, float]:
    """(max(compute, memory) term, collective term) of a record, ms."""
    from repro_torch.launch import roofline as R
    row = R.roofline_row(rec)
    return max(row["t_compute_s"], row["t_memory_s"]) * 1e3, \
        row["t_collective_s"] * 1e3


def check_train_count(rec: dict) -> tuple[dict, list]:
    """The train phase's step (llama3-1b full size, [4, 512], 2
    micro-batches, remat) on the card against its dry-run count: FLOPs
    op by op against FlopCounterMode on the real step, argument + temp
    bytes against the step's peak allocation, the measured step time
    against the roofline."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import TrainConfig, make_train_step
    problems = []
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cfg = get_config("llama3-1b")
    model = build_model(cfg)
    g = torch.Generator(device=DEV)
    g.manual_seed(0)
    params = model.init(g)
    opt_cfg = adamw.AdamWConfig()
    opt = adamw.init_state(opt_cfg, params)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         device=DEV, generator=g, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    step = make_train_step(model, opt_cfg, TrainConfig(
        num_microbatches=TRAIN_MICRO, remat=True))
    out = step(params, opt, batch)            # warm-up
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(params, opt, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del out
    peak = torch.cuda.max_memory_allocated() - base
    with FlopCounterMode(display=False) as fc:
        out = step(params, opt, batch)
    del out
    real = {str(k).split(".")[-1]: float(v)
            for k, v in fc.get_flop_counts()["Global"].items()}
    del params, opt, batch
    torch.cuda.empty_cache()
    counted = {k: float(v)
               for k, v in rec["hlo_costs"]["flops_by_op"].items() if v}
    differ = {k: {"dry_run": counted.get(k, 0.0), "card": real.get(k, 0.0)}
              for k in sorted(set(real) | set(counted))
              if counted.get(k, 0.0) != real.get(k, 0.0)}
    flops_real = sum(real.values())
    if differ:
        problems.append(f"train FLOPs differ op by op: {differ}")
    mem = rec["memory"]
    predicted = mem["argument_size_bytes"] + mem["temp_size_bytes"]
    if not 0.8 <= predicted / peak <= 1.2:
        problems.append(f"train memory: dry run {predicted} B against a "
                        f"peak of {peak} B on the card")
    step_ms = float(np.median(times))
    bound_ms, coll_ms = roofline_ms(rec)
    if step_ms < bound_ms:
        problems.append(f"train step {step_ms:.3f} ms below its roofline "
                        f"{bound_ms:.3f} ms: the count is wrong")
    return {"flops_dry_run": rec["hlo_costs"]["flops_per_device"],
            "flops_card": flops_real, "ops_that_differ": differ,
            "argument_plus_temp_bytes": predicted, "peak_bytes_card": peak,
            "memory_ratio": predicted / peak, "step_ms": times,
            "step_ms_median": step_ms, "roofline_ms": bound_ms,
            "collective_ms": coll_ms,
            "measured_over_roofline": step_ms / bound_ms}, problems


def check_decode_count(rec: dict) -> tuple[dict, list]:
    """llama3-1b's integer decode step (random weights packed to int4, bf16
    dense cache of 128 positions, batch 4, every row at position 127) on
    the card against the roofline of its dry-run count: its device time
    (the step replayed from a CUDA graph), and its eager time."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import build_model
    from repro_torch.serve.quantized import QuantizedDenseLM, pack_dense_params
    problems = []
    cfg = get_config("llama3-1b")
    g = torch.Generator(device=DEV)
    g.manual_seed(1)
    params = pack_dense_params(build_model(cfg).init(g), cfg)
    torch.cuda.empty_cache()
    qlm = QuantizedDenseLM(cfg, block_size=32)
    cache = qlm.init_cache(DECODE_BATCH, DECODE_CACHE, device=DEV)
    tokens = torch.randint(0, cfg.vocab, (DECODE_BATCH, 1), device=DEV,
                           generator=g, dtype=torch.int32)
    index = torch.full((DECODE_BATCH,), DECODE_CACHE - 1, device=DEV,
                       dtype=torch.int32)
    before = kops.count_snapshot()
    logits, _ = qlm.decode_step(params, tokens, cache, index)
    torch.cuda.synchronize()
    _, dispatch = kops.counts_since(before)
    for entry in ("quantize_act", "int4_matmul", "hadamard_quant"):
        if not dispatch.get((entry, "kernels")):
            problems.append(f"decode did not launch {entry}'s kernel")
    if not bool(torch.isfinite(logits).all()):
        problems.append("decode logits not finite")
    step = [lambda: qlm.decode_step(params, tokens, cache, index)]
    eager_ms = time_ms(step, 20)
    step_ms = device_ms(step)        # one CUDA graph replay: device time
    del params, cache, step
    torch.cuda.empty_cache()
    bound_ms, _ = roofline_ms(rec)
    if step_ms < bound_ms:
        problems.append(f"decode step {step_ms:.4f} ms below its roofline "
                        f"{bound_ms:.4f} ms: the count is wrong")
    hc = rec["hlo_costs"]
    return {"flops_dry_run": hc["flops_per_device"],
            "bytes_dry_run": hc["bytes_per_device"],
            "kernel_ops": hc["kernel_ops"], "step_ms": step_ms,
            "eager_step_ms": eager_ms,
            "roofline_ms": bound_ms,
            "measured_over_roofline": step_ms / bound_ms,
            "dispatch": {f"{k[0]}.{k[1]}": v
                         for k, v in dispatch.items()}}, problems


def phase_dryrun():
    """The dry run (`repro_torch.launch.dryrun`, meta tensors over a fake
    world of 256 or 512 ranks, no card) for llama3-1b and qwen1.5-0.5b on
    both production meshes, in processes of their own that see no card,
    while the card measures its GEMM and copy rates; then two counts held
    against real steps on one rank."""
    from repro_torch.launch import roofline as R
    t0 = time.perf_counter()
    out = _build.build_dir() / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = {name: subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
             for name, cmd in dryrun_commands(out).items()}
    problems = []
    try:
        rates = measured_rates()
        logs = {}
        for name, p in procs.items():
            try:
                logs[name] = p.communicate(timeout=max(
                    1, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))[0]
            except subprocess.TimeoutExpired:
                p.kill()
                logs[name] = p.communicate()[0]
                problems.append(f"dry run {name} timed out")
            if p.returncode != 0:
                problems.append(f"dry run {name} exited {p.returncode}: "
                                f"{logs[name][-2000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    dry_s = time.perf_counter() - t0
    recs = {f.name: json.loads(f.read_text()) for f in sorted(out.glob("*.json"))}
    cells, rows = {}, []
    for fname, rec in recs.items():
        if "__check" in fname:
            continue
        cells[fname] = {"status": rec["status"], "seconds": rec.get("lower_s"),
                        "reason": rec.get("reason")}
        if rec["status"] == "fail" or (
                rec["status"] == "skipped" and rec["shape"] != "long_500k"):
            problems.append(f"dry-run cell {fname}: {rec['status']}")
        row = R.roofline_row(rec)
        if row is not None:
            rows.append({**row, "quantized": rec["quantized_serve"],
                         "collectives": rec["collectives"]["count_by_kind"]})
    expected = 2 * len(DRYRUN_ARCHS) * 4 + 2 * len(DRYRUN_ARCHS) + 2
    if len(recs) != expected:
        problems.append(f"{len(recs)} dry-run records, {expected} expected")
    t1 = time.perf_counter()
    checks = {}
    if not problems:
        checks["train"], more = check_train_count(
            recs["llama3-1b__train_4k__sp__check.json"])
        problems += more
        checks["decode"], more = check_decode_count(
            recs["llama3-1b__decode_32k__sp__check.json"])
        problems += more
    emit("dryrun", ok=not problems, rates=rates, cells=cells, roofline=rows,
         checks=checks,
         seconds={"dry_run_processes": dry_s,
                  "checks": time.perf_counter() - t1,
                  "phase": time.perf_counter() - t0},
         problems=problems)
    if problems:
        fail(f"dryrun phase: {problems}")

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
                    help="also break a decode step and a train step down "
                         "with torch.profiler")
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
    launches, adapter, serve_tokens = phase_serve()
    phase_parity(adapter)
    phase_graph(adapter)
    phase_robust(adapter, serve_tokens)
    if args.profile:
        phase_profile(adapter)
    del adapter
    phase_ptq()
    phase_families()
    phase_train(args.profile)
    phase_paper()
    phase_launch_train()
    phase_dryrun()
    print(smi, flush=True)
    print(json.dumps(kernel_record(cases, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
