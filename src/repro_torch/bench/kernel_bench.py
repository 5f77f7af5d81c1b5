"""Kernel micro-benchmarks of the port, timed on the card: the twin of the
reference's `benchmarks/kernel_bench.py`.

Rows, in the reference's order and under its op names:

- `block_hadamard_b32`, `hadamard_quant_fused_b32` (not with `--smoke`):
  x [2048, 8192] f32, b = 32, through `kernels.ops` (`kernel_us`) and the
  plain versions of `kernels.ref` (`plain_us`), operands rotated through
  copies that exceed L2 twice; the reference's byte and FLOP counts (bf16
  operands, the rotation as a dense b-wide product) and the least time an
  H100 needs for them (`h100_bound_us`, at 3.35 TB/s and the f32 peak
  outside the tensor cores the butterfly runs on, both in the row);
  `fusion_hbm_byte_saving` is a count.
- `paged_attention_{full_walk,early_exit}`: one decode step of the
  flash-decoding attention over the shared ragged workload
  (`paper.common.ragged_paged_batch`) across context × heads × `kv_splits`;
  `full_walk` passes the table's capacity as every length, `early_exit`
  the true lengths; pages walked per step are the analytic counts.
- `decode_{ref,kernels}`: one `QuantizedDenseLM.decode_step` on the dense
  cache, under `use_kernels(False)` and with the kernels (llama3-1b at
  published size, or the reference's reduced config with `--reduced`).
- `swap_{out,in}_io`: one sequence's pages through the host swap tier and
  back, host clock ending in a synchronise, and the copy's own device time
  (`PagedKVCache.last_transfer`).

On the card every time but the swap rows' host clock is CUDA events; with
`--device cpu` they are host-clock times of the plain versions (`clock:
"host"`), never device numbers. The entry is appended to the history file
(default `artifacts/BENCH_kernels_h100.json`) after `_check_schema` has
checked every row.

    python -m repro_torch.bench.kernel_bench [--smoke] [--reduced]
        [--device cuda|cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels import ref as kref
from ..paper.common import ragged_paged_batch
from . import timing as T

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts")


def hadamard_rows(device: torch.device, iters: int = 50,
                  plain_iters: int = 10):
    m, d, b = 2048, 8192, 32
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    xs = [x.to(device) for _ in range(T.n_copies(x.nbytes))]

    def us(fn, n):
        return T.clock_ms([lambda t=t: fn(t) for t in xs], n, device) * 1e3

    rot_us = us(lambda t: kops.block_hadamard(t, b), iters)
    rot_plain = us(lambda t: kref.block_hadamard_ref(t, b), plain_iters)
    fused_us = us(lambda t: kops.hadamard_quant(t, b), iters)
    fused_plain = us(lambda t: kref.hadamard_quant_ref(t, b), plain_iters)

    bytes_unfused = m * d * 2 * 2 + (m * d * 2 + m * d * 1 + m * 8)
    bytes_fused = m * d * 2 + m * d * 1 + m * 8
    flops_rot = 2 * m * d * b
    peak = {"peak_bytes_s": T.PEAK_BYTES_S, "peak_flops_s": T.PEAK_F32_FLOPS_S,
            "peak": "f32 outside the tensor cores (the butterfly)"}

    def row(op, k_us, p_us, nbytes):
        ms, by = T.bound(nbytes, flops_rot, T.PEAK_F32_FLOPS_S)
        return {"op": op, "kernel_us": round(k_us, 3),
                "plain_us": round(p_us, 3), "model_bytes": nbytes,
                "model_flops": flops_rot, "h100_bound_us": round(ms * 1e3, 3),
                "bound": "memory" if by == "bytes" else "compute", **peak}

    rows = [row(f"block_hadamard_b{b}", rot_us, rot_plain, m * d * 4),
            row(f"hadamard_quant_fused_b{b}", fused_us, fused_plain,
                bytes_fused)]
    saving = 1 - bytes_fused / bytes_unfused
    rows.append({"op": "fusion_hbm_byte_saving", "value": round(saving, 3)})
    print("op,kernel_us,plain_us,model_bytes,model_flops,h100_bound_us,bound")
    for r in rows[:2]:
        print(",".join(str(r[k]) for k in (
            "op", "kernel_us", "plain_us", "model_bytes", "model_flops",
            "h100_bound_us", "bound")))
    print(f"fusion_hbm_byte_saving,{saving:.3f}")
    return rows


def decode_step_bench(device: torch.device, *, reduced: bool,
                      iters: int = 3):
    """Reference-vs-kernel decode-step latency through `QuantizedDenseLM`;
    only the `use_kernels` flag differs."""
    from ..configs.registry import get_config
    from ..models.transformer import build_model
    from ..serve.quantized import QuantizedDenseLM, pack_dense_params

    cfg = get_config("llama3-1b")
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    packed = pack_dense_params(model.init(gen), cfg)
    qlm = QuantizedDenseLM(cfg, block_size=16)
    tok = torch.tensor([[7]], dtype=torch.int64, device=device)

    rows = []
    print("serving_path,decode_step_us")
    for label, enabled in (("ref", False), ("kernels", True)):
        with kops.use_kernels(enabled):
            cache = qlm.init_cache(1, 32, device=device)
            us = T.clock_ms([lambda: qlm.decode_step(packed, tok, cache, 3)],
                            iters, device) * 1e3
        rows.append({"op": f"decode_{label}", "decode_step_us": round(us, 1)})
        print(f"decode_{label},{us:.1f}")
    return rows


def paged_attention_bench(device: torch.device, *, smoke: bool,
                          iters: int = 5):
    """Flash-decoding paged attention: context × heads × kv_splits, and
    the ragged early-exit's pages-walked-per-step reduction.

    One decode step (S = 1) over a ragged batch whose sequence lengths
    span 25%..100% of the context budget. `full_walk` sets `seq_lengths`
    to the table capacity - every instance walks every column - and
    `early_exit` passes the true lengths. Pages walked per step is the
    analytic `Σ_b ceil(len_b / page_size)` vs `batch · n_cols`.
    """
    page_size, batch, dh = 16, 4, 64
    cases = ([(64, 2, 4, 1), (64, 2, 4, 4)] if smoke else
             [(256, 2, 8, 1), (256, 2, 8, 4),
              (1024, 2, 8, 1), (1024, 2, 8, 4), (1024, 2, 8, 8),
              (1024, 8, 32, 4)])
    rng = np.random.default_rng(0)

    def tensor(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device)

    rows = []
    print("op,ctx,kv_heads,q_heads,kv_splits,pages_per_step,us_per_step")
    for ctx, kh, h, kv_splits in cases:
        n_cols = ctx // page_size
        lengths, n_pages, table, positions = ragged_paged_batch(
            batch, ctx, page_size)
        kv = {"k": tensor((n_pages, page_size, kh, dh)),
              "v": tensor((n_pages, page_size, kh, dh))}
        bt = torch.tensor(table, dtype=torch.int32, device=device)
        qpos = torch.tensor(positions, dtype=torch.int32, device=device)
        q = tensor((batch, 1, h, dh))
        true_lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        full_lens = torch.full((batch,), n_cols * page_size,
                               dtype=torch.int32, device=device)

        walked = {"full_walk": batch * n_cols,
                  "early_exit": sum(-(-n // page_size) for n in lengths)}
        for label, lens in (("full_walk", full_lens),
                            ("early_exit", true_lens)):
            us = T.clock_ms([lambda lens=lens: kops.paged_attention(
                q, kv, bt, qpos, lens, kv_splits=kv_splits)],
                iters, device) * 1e3
            rows.append({
                "op": f"paged_attention_{label}", "ctx": ctx,
                "kv_heads": kh, "q_heads": h, "kv_splits": kv_splits,
                "page_size": page_size, "batch": batch,
                "pages_per_step": walked[label],
                "us_per_step": round(us, 3),
            })
            print(f"paged_attention_{label},{ctx},{kh},{h},{kv_splits},"
                  f"{walked[label]},{us:.3f}")
    return rows


def swap_io_bench(device: torch.device, *, smoke: bool, iters: int = 5):
    """Host<->device swap-tier page I/O: the gather + copy to the host
    slots (swap-out) and the copy back + scatter (swap-in) the tiered
    paging engine pays per evicted page, as a measured bandwidth.

    A synthetic `PagedKVCache` with an attached host pool swaps one
    sequence's pages out and back per cycle; a first cycle is discarded.
    The host clock of each direction ends in a synchronise (the copies are
    asynchronous on the card); `copy_device_ms` is the copy's own time by
    the events the cache records around it on its side stream (None on the
    CPU). The bytes per cycle is the per-direction payload
    (`pages · page_bytes`) - the quantity the scheduler's swap-vs-replay
    cost rule weighs against replayed prefill tokens.
    """
    from ..serve.engine.pages import PagedKVCache

    nl, kh, dh = (2, 2, 64) if smoke else (4, 8, 128)
    page_size, n_pages, pages_move = 16, 32, 8
    rng = np.random.default_rng(0)
    shape = (nl, n_pages, page_size, kh, dh)
    kv = {name: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)
        for name in ("k", "v")}
    cache = PagedKVCache(kv, n_pages, page_size, n_slots=2)
    cache.attach_host_pool(64)
    rid = 0
    cache.open(rid)
    cache.ensure(rid, pages_move * page_size)

    def copy_ms():
        if cache.last_transfer is None:
            return None
        start, end = cache.last_transfer
        return start.elapsed_time(end)

    cache.swap_out(rid)          # first cycle: streams, events, caches
    cache.swap_in(rid)
    T.sync(device)
    wall = {"swap_out_io": 0.0, "swap_in_io": 0.0}
    copy = {"swap_out_io": [], "swap_in_io": []}
    for _ in range(iters):
        t0 = time.perf_counter()
        _, nbytes = cache.swap_out(rid)
        T.sync(device)
        wall["swap_out_io"] += time.perf_counter() - t0
        copy["swap_out_io"].append(copy_ms())
        t0 = time.perf_counter()
        cache.swap_in(rid)
        T.sync(device)
        wall["swap_in_io"] += time.perf_counter() - t0
        copy["swap_in_io"].append(copy_ms())
    cache.settle()

    rows = []
    print("op,pages,bytes_per_cycle,us_per_cycle,gib_per_s,copy_device_ms")
    for label, total in wall.items():
        ms = copy[label]
        dev_ms = None if ms[0] is None else sum(ms) / iters
        rows.append({
            "op": label, "pages": pages_move, "bytes_per_cycle": nbytes,
            "us_per_cycle": round(total / iters * 1e6, 1),
            "gib_per_s": round(nbytes / (total / iters) / 2 ** 30, 3),
            "copy_device_ms": dev_ms,
            "copy_gib_per_s": (None if dev_ms is None else
                               round(nbytes / (dev_ms / 1e3) / 2 ** 30, 3)),
        })
        print(",".join(str(rows[-1][k]) for k in (
            "op", "pages", "bytes_per_cycle", "us_per_cycle", "gib_per_s",
            "copy_device_ms")))
    return rows


# required measurement fields per op family - `_check_schema` refuses to
# append a history row that lost one (mirrors serve_bench's row check)
_ROW_FIELDS = {
    "block_hadamard": ("kernel_us", "plain_us", "model_bytes", "model_flops",
                       "h100_bound_us", "bound"),
    "hadamard_quant": ("kernel_us", "plain_us", "model_bytes", "model_flops",
                       "h100_bound_us", "bound"),
    "fusion_hbm": ("value",),
    "paged_attention": ("ctx", "kv_heads", "q_heads", "kv_splits",
                        "page_size", "batch", "pages_per_step",
                        "us_per_step"),
    "decode": ("decode_step_us",),
    "swap": ("pages", "bytes_per_cycle", "us_per_cycle", "gib_per_s",
             "copy_device_ms"),
}


def _check_schema(rows):
    """Every row must carry `op` plus the measurement fields its op family
    defines - a bench path that crashed mid-collection or renamed a field
    fails instead of silently appending a partial row to the JSON
    history."""
    for row in rows:
        op = row.get("op")
        if not op:
            raise ValueError(f"bench row {row!r} is missing 'op'")
        for prefix, fields in _ROW_FIELDS.items():
            if op.startswith(prefix):
                missing = [k for k in fields if k not in row]
                if missing:
                    raise ValueError(
                        f"bench row {op!r} is missing required field(s) "
                        f"{missing}; refusing to write partial history")
                break
        else:
            raise ValueError(f"bench row has unknown op family {op!r}; "
                             "add its required fields to _ROW_FIELDS")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes: runs every bench path once, minimal "
                    "wall time")
    ap.add_argument("--reduced", action="store_true",
                    help="the decode rows on the reduced llama3-1b")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out",
                    default=os.path.join(ART, "BENCH_kernels_h100.json"))
    args = ap.parse_args(argv)
    device = T.bench_device(args.device)

    rows = []
    if not args.smoke:
        rows += hadamard_rows(device)
    rows += paged_attention_bench(device, smoke=args.smoke)
    rows += decode_step_bench(device, reduced=args.reduced)
    rows += swap_io_bench(device, smoke=args.smoke)

    out = {
        "bench": "kernels",
        "device": T.device_record(device),
        "clock": T.clock_name(device),
        "smoke": bool(args.smoke),
        "reduced": bool(args.reduced),
        "rows": rows,
    }
    _check_schema(rows)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    history = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            history = json.load(f).get("history", [])
    history.append(out)
    with open(args.out, "w") as f:
        json.dump({"history": history}, f, indent=1)
    print(f"wrote {args.out} ({len(history)} entries)")
    return out


if __name__ == "__main__":
    main()
