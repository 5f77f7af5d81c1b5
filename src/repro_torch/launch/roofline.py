"""Three-term roofline per (arch x shape x mesh) from the dry run's records.

    compute    = FLOPs_per_device / peak FLOP/s       (989e12 dense bf16)
    memory     = HBM_bytes_per_device / HBM rate      (3.35e12 B/s)
    collective = collective_bytes_per_device / link   (50e9 B/s)

for an NVIDIA H100 SXM5 80GB at its 700 W limit, the card `chip_smoke.py`
reports. The counts come from `launch/dryrun.py` (per device, every loop
trip counted); collective bytes are each collective's result on one device,
no ring factor. Each term is per-device seconds; the largest is the
bottleneck.

MODEL_FLOPS (useful work) = 6·N·D for train (N = matmul parameters, D =
tokens), 2·N_active·D for prefill and decode; MODEL_FLOPS / counted FLOPs
shows recomputation (remat) and redundant work.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh sp|mp] [--csv out]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

# NVIDIA's datasheet figures for the H100 SXM5 80GB at 700 W
PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s (datasheet)
HBM_BW = 3.35e12           # B/s of HBM3 (datasheet)
# B/s per GPU across nodes: one 400 Gb/s InfiniBand NDR port per GPU
# (datasheet); every axis of the production meshes spans more than one
# 8-GPU NVLink node
LINK_BW = 50e9

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                   "dryrun_torch")


def _arch_matmul_params(cfg) -> float:
    """Matmul (FLOP-relevant) parameter count per the config."""
    d = cfg.d_model
    n = 0.0
    if cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.d_inner
        state = cfg.ssm_state
        in_dim = 2 * d_inner + 2 * state + cfg.ssm_heads
        n += cfg.n_layers * (d * in_dim + d_inner * d)
        if cfg.family == "hybrid":
            h = cfg.n_heads * cfg.head_dim
            kvd = cfg.n_kv_heads * cfg.head_dim
            n += d * h + 2 * d * kvd + h * d + 3 * d * cfg.d_ff
    else:
        h = cfg.n_heads * cfg.head_dim
        kvd = cfg.n_kv_heads * cfg.head_dim
        attn = d * h + 2 * d * kvd + h * d
        if cfg.uses_moe:
            ffn_active = 3 * d * cfg.moe_d_ff * (cfg.top_k
                                                 + cfg.n_shared_experts)
        else:
            gates = 3 if cfg.act == "silu" else 2
            ffn_active = gates * d * cfg.d_ff
        n += cfg.n_layers * (attn + ffn_active)
    n += 2 * d * cfg.vocab  # embed (gather ~free, but lm_head matmul counts once)
    return n


def model_flops(arch: str, shape: str, kind: str, *, global_batch=None,
                seq_len=None) -> float:
    """6·N·D (train) or 2·N·D; `global_batch` and `seq_len` replace the
    cell's (a record's own, when the dry run was given others)."""
    from ..configs.registry import get_config
    from ..models.config import ALL_SHAPES
    cfg = get_config(arch)
    cell = {c.name: c for c in ALL_SHAPES}[shape]
    batch = global_batch or cell.global_batch
    seq = seq_len or cell.seq_len
    n = _arch_matmul_params(cfg)
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    # decode: one token per sequence
    return 2.0 * n * batch


def load_records(mesh: str, art: str = ART) -> list[dict]:
    suffix = "__mp.json" if mesh == "mp" else "__sp.json"
    recs = []
    for path in sorted(glob.glob(os.path.join(art, f"*{suffix}"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def roofline_row(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    hc = rec.get("hlo_costs", {})
    if "flops_per_device" not in hc:
        return None
    chips = 1
    for s in rec["mesh"]["shape"]:
        chips *= s
    t_compute = hc["flops_per_device"] / PEAK_FLOPS
    t_memory = hc["bytes_per_device"] / HBM_BW
    t_coll = sum(hc["collective_bytes_by_kind"].values()) / LINK_BW
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)), key=lambda kv: kv[1])[0]
    if rec.get("reduced"):
        mf = 0.0        # the config's counts are the full arch's
    else:
        mf = model_flops(rec["arch"], rec["shape"], rec["kind"],
                         global_batch=rec.get("global_batch"),
                         seq_len=rec.get("seq_len"))
    mf_dev = mf / chips
    useful = mf_dev / hc["flops_per_device"] if hc["flops_per_device"] else 0
    # roofline fraction: useful work at peak / modeled step time
    t_step = max(t_compute, t_memory, t_coll)
    frac = (mf_dev / PEAK_FLOPS) / t_step if t_step > 0 else 0.0
    mem = rec.get("memory", {})
    hbm = (mem.get("argument_size_bytes", 0)
           + mem.get("temp_size_bytes", 0)) / 2 ** 30
    return {
        "arch": rec["arch"], "shape": rec["shape"], "kind": rec["kind"],
        "mesh": "x".join(str(s) for s in rec["mesh"]["shape"]),
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_global": mf, "hlo_flops_dev": hc["flops_per_device"],
        "useful_ratio": useful, "roofline_frac": frac,
        "hbm_gib_dev": hbm,
    }


def fmt_table(rows: list[dict]) -> str:
    hdr = (f"{'arch':26s} {'shape':12s} {'mesh':9s} {'compute_s':>10s} "
           f"{'memory_s':>10s} {'collect_s':>10s} {'dominant':>10s} "
           f"{'useful':>7s} {'roofline':>9s} {'HBM GiB':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:26s} {r['shape']:12s} {r['mesh']:9s} "
            f"{r['t_compute_s']:10.4f} {r['t_memory_s']:10.4f} "
            f"{r['t_collective_s']:10.4f} {r['dominant']:>10s} "
            f"{r['useful_ratio']:7.2f} {r['roofline_frac']:9.3f} "
            f"{r['hbm_gib_dev']:8.1f}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["sp", "mp"], default="sp")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--dir", default=ART, help="the dry run's records")
    args = ap.parse_args(argv)
    rows = [r for r in (roofline_row(rec)
                        for rec in load_records(args.mesh, args.dir))
            if r is not None]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    print(fmt_table(rows))
    if args.csv and rows:
        import csv
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"\nwrote {args.csv}")
    return rows


if __name__ == "__main__":
    main()
