"""Table 1 / Table 5: held-out perplexity across block sizes, No-Permute
vs PeRQ (MassDiff), under Qronos (Table 1) or RTN (Table 5).

Paper claims checked (as orderings on the trained surrogate):
  * PeRQ <= No-Permute at every block size, largest gains at small b;
  * both approach the full-vector rotation as b -> d_ff;
  * PeRQ closes the gap at much smaller b.

    PYTHONPATH=src python -m repro_torch.paper.table1_blocksize [--rounding rtn] [--device cpu]
"""
from __future__ import annotations

import argparse

from ..core import pipeline as PL
from .common import (add_bench_args, bench_from_args, bench_model, eval_ppl,
                     quantize_and_eval)

BLOCK_SIZES = (8, 16, 32, 64, 128, 256)


def run(rounding: str = "qronos", block_sizes=BLOCK_SIZES, *, bench=None,
        n_eval: int = 8):
    """[(method, block size or "-", perplexity)]; `bench` is what
    `bench_model` returns (trained on the card when None)."""
    cfg, model, params, corpus = bench or bench_model()
    rows = [("bf16", "-", eval_ppl(model, params, corpus))]
    for b in block_sizes:
        full = b >= cfg.d_ff
        for perm, label in (("identity", "no_permute"),
                            ("massdiff", "perq")):
            ptq = PL.PTQConfig(block_size=b, permutation=perm,
                               rotation="quarot", rounding=rounding,
                               full_vector_r3=full)
            rows.append((label, b, quantize_and_eval(model, params, corpus,
                                                     ptq, n_eval=n_eval)))
    # full-vector reference (QuaRot)
    ptq = PL.preset("quarot", rounding=rounding)
    rows.append(("full_vector", "-",
                 quantize_and_eval(model, params, corpus, ptq, n_eval=n_eval)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounding", default="qronos",
                    choices=["qronos", "gptq", "rtn"])
    ap.add_argument("--block-sizes", default=",".join(map(str, BLOCK_SIZES)))
    ap.add_argument("--n-eval", type=int, default=8)
    add_bench_args(ap)
    args = ap.parse_args(argv)
    rows = run(args.rounding, [int(b) for b in args.block_sizes.split(",")],
               bench=bench_from_args(args), n_eval=args.n_eval)
    print(f"# Table1 surrogate (rounding={args.rounding})")
    print("method,block_size,ppl")
    for label, b, ppl in rows:
        print(f"{label},{b},{ppl:.3f}")


if __name__ == "__main__":
    main()
