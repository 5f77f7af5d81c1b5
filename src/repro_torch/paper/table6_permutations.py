"""Table 6: permutation strategies under a fixed PeRQ pipeline (b=16,
Qronos): identity < random < absmax < zigzag <= massdiff.

    PYTHONPATH=src python -m repro_torch.paper.table6_permutations [--device cpu]
"""
import argparse

from ..core import pipeline as PL
from .common import (add_bench_args, bench_from_args, bench_model, eval_ppl,
                     quantize_and_eval)

METHODS = ["identity", "random", "absmax", "zigzag", "massdiff"]


def run(block_size: int = 16, *, bench=None, n_eval: int = 4):
    cfg, model, params, corpus = bench or bench_model()
    rows = [("bf16", eval_ppl(model, params, corpus))]
    for perm in METHODS:
        ptq = PL.PTQConfig(block_size=block_size, permutation=perm,
                           rotation="quarot", rounding="qronos")
        rows.append((perm, quantize_and_eval(model, params, corpus, ptq,
                                             n_eval=n_eval)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-eval", type=int, default=4)
    add_bench_args(ap)
    args = ap.parse_args(argv)
    rows = run(bench=bench_from_args(args), n_eval=args.n_eval)
    print("# Table6 surrogate (b=16, qronos)")
    print("permutation,ppl")
    for name, ppl in rows:
        print(f"{name},{ppl:.3f}")


if __name__ == "__main__":
    main()
