"""Table 2: perplexity across data formats x pipeline compositions.

    PYTHONPATH=src python -m repro_torch.paper.table2_formats [--device cpu]
"""
from __future__ import annotations

import argparse

from ..core import pipeline as PL
from ..core.quantizers import QuantSpec
from .common import (add_bench_args, bench_from_args, bench_model, eval_ppl,
                     quantize_and_eval)

METHODS = ["mr_rtn", "mr_gptq", "mr_qronos", "brq_spin", "perq_star",
           "perq_dagger"]
FORMATS = ["int4", "fp4", "mxfp4"]


def run(*, bench=None, n_eval: int = 4, formats=FORMATS):
    cfg, model, params, corpus = bench or bench_model()
    rows = [("bf16", "-", eval_ppl(model, params, corpus))]
    for fmt in formats:
        for name in METHODS:
            ptq = PL.preset(name, weight_spec=QuantSpec(fmt=fmt),
                            act_spec=QuantSpec(fmt=fmt), cayley_steps=8)
            rows.append((name, fmt, quantize_and_eval(
                model, params, corpus, ptq, n_eval=n_eval)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-eval", type=int, default=4)
    ap.add_argument("--formats", default=",".join(FORMATS))
    add_bench_args(ap)
    args = ap.parse_args(argv)
    rows = run(bench=bench_from_args(args), n_eval=args.n_eval,
               formats=args.formats.split(","))
    print("# Table2 surrogate")
    print("method,format,ppl")
    for name, fmt, ppl in rows:
        print(f"{name},{fmt},{ppl:.3f}")


if __name__ == "__main__":
    main()
