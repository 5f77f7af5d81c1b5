"""Runner: one harness per paper table and figure, then the kernel bench.

    PYTHONPATH=src python -m repro_torch.paper.run [--device cpu] [--train-steps N] [--cache-dir D]

Prints ``name,us_per_call,derived`` CSV rows per harness, then each
harness's own table output. The options are handed to every harness that
uses the trained surrogate; the kernel bench (`bench/kernel_bench.py`, the
last job) gets `--device` alone and writes its record under the kernel
build directory (`kernels/_build.build_dir()`), not under `artifacts/`.
"""
from __future__ import annotations

import argparse
import io
import os
import sys
import time
from contextlib import redirect_stdout


def _run(name, fn, *args):
    buf = io.StringIO()
    t0 = time.perf_counter()
    status = "ok"
    try:
        with redirect_stdout(buf):
            fn(*args)
    except Exception as e:  # noqa: BLE001 - one failing harness ends no run
        status = f"fail:{type(e).__name__}"
        buf.write(f"\nERROR {e}\n")
    dt_us = (time.perf_counter() - t0) * 1e6
    print(f"{name},{dt_us:.0f},{status}")
    return name, buf.getvalue()


def main(argv=None) -> None:
    from . import (fig3_delta, fig45_bounds, massdiff_speed,
                   table1_blocksize, table2_formats, table34_opcounts,
                   table6_permutations)
    from ..bench import kernel_bench
    from ..kernels import _build

    extra = list(sys.argv[1:] if argv is None else argv)
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device")
    device = dev.parse_known_args(extra)[0].device
    bench_args = (["--device", device] if device else []) + [
        "--out", os.path.join(_build.build_dir(), "BENCH_kernels_run.json")]
    jobs = [
        ("table34_opcounts", table34_opcounts.main, []),
        ("massdiff_speed", massdiff_speed.main, []),
        ("fig3_delta", fig3_delta.main, extra),
        ("fig45_bounds", fig45_bounds.main, extra),
        ("table1_blocksize_qronos", table1_blocksize.main, extra),
        ("table1_blocksize_rtn", table1_blocksize.main,
         ["--rounding", "rtn"] + extra),
        ("table6_permutations", table6_permutations.main, extra),
        ("table2_formats", table2_formats.main, extra),
        ("kernel_bench", kernel_bench.main, bench_args),
    ]
    print("name,us_per_call,derived")
    outputs = [_run(name, fn, args) for name, fn, args in jobs]
    print()
    for name, text in outputs:
        print(f"===== {name} =====")
        print(text)


if __name__ == "__main__":
    main()
