"""Run one cell of the benchmark of `repro_torch` (the PyTorch/CUDA port).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. The last line
of standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its per-layer
metrics), `device`, with `--trace 1` a `breakdown`, and last `checks`, each
number the correctness check compared beside its limit; the same checks are
the last lines of standard error.

Exits non-zero and prints no result without a CUDA device, with fewer
devices than the cell asks for, or when JAX or the JAX package was loaded.
Kernel builds and caches live in `.perfbench_cache/` at the checkout's
root, so only the first run of a checkout builds.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _env():
    # one intra-op thread: the host's share of a step is the program's
    # dispatch, which it runs on one thread; idle pool threads only add
    # jitter (same seed: 5060-5454 prompt tokens/s with the default pool,
    # 5350-5439 with one thread, H100 host of 8 cores)
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    _env()
    try:
        import torch
        from perfbench.harness import spec
        from perfbench.harness.cell import run_cell
        from perfbench.harness.trace import breakdown
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import the program or the harness: {e}")
    torch.set_num_threads(1)
    try:
        bench = spec.load_benchmark()
        cell = spec.workload(bench, args.workload)
        cfg = spec.config(bench, cell["config"])
        spec.family(cfg)
        traffic = spec.traffic(cell["traffic"])
        limits = spec.limits(cell["name"])
    except (OSError, KeyError, ValueError) as e:
        fail(f"cannot read the cell {args.workload!r}: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device is available", 3)
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"the cell needs {cell['chips']} devices, "
             f"{torch.cuda.device_count()} are available", 3)

    out = run_cell(cfg, traffic, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda",
                   t_start=T_START, limits=limits)
    ctx = out["ctx"]
    metrics = {}
    for m in spec.metrics_for(bench, cell["name"], bool(args.trace)):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": out["peak"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace and ctx.trace:
        device["busy_s"] = ctx.trace["busy_s"]
        device["window_s"] = ctx.trace["window_s"]
        result["breakdown"] = breakdown(ctx.trace)
    result["checks"] = out["checks"]

    loaded = forbidden_modules()
    if loaded:
        fail(f"modules of JAX or the JAX package were loaded: {loaded}", 4)
    print(f"samples: itl gaps {len(ctx.itls())}, first tokens "
          f"{len(ctx.ttfts())}, window tokens {ctx.tokens_in_window()}, "
          f"steps {len(ctx.records)}, cached positions checked "
          f"{out['check']['positions']}", flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
