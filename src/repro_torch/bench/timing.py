"""Timing and bounds on the card, shared by the benches and `chip_smoke.py`.

`time_ms` times eager calls by CUDA events, `device_ms` replays the calls
from a CUDA graph so the host's launch path is outside the measurement,
`n_copies` sizes the set of operand copies a timed loop rotates through so
that a call finds its large operands cold in L2, and `bound` gives the
least time the card could take for some bytes and operations. `host_ms` is
the host clock of a CPU run, never a device number. `device_record` names
what a run ran on.

The peaks are the published ones of one H100 SXM at its 700 W limit:
3.35 TB/s of device memory, 1979 TOP/s int8, 989 TFLOP/s bf16, 495 TFLOP/s
TF32 on the tensor cores, 67 TFLOP/s float32 outside the tensor cores.
"""
from __future__ import annotations

import math
import subprocess
import time

import torch

PEAK_BYTES_S = 3.35e12
PEAK_INT8_OPS_S = 1979e12
PEAK_BF16_FLOPS_S = 989e12
PEAK_TF32_FLOPS_S = 495e12
PEAK_F32_FLOPS_S = 67e12
L2_BYTES = 50 * 2 ** 20


def nvidia_smi_line() -> str:
    """The card's `name, power.limit` as `nvidia-smi` gives them; raises
    RuntimeError when `nvidia-smi` fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
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


def host_ms(fns, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call on the host clock: a CPU run's time,
    never a device number."""
    for i in range(warmup):
        fns[i % len(fns)]()
    t0 = time.perf_counter()
    for i in range(iters):
        fns[i % len(fns)]()
    return (time.perf_counter() - t0) * 1e3 / iters


def clock_ms(fns, iters: int, device: torch.device) -> float:
    """`time_ms` (CUDA events) on a card, `host_ms` on the CPU."""
    if device.type == "cuda":
        return time_ms(fns, iters)
    return host_ms(fns, iters)


def clock_name(device: torch.device) -> str:
    return "cuda_events" if device.type == "cuda" else "host"


def sync(device: torch.device):
    """Wait for the card's work; nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_device(name: str) -> torch.device:
    """The device a bench's `--device` names; exits when it names a card
    that is not there (no fallback to the CPU)."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu for a CPU run)")
    return torch.device(name)


def device_record(device: torch.device) -> dict:
    """What a run ran on: on a card its name, the number of cards and the
    `nvidia-smi` name and power limit; on the CPU `{"platform": "cpu"}`."""
    if device.type != "cuda":
        return {"platform": "cpu"}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi_line()}
