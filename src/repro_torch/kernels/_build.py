"""Builds the CUDA sources under `csrc/` into one shared library and loads it.

The kernels have a plain C interface (`extern "C" int <name>_launch(...)`
returning the `cudaGetLastError()` code), so they compile with `nvcc` alone,
without PyTorch's headers, in seconds. Each source is compiled to an object
file by its own `nvcc` process, all started together, then linked into

    <build dir>/libmixquant_kernels_<hash of the sources and headers>.so

and loaded with `ctypes`, every function's `argtypes` set so that pointers
are passed at full width. The build happens at first use, never at import.
The build directory is `$REPRO_TORCH_BUILD_DIR` if set, else `build/` at the
root of the source checkout (beside `src/`), else `build/` in the working
directory. A missing compiler, a failed compile or a failed load raises.
`ptxas_report` compiles the sources once more, into a directory of its own,
for `ptxas -v`'s per-kernel registers, spills and shared memory.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int

# function name -> argtypes (the stream is the last pointer of each)
SIGNATURES = {
    "block_hadamard_launch": [_P, _I, _P, _P] + [_I] * 8 + [_P],
    "hadamard_quant_launch": [_P, _I, _P, _P, _P, _P] + [_I] * 10 + [_P],
    "int4_matmul_launch": [_P] * 9 + [_I] * 11 + [_P],
    "paged_attention_launch": [_P, _I, _P, _P, _I] + [_P] * 13 + [_I] * 19 + [_P],
}

_LIB = None
BUILD_INFO = {"seconds": None, "library": None, "log": ""}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.h"))


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    root = Path(__file__).resolve().parents[3]
    if (root / "src").is_dir():
        return root / "build" / "repro_torch_kernels"
    return Path.cwd() / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set NVCC or put the CUDA toolkit on PATH)")


def _compile(srcs: list[Path], out_dir: Path, extra: list[str]):
    """Each source to an object file in `out_dir` by its own `nvcc`, all
    started together -> (object paths, joined log); raises if one fails."""
    nvcc = _nvcc()
    objs, procs = [], []
    for s in srcs:
        obj = out_dir / f"{s.stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", str(s), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        logs.append(f"== {s.name}\n{out}")
        if p.returncode != 0:
            failed.append(s.name)
    log = "\n".join(logs)
    if failed:
        for o in objs:
            o.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {failed}:\n" + log)
    return objs, log


def build() -> Path:
    """Compile (if this exact set of sources was not built yet) and return
    the path of the shared library."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    digest = hashlib.sha256()
    for s in srcs + headers():
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = build_dir()
    lib = out_dir / f"libmixquant_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        BUILD_INFO.update(seconds=0.0, library=str(lib))
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs, BUILD_INFO["log"] = _compile(srcs, out_dir, [])
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, library=str(lib))
    return lib


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def ptxas_report() -> tuple[list[dict], str]:
    """Compile every source with `-Xptxas -v` into a temporary directory
    under the build directory (the loaded library is left as it is) ->
    (one record per kernel: its name, demangled where the toolkit's
    `cu++filt` is there; registers, spill bytes, static shared memory; the
    raw log)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir, prefix="ptxas.") as tmp:
        _, log = _compile(sources(), Path(tmp), ["-Xptxas", "-v"])
    rows, cur, source = [], None, None
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:]
        elif (hit := _PTXAS_ENTRY.search(line)):
            cur = {"source": source, "function": hit.group(1)}
            rows.append(cur)
        elif cur is not None and (hit := _PTXAS_SPILL.search(line)):
            cur.update(spill_stores=int(hit.group(1)), spill_loads=int(hit.group(2)))
        elif cur is not None and (hit := _PTXAS_USED.search(line)):
            cur.update(registers=int(hit.group(1)),
                       smem_bytes=int(hit.group(2) or 0))
    filt = Path(_nvcc()).with_name("cu++filt")
    if rows and filt.exists():
        names = subprocess.run([str(filt)], input="\n".join(r["function"] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(rows):
            for r, name in zip(rows, names):
                r["function"] = name
    return rows, log


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def stream_ptr(device) -> int:
    """Raw handle of PyTorch's current stream, for a launch on `device`. A
    kernel launches on the current CUDA device, so a tensor that lies on
    another card is refused rather than launched in the wrong context."""
    import torch
    if device.index is not None and device.index != torch.cuda.current_device():
        raise RuntimeError(
            f"tensor on {device} but the current CUDA device is "
            f"cuda:{torch.cuda.current_device()}; wrap the call in "
            "`with torch.cuda.device(...)`")
    return torch.cuda.current_stream().cuda_stream


def check(code: int, what: str):
    """Raise on a non-zero CUDA error code returned by a launch function."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {code}")
