"""Shared pytest configuration.

NOTE: no XLA_FLAGS / device-count manipulation here — smoke tests and
benches must see the real single CPU device; only launch/dryrun.py (and the
subprocess in test_distributed.py) request placeholder device counts.
"""
import sys
from pathlib import Path

# Make `repro` importable from a plain checkout (no PYTHONPATH=src and no
# `pip install -e .` needed) — a site-installed copy still wins if present.
_SRC = str(Path(__file__).resolve().parent.parent / "src")
if _SRC not in sys.path:
    sys.path.append(_SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (subprocess compile/execute)")
    config.addinivalue_line(
        "markers", "chaos: fault-injection robustness test (engine "
        "preemption/cancel/deadline invariants under a FaultPlan)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device and nvcc (the PyTorch/CUDA "
        "port's kernels); skips where there is none")
