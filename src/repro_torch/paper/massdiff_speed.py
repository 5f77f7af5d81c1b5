"""§6 claim: MassDiff calibrates permutations in under two minutes for
Llama3-8B. Times Algorithm 1 (a host loop over numpy) at the real
Llama3-8B geometry (d_ff = 14336, b = 32, 32 layers).

    PYTHONPATH=src python -m repro_torch.paper.massdiff_speed
"""
import time

import numpy as np

from ..core import massdiff as MD

D_FF, B, LAYERS = 14336, 32, 32


def run(layers: int = LAYERS) -> float:
    """Host seconds for `layers` MassDiff calibrations."""
    rng = np.random.default_rng(0)
    mass = np.abs(rng.laplace(size=(D_FF,))) * rng.uniform(0.5, 10, D_FF)
    t0 = time.perf_counter()
    for _ in range(layers):
        MD.massdiff(mass, B)
    return time.perf_counter() - t0


def main(argv=None):
    dt = run(LAYERS)
    print("# MassDiff calibration speed (Llama3-8B geometry)")
    print(f"layers,{LAYERS}")
    print(f"d_ff,{D_FF}")
    print(f"total_seconds,{dt:.2f}")
    print(f"under_two_minutes,{dt < 120}")


if __name__ == "__main__":
    main()
