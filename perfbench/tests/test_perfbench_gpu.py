"""On the card, at each cell's own size: the program passes its limits and
the control (the reference in fp8) fails one, on three seeds. Run on a
machine with an H100:

    python3 -m pytest -q -m gpu perfbench/tests/test_perfbench_gpu.py
"""
import time

import pytest

from perfbench.harness import spec
from perfbench.harness.cell import run_cell

BENCH = spec.load_benchmark()
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_control_fails_where_the_program_passes(card, w, seed):
    out = run_cell(spec.config(BENCH, w["config"]), spec.traffic(w["traffic"]),
                   seed=seed, seconds=5.0, trace=False, device=card,
                   t_start=time.perf_counter(),
                   limits=spec.limits(w["name"]), control=True)
    assert out["correct"], out["checks"]
    lims = spec.limits(w["name"]).limit_of()
    print(w["name"], seed, "program", out["checks"], "control",
          out["check"]["control"])
    assert any(out["check"]["control"][k] > lim for k, lim in lims.items())
