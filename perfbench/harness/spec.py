"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration (`configs` entry, whose
`file` is read) and a traffic mix (`perfbench/traffic/<traffic>.json`).
A configuration names its model family, `perfbench/families/<family>.py`:
the module that draws its weights, builds the program, reads back its
state, computes the check's numbers and counts a step's work.
Every metric is read by its own reader, `perfbench/metrics/<name>.py`,
whose `read(ctx)` returns the number or None where there is nothing to
read (the metric is then left out of the result line). A cell's limit of
correctness is `perfbench/limits/<cell>.json`.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from .traffic import Traffic

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent
FAMILIES = PERFBENCH / "families"


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> Traffic:
    with open(PERFBENCH / "traffic" / f"{name}.json") as f:
        return Traffic.from_dict(json.load(f))


def metrics_for(bench: dict, cell: str, per_layer: bool) -> list[dict]:
    """The metrics a cell reports: end-to-end ones in an untraced run,
    per-layer ones in a traced run; a metric with a `workloads` list only
    in the cells it names."""
    group = bench["per_layer"] if per_layer else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def _load(package: str, name: str, path: Path):
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{package}." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The `read` function of metric `name`."""
    return _load("metrics", name, PERFBENCH / "metrics" / f"{name}.py").read


def family(cfg: dict):
    """The module of the configuration's model family
    (`perfbench/families/<family>.py`)."""
    name = cfg.get("family")
    path = FAMILIES / f"{name}.py"
    if not isinstance(name, str) or not path.is_file():
        raise KeyError(f"configuration {cfg.get('name')!r} names the model "
                       f"family {name!r}, which has no module {path.name} "
                       "under perfbench/families")
    return _load("families", name, path)


def limits(cell: str):
    """A cell's limits of correctness (`perfbench/limits/<cell>.json`, with
    the readings they were set from), as `harness.check.Limits`."""
    from .check import Limits
    with open(PERFBENCH / "limits" / f"{cell}.json") as f:
        return Limits.from_dict(json.load(f))
