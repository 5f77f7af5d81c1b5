"""Every configuration, cell and metric of BENCHMARK.json is found by name
and loads, and the file keeps to the benchmark's contract."""
import json
import re

import pytest

from perfbench.harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
    cfg = spec.config(BENCH, c["name"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    for k in c["reduced"]:
        assert not k.endswith(("_dim", "_rank", "_size")), k
    m = spec.family(cfg).dims(cfg)
    assert m["d_model"] == m["n_heads"] * m["head_dim"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and w["chips"] == 1
    assert 1 <= len(w["why"]) <= 200
    spec.config(BENCH, w["config"])
    t = spec.traffic(w["traffic"])
    assert t.clients >= 1
    lim = spec.limits(w["name"])
    n_layers = spec.config(BENCH, w["config"])["num_hidden_layers"]
    assert lim.kv[0][:3] == ("kv_mismatch.layer0", 0, 0.5)
    assert all(0 <= l < n_layers for _, l, _, _ in lim.kv)
    assert all(v > 0 for v in lim.limit_of().values())
    e2e = spec.metrics_for(BENCH, w["name"], per_layer=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert spec.metrics_for(BENCH, w["name"], per_layer=True)


METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_loads(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(spec.reader(m["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        e2e = {x["name"] for x in BENCH["end_to_end"]}
        assert m["moves"] in e2e and m["layer"]
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
