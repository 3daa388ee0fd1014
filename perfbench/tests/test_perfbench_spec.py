"""BENCHMARK.json and the files the harness finds by name."""

import json
import os

import pytest

from harness import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    c = spec.cell(name)
    assert c.mix["loop"] in ("train", "ana")
    assert {"model", "data", "optim", "train"} <= set(c.config)
    assert c.limits, "every number that decides correct has a limit"
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_benchmark_names_and_files():
    root = spec.ROOT
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        assert os.path.isfile(os.path.join(root, c["file"]))
        assert c["reduced"] == []
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                              cells))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.cell("no_such_cell")
