"""A cell as ``BENCHMARK.json`` names it, with its files found by name.

    configs/<config>.json   the configuration as it is run (the program's
                            model, data, optim and train sections) and its
                            source; the plain reference (harness/
                            reference.py) reads the same file
    mixes/<traffic>.json    the traffic mix: which loop drives the program
                            and its parameters
    limits/<workload>.json  the limit of each number that decides correct
    metrics/<metric>.py     the reader of a per-layer metric, with any
                            data file of its own beside it

Later cells and metrics are new files and new entries; nothing here names
one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the whole configuration file
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def data(self) -> dict:
        return self.config["data"]

    @property
    def optim(self) -> dict:
        return self.config["optim"]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str) -> Cell:
    bench = load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(ROOT, conf["file"])),
        mix=_json(os.path.join(HERE, "mixes", f"{w['traffic']}.json")),
        limits=_json(os.path.join(HERE, "limits", f"{name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
