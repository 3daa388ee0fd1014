"""A cell as ``BENCHMARK.json`` names it, with its files found by name.

    configs/<config>.json   the configuration as it is run (the program's
                            model, data, optim and train sections), its
                            source, and its architecture (``"arch"``); the
                            plain reference reads the same file
    archs/<arch>.py         what the harness knows of an architecture: its
                            leaves, its plain reference's view of a batch,
                            calibration, steps and analysis, and its FLOPs
                            (the hooks are listed in archs/uresnet.py)
    mixes/<traffic>.json    the traffic mix: which loop drives the program
                            and its parameters
    limits/<workload>.json  the limit of each number that decides correct
    metrics/<metric>.py     the reader of a per-layer metric, with any
                            data file of its own beside it

Later cells, metrics and architectures are new files and new entries;
nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
ARCHS = os.path.join(HERE, "archs")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the whole configuration file
    arch: ModuleType      # archs/<config's arch>.py
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
    path = os.path.join(
        ROOT, {c["name"]: c for c in bench["configs"]}[w["config"]]["file"])
    config = _json(path)
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        arch=arch(config.get("arch"), path),
        mix=_json(os.path.join(HERE, "mixes", f"{w['traffic']}.json")),
        limits=_json(os.path.join(HERE, "limits", f"{name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def _load(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def arch(name, config_file: str) -> ModuleType:
    """``archs/<name>.py``, the architecture that ``config_file`` names."""
    known = sorted(f[:-3] for f in os.listdir(ARCHS) if f.endswith(".py"))
    if name not in known:
        raise ValueError(f"{config_file}: \"arch\" is {name!r}, which names "
                         f"no module of {ARCHS}: {known}")
    return _load(os.path.join(ARCHS, f"{name}.py"), "perfbench_arch_" + name)


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load(os.path.join(HERE, "metrics", f"{name}.py"),
                 "perfbench_metric_" + name.replace(".", "_")).read
