"""``python3 perfbench/run.py --workload W --seed N --seconds S --trace 0|1``

Runs one cell of BENCHMARK.json once on the card it is started on and
prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), device, with ``--trace 1`` the
breakdown, and last the numbers that decided ``correct`` beside their
limits, which also close standard error. A run without a card, or with
fewer cards than the cell asks for, or that finds JAX or the JAX package
loaded when its window has closed, prints no result and exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from harness import checks, imports, loops, spec
from harness.loops import log


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_note() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unreadable"


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool,
            device, t0: float) -> dict:
    """One run of ``cell``: the result object, with the check rows."""
    res = loops.run(cell, seed, seconds, traced, device, t0)
    correct, rows = checks.judge(res["numbers"], cell.limits)
    metrics = {}
    if traced:
        run = res["traced"]
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": res[m["name"]], "unit": m["unit"]}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips,
            "memory_peak_bytes": int(res["memory_peak_bytes"])}
    out = {"correct": correct, "attempted": res["attempted"], "failed": 0,
           "metrics": metrics, "device": info}
    if traced:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return out


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count() = {torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = execute(cell, args.seed, args.seconds, bool(args.trace), device, t0)
    found = imports.forbidden()
    if found:
        log(f"JAX or the JAX package is loaded: {found}")
        return 3
    log(f"card: {card_note()}; device memory peak "
        f"{out['device']['memory_peak_bytes']} bytes")
    for k, c in out["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0
