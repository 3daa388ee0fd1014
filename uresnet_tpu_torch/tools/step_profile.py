"""Profile one process's train step against the same step in a
data-parallel launch of one rank (NCCL on one card).

Both trainers are built in this process from one config: the first before
the process group exists (no collective), the second after this process
joins a launch of one rank (``RANK`` 0, ``WORLD_SIZE`` 1, a free port on
127.0.0.1), so that its BN statistics, gradient bucket and loss take the
data-parallel path. Each steps on its loader's first batch with
``train_step_light``:

  * timed in turns (one process, DP, DP, one process), each turn the
    median of ``--reps`` steps by CUDA events after 3 warm-up steps;
  * traced for 3 steps each by ``torch.profiler``: per kernel name its
    launches and device ms per step, the device's busy ms (the union of
    the kernels' intervals), the wall ms per step and the idle share;
  * the kernels whose launches or device ms per step differ between the
    two, largest difference first.

    python -m uresnet_tpu_torch.tools.step_profile CONFIG [KEY=VALUE ...] \\
        [--reps N] [--out FILE.json]

It runs on ``cuda:0`` and needs one card. It uses only the package's
public Trainer and mesh calls, so the same file also profiles another
checkout of the package put first on ``PYTHONPATH`` (run it by its path).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import socket
import time

import numpy as np
import torch

WARMUP = 3
TRACED = 3


def _steps(tr):
    """A closure that runs one ``train_step_light`` of ``tr`` on its
    loader's first batch, carrying the state forward."""
    loader = tr.make_loader(train=True)
    loader.start()
    try:
        host = loader.next()
    finally:
        loader.stop()
        if hasattr(loader, "close"):
            loader.close()
    host.pop("cursor", None)
    batch = tr.device_batch(host)
    state = [tr.init_state()]

    def step():
        state[0], _ = tr.train_step_light(state[0], batch)

    return step


def _time_ms(step, reps):
    for _ in range(WARMUP):
        step()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _trace(step):
    """Kernels per step of ``TRACED`` traced steps: {name: [launches,
    device ms]}, the busy ms and the wall ms per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / TRACED
    kern = collections.defaultdict(lambda: [0.0, 0.0])
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t = (e.time_range.start, e.time_range.end)
        spans.append(t)
        kern[e.name][0] += 1.0 / TRACED
        kern[e.name][1] += (t[1] - t[0]) / 1e3 / TRACED
    busy, end = 0.0, -np.inf
    for a, b in sorted(spans):  # the union of the kernels' intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e3 * TRACED
    return {"kernels": dict(kern), "busy_ms": busy, "wall_ms": wall,
            "idle": max(0.0, 1.0 - busy / wall)}


def _join_launch_of_one():
    from uresnet_tpu_torch.parallel import mesh

    if "MASTER_PORT" not in os.environ:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            os.environ["MASTER_PORT"] = str(s.getsockname()[1])
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "127.0.0.1")):
        os.environ.setdefault(k, v)
    return mesh.init_distributed("cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("overrides", nargs="*")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import uresnet_tpu_torch
    from uresnet_tpu_torch import load_config
    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.parallel import mesh

    cfg = load_config(args.config, args.overrides)
    steps = {"one process": _steps(Trainer(cfg, device="cuda:0"))}
    dev = _join_launch_of_one()
    try:
        steps["DP world 1"] = _steps(Trainer(cfg, device=dev))
        turns = collections.defaultdict(list)
        for name in ("one process", "DP world 1", "DP world 1",
                     "one process"):
            turns[name].append(_time_ms(steps[name], args.reps))
        traces = {name: _trace(step) for name, step in steps.items()}
    finally:
        mesh.shutdown()
    a, b = traces["one process"], traces["DP world 1"]
    diff = []
    for k in set(a["kernels"]) | set(b["kernels"]):
        na, ta = a["kernels"].get(k, [0.0, 0.0])
        nb, tb = b["kernels"].get(k, [0.0, 0.0])
        if na != nb or abs(tb - ta) >= 0.05:
            diff.append({"kernel": k, "launches": [na, nb], "ms": [ta, tb]})
    diff.sort(key=lambda r: -abs(r["ms"][1] - r["ms"][0]))
    report = {"package": os.path.dirname(uresnet_tpu_torch.__file__),
              "card": torch.cuda.get_device_name(0),
              "turns_ms": dict(turns),
              "trace": {k: {kk: v for kk, v in t.items() if kk != "kernels"}
                        | {"launches": sum(n for n, _ in
                                           t["kernels"].values())}
                        for k, t in traces.items()},
              "differ": diff}
    print(f"package {report['package']} on {report['card']}")
    for name, ms in turns.items():
        print(f"{name}: train_step_light {ms} ms (in turns)")
    for name, t in report["trace"].items():
        print(f"{name} traced: wall {t['wall_ms']:.3f} ms/step, device busy "
              f"{t['busy_ms']:.3f}, idle {t['idle']:.4f}, "
              f"{t['launches']:.0f} kernel launches")
    print("kernels that differ (one process -> DP world 1), per step:")
    for r in diff[:25]:
        print(f"  {r['ms'][0]:9.3f} -> {r['ms'][1]:9.3f} ms, launches "
              f"{r['launches'][0]:.0f} -> {r['launches'][1]:.0f}  "
              f"{r['kernel'][:110]}")
    if args.out:
        report["kernels"] = {k: t["kernels"] for k, t in traces.items()}
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
