"""The readings that the limits of ``correct`` are set from, for one cell,
in one process (the benchmark's own runs do not run this):

    python3 perfbench/readings.py --workload <name> --seeds 1,2,3 \
        [--seconds S] [--control] [--fault]

For each seed, one JSON line:
  program   the numbers of a run of the cell (set-up, a window of
            ``--seconds``, the comparison with the reference);
  control   with ``--control``: the architecture's reference computed
            with float8 e4m3 operands (harness/quant.py ``fp8``), the
            precision below the configuration's bfloat16, put in the
            program's place and compared as the program is;
  fault     with ``--fault``, training cells: the numbers of a second run
            of the program with half of the batch left out of the step's
            forward and loss (harness/faults.py ``half_batch_train``).
A state left unchanged reads 1 in grad_gap and change_gap by definition
and needs no run.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from harness import (checks, faults, loops, quant, spec,  # noqa: E402
                     weights)


def train_control(cell, seed, device, ref):
    """The control's numbers, and their detail, against the reference
    ``ref`` of the same seed."""
    pool = loops._pool(cell, seed)
    params, _ = weights.split(cell, weights.make(cell, seed, device,
                                                 serve=False))
    views = [loops._view(cell, pool[i], cell.data["weight_mode"])
             for i in range(cell.mix["check_steps"])]
    alt = cell.arch.train_steps(cell.config, params, views, device=device,
                                quant=quant.fp8)
    return checks.train_numbers(alt, ref), checks.train_detail(alt, ref)


def ana_control(cell, seed, device):
    arch, conf = cell.arch, cell.config
    pool = loops._pool(cell, seed)
    leaves = weights.make(cell, seed, device, serve=True)
    arch.calibrate(conf, leaves, loops._view(cell, pool[0], "ones"),
                   device=device)
    params, stats = weights.split(cell, leaves)
    sample = loops._Sample(seed, cell.mix["check_batches"],
                           [int(b["npoints"].sum()) for b in pool])
    views = [loops._view(cell, pool[i], "ones") for i in sorted(sample.want)]
    ref = [arch.analyse(conf, params, stats, v, device=device) for v in views]
    alt = []
    for v in views:
        r = arch.analyse(conf, params, stats, v, device=device,
                         quant=quant.fp8)
        alt.append({"pscores": r["pscores"], "conf": r["conf"][None],
                    "correct_nonzero": r["correct_nonzero"],
                    "n_pixels": r["n_pixels"], "n_nonzero": r["n_nonzero"],
                    "origin": v["origin"]})
    return checks.ana_numbers(alt, ref, views)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", action="append", default=[],
                   help="section.key=json_value: run the cell's "
                        "configuration with this change (the look at a "
                        "number: e.g. model.compute_dtype=\"float32\")")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        section, name = key.split(".", 1)
        cell.config[section][name] = json.loads(value)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    train = cell.mix["loop"] == "train"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = loops.run(cell, seed, args.seconds, False, device, t0)
        row = {"seed": seed, "program": res["numbers"]}
        if train:
            row["detail"] = res["detail"]
            if args.control:
                row["control"], row["control_detail"] = train_control(
                    cell, seed, device, res["reference"])
        elif args.control:
            row["control"] = ana_control(cell, seed, device)
        del res
        loops._free(device)
        if train and args.fault:
            with faults.planted(faults.half_batch_train):
                row["fault"] = loops.run(cell, seed, args.seconds, False,
                                         device, time.perf_counter())["numbers"]
            loops._free(device)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
