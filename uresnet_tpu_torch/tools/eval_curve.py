"""Evaluate a SERIES of checkpoints on one held-out file (port of
tools/eval_curve.py).

Training-curve validation: one Trainer is built and the tool loops
restore -> evaluate_dataset, printing one line per checkpoint: the
exactly-once dataset-global confusion the infer gate prints
(engine/evaluator.py ``evaluate_dataset`` — every event counted exactly
once, wrapped tail masked).

Usage:
    python -m uresnet_tpu_torch.tools.eval_curve configs/train_3d_192.yaml \\
        --input heldout.usef ckpt/step_00012000.npz ckpt/step_00024000.npz \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config", help="config file")
    p.add_argument("checkpoints", nargs="+",
                   help="checkpoint paths, evaluated in order")
    p.add_argument("--input", required=True, help="held-out USEF file")
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VALUE", help="config override (repeatable)")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default: cuda)")
    args = p.parse_args(argv)

    from uresnet_tpu_torch.config import load_config
    from uresnet_tpu_torch.engine.evaluator import evaluate_dataset
    from uresnet_tpu_torch.engine.trainer import Trainer

    cfg = load_config(args.config, args.override)
    # the held-out file replaces the configured data before the Trainer
    # exists, as cli/infer.py --metrics-only --input does
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(
            cfg.data, input_files=(args.input,), synthetic=False))
    trainer = Trainer(cfg, device=args.device)

    for ck in args.checkpoints:
        if not os.path.exists(ck):
            print(f"SKIP {ck}: no such file", flush=True)
            continue
        ts, step, _ = trainer.restore(ck)
        m = evaluate_dataset(trainer, ts)
        print(f"ckpt {ck} step {step} metrics:",
              {k: round(float(v), 5) for k, v in m.items()}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
