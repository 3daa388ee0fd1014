"""Train entry point of the port (port of uresnet_tpu/cli/train.py).

    python -m uresnet_tpu_torch.cli.train CONFIG [KEY=value ...] \\
        [--resume] [--iterations N] [--device cuda]

A config file (YAML needs PyYAML; JSON and reference-style KEY-value files
do not) plus ``section.field=value`` or reference-style ``KEY=value``
overrides. Checkpoints are written in the JAX package's npz layout, so
either package resumes or serves them.
"""

from __future__ import annotations

import argparse

from uresnet_tpu.config import Config, apply_overrides, load_config
from uresnet_tpu_torch.engine.trainer import Trainer


def main(argv=None):
    p = argparse.ArgumentParser(description="Train U-ResNet (PyTorch/CUDA port)")
    p.add_argument("config", nargs="?", help="config file (yaml/json/KEY-value)")
    p.add_argument("overrides", nargs="*",
                   help="KEY=value (reference-style) or section.field=value")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in checkpoint_dir")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda when available, else cpu)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process training (not ported yet)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="profiler trace of the first summary window "
                        "(not ported yet)")
    # KEY=value overrides may come after flags: argparse cannot interleave
    # them with positionals, so unknown KEY=value tokens are overrides
    args, extra = p.parse_known_args(argv)
    for tok in extra:
        if "=" not in tok or tok.startswith("-"):
            p.error(f"unrecognized argument: {tok}")
        args.overrides.append(tok)
    for flag, on in (("--distributed", args.distributed),
                     ("--profile", args.profile)):
        if on:
            p.error(f"{flag} is not ported yet (ROADMAP.md, modules to port)")

    overrides = list(args.overrides)
    if args.config and "=" in args.config:
        overrides.insert(0, args.config)  # bare KEY=value without a config file
        args.config = None
    cfg = (load_config(args.config, overrides) if args.config
           else apply_overrides(Config(), overrides))

    trainer = Trainer(cfg, device=args.device)
    print(f"device: {trainer.device}", flush=True)
    _, metrics = trainer.fit(iterations=args.iterations, resume=args.resume)
    print("final:", {k: round(v, 5) for k, v in metrics.items()}, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
