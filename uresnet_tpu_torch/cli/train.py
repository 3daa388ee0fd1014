"""Train entry point of the port (port of uresnet_tpu/cli/train.py).

    python -m uresnet_tpu_torch.cli.train CONFIG [KEY=value ...] \\
        [--resume] [--iterations N] [--device cuda] [--profile DIR]

A config file (YAML needs PyYAML; JSON and reference-style KEY-value files
do not) plus ``section.field=value`` or reference-style ``KEY=value``
overrides. Checkpoints are written in the JAX package's npz layout, so
either package resumes or serves them. ``--profile DIR`` trains the first
summary window only, inside a ``torch.profiler`` trace written to DIR
(engine/profiling.py), and exits 0.
"""

from __future__ import annotations

import argparse

from uresnet_tpu_torch.config import Config, apply_overrides, load_config
from uresnet_tpu_torch.engine.trainer import Trainer


def main(argv=None):
    p = argparse.ArgumentParser(description="Train U-ResNet (PyTorch/CUDA port)")
    p.add_argument("config", nargs="?", help="config file (yaml/json/KEY-value)")
    p.add_argument("overrides", nargs="*",
                   help="KEY=value (reference-style) or section.field=value")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in checkpoint_dir")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda; the CPU "
                        "only when asked with --device cpu)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process training (not ported yet)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the first "
                        "summary window into DIR")
    # KEY=value overrides may come after flags: argparse cannot interleave
    # them with positionals, so unknown KEY=value tokens are overrides
    args, extra = p.parse_known_args(argv)
    for tok in extra:
        if "=" not in tok or tok.startswith("-"):
            p.error(f"unrecognized argument: {tok}")
        args.overrides.append(tok)
    if args.distributed:
        p.error("--distributed is not ported yet (ROADMAP.md, modules to "
                "port)")

    overrides = list(args.overrides)
    if args.config and "=" in args.config:
        overrides.insert(0, args.config)  # bare KEY=value without a config file
        args.config = None
    cfg = (load_config(args.config, overrides) if args.config
           else apply_overrides(Config(), overrides))

    trainer = Trainer(cfg, device=args.device)
    print(f"device: {trainer.device}", flush=True)
    if args.profile:
        from uresnet_tpu_torch.engine.profiling import trace

        with trace(args.profile, device=trainer.device):
            trainer.fit(iterations=min(args.iterations or cfg.train.summary_iter,
                                       cfg.train.summary_iter),
                        resume=args.resume)
        print(f"profile trace written to {args.profile}", flush=True)
        return 0
    _, metrics = trainer.fit(iterations=args.iterations, resume=args.resume)
    print("final:", {k: round(v, 5) for k, v in metrics.items()}, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
