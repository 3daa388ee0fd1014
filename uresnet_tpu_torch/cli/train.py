"""Train entry point of the port (port of uresnet_tpu/cli/train.py).

    python -m uresnet_tpu_torch.cli.train CONFIG [KEY=value ...] \\
        [--resume] [--iterations N] [--device cuda] [--profile DIR]
    torchrun --nproc-per-node N -m uresnet_tpu_torch.cli.train CONFIG \\
        ... --distributed

A config file (YAML needs PyYAML; JSON and reference-style KEY-value files
do not) plus ``section.field=value`` or reference-style ``KEY=value``
overrides. Checkpoints are written in the JAX package's npz layout, so
either package resumes or serves them. ``--profile DIR`` trains the first
summary window only, inside a ``torch.profiler`` trace written to DIR
(engine/profiling.py), and exits 0.

``--distributed`` joins the process group of a ``torchrun`` launch (one
process per device, parallel/mesh.py): NCCL on ``cuda:LOCAL_RANK``, or
gloo with ``--device cpu``. The launch's processes form the config's
(data, spatial, model) mesh: ``parallel.spatial`` splits H (2D) or D (3D)
with halo exchanges, ``parallel.model`` the conv channels
(``parallel.data`` 0 takes the rest of the world). Without the torchrun environment it exits 2;
it never falls back to one process. Rank 0 alone writes logs,
checkpoints and the ``--profile`` trace.
"""

from __future__ import annotations

import argparse
import contextlib

from uresnet_tpu_torch.config import Config, apply_overrides, load_config
from uresnet_tpu_torch.engine.trainer import Trainer
from uresnet_tpu_torch.parallel import mesh


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
                   help="parallel training over the (data, spatial, model) "
                        "mesh of parallel.*, one process per device, "
                        "launched by torchrun (NCCL on cuda:LOCAL_RANK, "
                        "gloo with --device cpu)")
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

    overrides = list(args.overrides)
    if args.config and "=" in args.config:
        overrides.insert(0, args.config)  # bare KEY=value without a config file
        args.config = None
    cfg = (load_config(args.config, overrides) if args.config
           else apply_overrides(Config(), overrides))

    if not args.distributed:
        return _train(cfg, args, args.device)
    try:
        device = mesh.init_distributed(args.device)
    except RuntimeError as e:
        p.error(str(e))
    try:
        return _train(cfg, args, device)
    finally:
        mesh.shutdown()


def _train(cfg, args, device) -> int:
    trainer = Trainer(cfg, device=device)
    m = trainer.mesh
    print(f"device: {trainer.device}"
          + (f" rank: {m.rank} world: {m.world} mesh (data, spatial, model):"
             f" {m.data}x{m.spatial}x{m.model}" if m.group is not None
             else ""), flush=True)
    if args.profile:
        from uresnet_tpu_torch.engine.profiling import trace

        # rank 0 alone traces
        with (trace(args.profile, device=trainer.device) if m.leader
              else contextlib.nullcontext()):
            trainer.fit(iterations=min(args.iterations or cfg.train.summary_iter,
                                       cfg.train.summary_iter),
                        resume=args.resume)
        if m.leader:
            print(f"profile trace written to {args.profile}", flush=True)
        return 0
    _, metrics = trainer.fit(iterations=args.iterations, resume=args.resume)
    print("final:", {k: round(v, 5) for k, v in metrics.items()}, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
