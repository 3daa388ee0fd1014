"""Inference / analysis entry point of the port (port of
uresnet_tpu/cli/infer.py).

    python -m uresnet_tpu_torch.cli.infer CONFIG [KEY=value ...] \\
        [--checkpoint PATH] --input EVENTS.usef [--output scores.npz] \\
        [--format {npz,usef}] [--export {auto,dense,sparse}] [--tiled] \\
        [--readback-group K] [--device cuda]
    python -m uresnet_tpu_torch.cli.infer CONFIG [KEY=value ...] \\
        --metrics-only [--input EVENTS.usef]

Loads a checkpoint in the JAX npz layout (the latest in
``train.checkpoint_dir`` by default; params-only release files too) and
either writes the score export of ``--input`` (engine/evaluator.py
``run_inference``; streamed sparse export by default) or, with
``--metrics-only`` or without ``--input``, evaluates the configured dataset
— or the given ``--input`` file — exactly once (``evaluate_dataset``). A
YAML config needs PyYAML; JSON and reference-style KEY-value configs do
not.
"""

from __future__ import annotations

import argparse
import dataclasses

from uresnet_tpu_torch.config import Config, apply_overrides, load_config
from uresnet_tpu_torch.engine.checkpoint import (latest_checkpoint,
                                                 load_serving_state)
from uresnet_tpu_torch.engine.evaluator import evaluate_dataset, run_inference
from uresnet_tpu_torch.engine.trainer import Trainer
from uresnet_tpu_torch.models.convert import load_jax_params


def main(argv=None):
    p = argparse.ArgumentParser(description="U-ResNet batched inference "
                                            "(PyTorch/CUDA port)")
    p.add_argument("config", nargs="?", help="config file")
    p.add_argument("overrides", nargs="*", help="KEY=value overrides")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path (default: latest in checkpoint_dir)")
    p.add_argument("--input", default=None, help="USEF input file")
    p.add_argument("--output", default="scores.npz", help="score export path")
    p.add_argument("--format", default="npz", choices=("npz", "usef"),
                   help="score export format: sparse npz arrays, or "
                        "reference-style USEF score-map writeback (per-class "
                        "score planes readable by data/events.py)")
    p.add_argument("--metrics-only", action="store_true",
                   help="evaluate the dataset (or --input) exactly once "
                        "instead of exporting scores")
    p.add_argument("--export", default="auto",
                   choices=("auto", "dense", "sparse"),
                   help="score readback: 'sparse' gathers scores at the "
                        "charge points on the device; 'dense' reads back the "
                        "score volumes; 'auto' picks sparse")
    p.add_argument("--tiled", action="store_true",
                   help="full-coverage tiled inference: events larger than "
                        "data.image_size are covered by a grid of clamped "
                        "tiles so every charge point is scored; npz coords "
                        "are then original detector coordinates")
    p.add_argument("--readback-group", type=int, default=4, metavar="K",
                   help="accepted for parity with the JAX package, which "
                        "groups K batches' readbacks into one transfer; "
                        "here every batch's readback has its own CUDA "
                        "event, so K changes nothing")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args, extra = p.parse_known_args(argv)
    for tok in extra:
        if "=" not in tok or tok.startswith("-"):
            p.error(f"unrecognized argument: {tok}")
        args.overrides.append(tok)

    overrides = list(args.overrides)
    if args.config and "=" in args.config:
        overrides.insert(0, args.config)  # bare KEY=value without a config file
        args.config = None
    if args.config:
        cfg = load_config(args.config, overrides)
    else:
        cfg = apply_overrides(Config(), overrides)

    metrics_mode = args.metrics_only or not args.input
    if args.tiled and metrics_mode:
        p.error("--tiled is an export mode: use it with --input/--output, "
                "not --metrics-only")
    if args.tiled and args.export != "auto":
        # the tiled pass has one readback (per-point scores); ignoring an
        # explicit --export would give other semantics than asked for
        p.error("--tiled has its own (sparse per-point) readback; "
                "--export cannot be combined with it")
    if metrics_mode and args.input:
        # evaluate THE GIVEN file exactly once: the config names it before
        # the trainer is built
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, input_files=(args.input,), synthetic=False))

    path = (args.checkpoint or cfg.train.load_file
            or latest_checkpoint(cfg.train.checkpoint_dir))
    if not path:
        raise FileNotFoundError(
            f"no checkpoint in {cfg.train.checkpoint_dir!r}")
    trainer = Trainer(cfg, device=args.device)
    ts = trainer.init_state()
    # params and BN state only: training checkpoints and params-only
    # release files (bf16 manifest) both serve
    params, state, step = load_serving_state(path)
    load_jax_params(ts.model, params, state)
    print(f"restored step {step}", flush=True)

    if metrics_mode:
        m = evaluate_dataset(trainer, ts)
        print("metrics:", {k: float(v) for k, v in m.items()}, flush=True)
    else:
        m = run_inference(trainer, ts, args.input, args.output,
                          fmt=args.format, export=args.export,
                          tiled=args.tiled,
                          readback_group=args.readback_group)
        print(f"wrote {args.output}:", m, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
