"""Inference entry point of the port (port of uresnet_tpu/cli/infer.py).

    python -m uresnet_tpu_torch.cli.infer CONFIG [KEY=value ...] \\
        [--checkpoint PATH] --input EVENTS.usef [--output scores.npz] \\
        [--device cuda]

Loads a checkpoint in the JAX npz layout (the latest in
``train.checkpoint_dir`` by default), folds BN, and writes per-pixel
softmax scores at the charge pixels of every event to an npz
(engine/evaluator.py). A YAML config needs PyYAML; JSON and reference-style
KEY-value configs do not.
"""

from __future__ import annotations

import argparse

import torch

from uresnet_tpu_torch.config import Config, apply_overrides, load_config
from uresnet_tpu_torch.engine.checkpoint import (latest_checkpoint,
                                                 load_serving_state)
from uresnet_tpu_torch.engine.evaluator import run_inference
from uresnet_tpu_torch.engine.export import build_serving_fn
from uresnet_tpu_torch.models.convert import load_jax_params
from uresnet_tpu_torch.models.uresnet import UResNet


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
                   help="score export format (only npz is ported)")
    p.add_argument("--metrics-only", action="store_true",
                   help="dataset evaluation (not ported)")
    p.add_argument("--export", default="auto",
                   choices=("auto", "dense", "sparse"),
                   help="score readback: 'auto' means 'dense' in the port "
                        "(sparse is not ported)")
    p.add_argument("--tiled", action="store_true",
                   help="full-coverage tiled inference (not ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args, extra = p.parse_known_args(argv)
    for tok in extra:
        if "=" not in tok or tok.startswith("-"):
            p.error(f"unrecognized argument: {tok}")
        args.overrides.append(tok)

    roadmap = "is not ported yet (ROADMAP.md, modules to port)"
    if args.metrics_only or not args.input:
        p.error(f"--metrics-only / dataset evaluation {roadmap}: "
                "pass --input EVENTS.usef")
    if args.tiled:
        p.error(f"--tiled {roadmap}")
    if args.export == "sparse":
        p.error(f"--export sparse {roadmap}; use --export dense")
    if args.format == "usef":
        p.error(f"--format usef {roadmap}; use --format npz")

    overrides = list(args.overrides)
    if args.config and "=" in args.config:
        overrides.insert(0, args.config)  # bare KEY=value without a config file
        args.config = None
    if args.config:
        cfg = load_config(args.config, overrides)
    else:
        cfg = apply_overrides(Config(), overrides)

    device = torch.device(args.device)
    path = (args.checkpoint or cfg.train.load_file
            or latest_checkpoint(cfg.train.checkpoint_dir))
    if not path:
        raise FileNotFoundError(
            f"no checkpoint in {cfg.train.checkpoint_dir!r}")
    model = UResNet(cfg.model, generator=torch.Generator().manual_seed(
        cfg.train.seed))
    params, state, step = load_serving_state(path)
    load_jax_params(model, params, state)
    model.to(device)
    print(f"restored step {step}", flush=True)

    serve = build_serving_fn(cfg, model)
    m = run_inference(cfg, serve, args.input, args.output, device=device)
    print(f"wrote {args.output}:", m, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
