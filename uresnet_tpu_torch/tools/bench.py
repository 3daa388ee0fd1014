"""Benchmark of the port (port of bench.py) — prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Primary metric: images/sec/card of the 2D U-ResNet training step
(``Trainer.train_step_light``) at 512x512 (pixel-weighted softmax CE, the
flagship depth-5/base-16 model, bf16 compute, packed as the flagship
config trains), on one seeded dense batch placed with
``Trainer.device_batch``. ``--infer`` times the unfolded eval forward
(``Trainer.forward``) instead; ``--dims 3`` the 3D U-ResNet at 192^3
(BASELINE config 4: batch 1, depth 4, f32 head, remat off at batch 1 and
``block`` from batch 2). The metric names, units and keys are bench.py's.

Timing: N and 2N chained calls, each ending in a host readback of the loss
(or of one score), median of 3 of each, and the difference over N: the
launch and readback overhead cancels, leaving the steady-state step.
bench.py also times K steps fused into one XLA executable (``lax.scan``)
and reports the faster of the two; the port has no such executable (its
``train.steps_per_dispatch`` runs K plain steps), so the dispatched rate
is the one reported.

``useful_tflops`` counts the canonical (unpacked) model's MACs
(``uresnet_forward_macs``): x3 for a train step (forward, dW, dX), x4
under remat (the forward runs again). ``raw_tflops`` counts what one more
step really issues, under ``torch.utils.flop_counter.FlopCounterMode``
(convolutions forward and backward, matmuls — the packed layout's
weight-packing matmuls and structural zeros included). ``vs_baseline``
divides by ``benchmarks/baseline_cpu.json``'s
``train_images_per_sec_{size}`` (0.0 where it has no such key).

Usage:
    python -m uresnet_tpu_torch.tools.bench              # 512^2 train, card
    python -m uresnet_tpu_torch.tools.bench --infer      # eval forward
    python -m uresnet_tpu_torch.tools.bench --dims 3     # 192^3 train
    python -m uresnet_tpu_torch.tools.bench --quick --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def conv_macs(s_out, k, cin, cout, dims):
    return (s_out ** dims) * (k ** dims) * cin * cout


def uresnet_forward_macs(*, size, batch, dims, depth, base, blocks=2,
                         num_class=3, in_ch=1, final_kernel=3):
    """Canonical forward MACs per batch (models/uresnet.py structure);
    transposed convs counted input-centric (every input pixel k^dims
    taps)."""
    total = conv_macs(size, 3, in_ch, base, dims)                    # stem
    for lvl in range(depth):
        s = size >> lvl
        f = base << lvl
        total += blocks * 2 * conv_macs(s, 3, f, f, dims)            # enc
        total += conv_macs(s >> 1, 3, f, 2 * f, dims)                # down
    sb = size >> depth
    fb = base << depth
    total += blocks * 2 * conv_macs(sb, 3, fb, fb, dims)             # mid
    for lvl in reversed(range(depth)):
        s = size >> lvl
        f = base << lvl
        total += conv_macs(s >> 1, 3, 2 * f, f, dims)                # up
        # dec block 0: conv(2f->f) + conv(f->f) + 1x1 proj(2f->f)
        total += conv_macs(s, 3, 2 * f, f, dims)
        total += conv_macs(s, 3, f, f, dims)
        total += conv_macs(s, 1, 2 * f, f, dims)
        total += (blocks - 1) * 2 * conv_macs(s, 3, f, f, dims)      # dec 1..
    total += conv_macs(size, final_kernel, base, num_class, dims)    # head
    return total * batch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--no-pack", action="store_true",
                   help="disable the space-to-depth packed layout")
    p.add_argument("--no-pack-extra-h", action="store_true",
                   help="disable the resident H-pack")
    p.add_argument("--remat", default=None,
                   help="remat mode: false|level|block (default: block "
                        "for 3D from batch 2, off otherwise)")
    p.add_argument("--base-filters", type=int, default=16)
    p.add_argument("--dtype", default=None,
                   help="compute dtype override (default: bfloat16 on the "
                        "card, float32 on the CPU)")
    p.add_argument("--head-dtype", default=None,
                   help="logits-conv dtype (default: float32 for 3D, the "
                        "compute dtype for 2D)")
    p.add_argument("--pack-threshold", type=int, default=None,
                   help="pack levels with channels < threshold (default 64)")
    p.add_argument("--dims", type=int, default=2, choices=(2, 3),
                   help="3 = 3D U-ResNet on volumes (BASELINE config 4)")
    p.add_argument("--infer", action="store_true",
                   help="benchmark the inference forward instead of training")
    p.add_argument("--freeze", default=None,
                   help="comma-separated optim.freeze patterns (frozen "
                        "leaves get no weight gradient)")
    p.add_argument("--device", default="cuda",
                   help="torch device to benchmark on (default: cuda)")
    return p.parse_args(argv)


def bench_config(args, on_card: bool):
    """(config, steps) of bench.py's defaults, with the card in the TPU's
    place: bf16 and batch 32 at 512^2 in 2D on the card, float32 and batch
    2 elsewhere; --quick 128^2 at batch 4 (3D: 32^3) and at most 5 steps."""
    from uresnet_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                          OptimConfig, TrainConfig)

    if args.dims == 3:
        size = args.size or (32 if args.quick else 192)
        batch = args.batch or 1
        depth = 4
    else:
        size = args.size or (128 if args.quick else 512)
        batch = args.batch or (4 if args.quick else (32 if on_card else 2))
        depth = 5
    steps = args.steps if not args.quick else min(args.steps, 5)
    if args.remat is None:
        remat = ("block" if batch >= 2 else False) if args.dims == 3 else False
    else:
        remat = {"false": False, "true": True}.get(args.remat.lower(),
                                                   args.remat)
    cfg = Config(
        model=ModelConfig(dims=args.dims, num_class=3,
                          base_filters=args.base_filters, depth=depth,
                          compute_dtype=args.dtype or
                          ("bfloat16" if on_card else "float32"),
                          head_dtype=(args.head_dtype if args.head_dtype
                                      is not None else
                                      ("float32" if args.dims == 3 else "")),
                          pack=not args.no_pack,
                          pack_extra_h=not args.no_pack_extra_h,
                          **({"pack_threshold": args.pack_threshold}
                             if args.pack_threshold is not None else {}),
                          remat=remat),
        data=DataConfig(image_size=size, batch_size=batch, planes=(0,)),
        optim=OptimConfig(lr=1e-3,
                          freeze=tuple(args.freeze.split(","))
                          if args.freeze else ()),
        train=TrainConfig(seed=0),
    )
    return cfg, steps


def raw_flops_of(fn):
    """FLOPs that one call of ``fn`` issues, by torch's flop counter."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def median_difference(run, steps):
    """Seconds per call: the medians of 3 runs of ``steps`` and of
    ``2 * steps`` chained calls, their difference over ``steps``."""
    t_n, t_2n = [], []
    for _ in range(3):
        t_n.append(run(steps))
        t_2n.append(run(2 * steps))
    dt = max(statistics.median(t_2n) - statistics.median(t_n), 1e-9)
    return dt / steps


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from uresnet_tpu_torch.engine.trainer import Trainer

    device = torch.device(args.device)
    cfg, steps = bench_config(args, on_card=device.type == "cuda")
    size, batch, depth = (cfg.data.image_size, cfg.data.batch_size,
                          cfg.model.depth)
    trainer = Trainer(cfg, device=device)
    ts = trainer.init_state()

    rng = np.random.default_rng(0)
    sp = (size,) * args.dims
    batch_np = {
        "data": (rng.random((batch,) + sp + (1,)) *
                 (rng.random((batch,) + sp + (1,)) > 0.95)).astype(np.float32),
        "label": rng.integers(0, 3, (batch,) + sp).astype(np.int32),
        "weight": np.ones((batch,) + sp, np.float32),
    }
    dev_batch = trainer.device_batch(batch_np)

    fwd_flops = 2 * uresnet_forward_macs(size=size, batch=batch,
                                         dims=args.dims, depth=depth,
                                         base=args.base_filters)

    if args.infer:
        def run_fwd(k):
            s = None
            t0 = time.perf_counter()
            for _ in range(k):
                s = trainer.forward(ts, dev_batch["data"])
            float(s[(0,) * s.dim()])  # host sync
            return time.perf_counter() - t0

        run_fwd(1)
        run_fwd(2)
        per_fwd = median_difference(run_fwd, steps)
        raw = raw_flops_of(lambda: trainer.forward(ts, dev_batch["data"]))
        print(json.dumps({
            "metric": f"infer_images_per_sec_per_chip_{size}_{args.dims}d",
            "value": round(batch / per_fwd, 3),
            "unit": "images/sec/chip",
            "vs_baseline": 0.0,
            "useful_tflops": round(fwd_flops / per_fwd / 1e12, 2),
            **({"raw_tflops": round(raw / per_fwd / 1e12, 2)}
               if raw else {}),
        }))
        return 0

    state = [ts]

    def run_chain(k):
        t0 = time.perf_counter()
        m = None
        for _ in range(k):
            state[0], m = trainer.train_step_light(state[0], dev_batch)
        float(m["loss"])  # host sync
        return time.perf_counter() - t0

    run_chain(1)
    run_chain(2)
    per_step = median_difference(run_chain, steps)
    images_per_sec = batch / per_step

    vs_baseline = None
    baseline_path = os.path.join(REPO, "benchmarks", "baseline_cpu.json")
    if os.path.exists(baseline_path):
        with open(baseline_path) as f:
            base = json.load(f)
        key = f"train_images_per_sec_{size}"
        if key in base and base[key] > 0:
            vs_baseline = images_per_sec / base[key]

    tag = "_freeze" if args.freeze else ""
    useful = fwd_flops * (4 if cfg.model.remat else 3)
    raw = raw_flops_of(lambda: run_chain(1))
    print(json.dumps({
        "metric": f"train_images_per_sec_per_chip_{size}x{size}_{args.dims}d{tag}",
        "value": round(images_per_sec, 3),
        "unit": "images/sec/chip",
        "vs_baseline": round(vs_baseline, 3) if vs_baseline else 0.0,
        "useful_tflops": round(useful / per_step / 1e12, 2),
        **({"raw_tflops": round(raw / per_step / 1e12, 2)} if raw else {}),
        "baseline_note": ("denominator is the repo's measured 1-core CPU-JAX "
                          "reference-equivalent (benchmarks/baseline_cpu.json;"
                          " the reference publishes no numbers)"),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
