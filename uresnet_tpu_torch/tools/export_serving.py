"""Export a trained checkpoint as a serving artifact (.uxm) of the port
(port of tools/export_serving.py).

One file = the ``torch.export`` program of the serving forward (BN folded
+ softmax, the fused conv op at every eligible conv, weights as constants)
+ JSON metadata (architecture, preprocessing constants) — see
uresnet_tpu_torch/engine/export.py for the format and contract.

    python -m uresnet_tpu_torch.tools.export_serving \\
        --config configs/train_2d_512.yaml --output model.uxm --batch 32 \\
        [--checkpoint ckpt/step_XXXX.npz] [--devices cuda,cpu] \\
        [--device cuda] [--selftest]

The checkpoint is restored through the port's Trainer on ``--device``
(default cuda), where the program is traced. ``--selftest`` loads the
written file on the same device and holds its scores to the in-process
serving forward (``build_serving_fn``) before reporting OK.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path (default: latest in checkpoint_dir)")
    p.add_argument("--output", required=True, help=".uxm output path")
    p.add_argument("--batch", type=int, default=None,
                   help="serving batch size (default: data.batch_size)")
    p.add_argument("--image-size", type=int, default=None,
                   help="serving spatial size (default: data.image_size)")
    p.add_argument("--devices", default="cuda,cpu",
                   help="comma list of torch device types the artifact may "
                        "be loaded on")
    p.add_argument("--device", default="cuda",
                   help="torch device to restore, trace and self-test on "
                        "(default: cuda)")
    p.add_argument("--selftest", action="store_true",
                   help="reload the artifact and compare vs the serving "
                        "forward")
    p.add_argument("override", nargs="*", default=[],
                   help="config overrides (a.b=c or KEY=value)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from uresnet_tpu_torch.config import ParallelConfig, load_config
    from uresnet_tpu_torch.engine.export import (build_serving_fn,
                                                 export_serving, load_serving,
                                                 save_serving)
    from uresnet_tpu_torch.engine.trainer import Trainer

    cfg = load_config(args.config, args.override)
    # export is single-device by construction: restore at parallel 1
    # whatever cfg.parallel says
    cfg = dataclasses.replace(cfg, parallel=ParallelConfig(data=1))
    trainer = Trainer(cfg, device=args.device)
    ts, step, _ = trainer.restore(args.checkpoint)
    print(f"restored step {step}", flush=True)

    payload, meta = export_serving(
        cfg, ts.model, batch_size=args.batch, image_size=args.image_size,
        platforms=tuple(s.strip() for s in args.devices.split(",")
                        if s.strip()),
        step=step)
    save_serving(args.output, payload, meta)
    print(f"wrote {args.output}: {os.path.getsize(args.output)} bytes, "
          f"input {meta['input_shape']} -> softmax {meta['output_shape']}, "
          f"devices {meta['platforms']}", flush=True)

    if args.selftest:
        fn, meta2 = load_serving(args.output, device=args.device)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.random(meta2["input_shape"]).astype(np.float32))
        got = fn(x).cpu().numpy()
        want = build_serving_fn(cfg, ts.model)(
            x.to(trainer.device)).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        print(f"selftest OK: max |Δ| = {np.abs(got - want).max():.3g}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
