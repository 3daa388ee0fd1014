"""Event display: input charge vs truth labels vs predicted labels as PNG
(port of tools/event_display.py).

The reference's de-facto validation is visual inspection of example
segmentations. This tool restores a checkpoint through the port's Trainer,
densifies one event of a USEF file on the host (``weight_mode="ones"``),
runs the unfolded eval forward (``Trainer.forward``) and draws charge,
truth and prediction: three panels for 2D, a 3x3 grid of max-charge
projections (one row per axis) for 3D.

Usage:
    python -m uresnet_tpu_torch.tools.event_display <config> \\
        --input events.usef [--event 0] [--plane 0] [--out display.png] \\
        [--checkpoint PATH] [--device cuda]

It needs matplotlib, which is imported only when a display is drawn.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np


def predict(cfg, input_file: str, event: int, plane: int,
            checkpoint: Optional[str] = None, device="cuda"):
    """(data, label, pred, scores, step) of one event's plane: the charge
    (*S), the truth (*S), the argmax of the scores (*S), the softmax scores
    (*S, num_class) as numpy, and the restored checkpoint's step."""
    from uresnet_tpu_torch.config import ParallelConfig
    from uresnet_tpu_torch.data import events as ev
    from uresnet_tpu_torch.data.pipeline import densify_batch
    from uresnet_tpu_torch.engine.trainer import Trainer

    # one device whatever cfg.parallel says, as the JAX tool's make_mesh(1)
    trainer = Trainer(dataclasses.replace(cfg, parallel=ParallelConfig(data=1)),
                      device=device)
    ts, step, _ = trainer.restore(checkpoint)
    batch = densify_batch(ev.read_events(input_file, [event]),
                          image_size=cfg.data.image_size, planes=(plane,),
                          normalize_scale=cfg.data.normalize_scale,
                          normalize_clip=cfg.data.normalize_clip,
                          weight_mode="ones",
                          num_class=cfg.model.num_class)
    scores = trainer.forward(ts, batch["data"])[0].cpu().numpy()
    return (batch["data"][0, ..., 0], batch["label"][0], scores.argmax(-1),
            scores, step)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", nargs="?")
    p.add_argument("overrides", nargs="*")
    p.add_argument("--input", required=True)
    p.add_argument("--event", type=int, default=0)
    p.add_argument("--plane", type=int, default=None)
    p.add_argument("--out", default="display.png")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to run the forward on (default: cuda)")
    args = p.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from uresnet_tpu_torch.config import Config, apply_overrides, load_config

    overrides = list(args.overrides)
    if args.config and "=" in args.config:
        overrides.insert(0, args.config)
        args.config = None
    cfg = (load_config(args.config, overrides) if args.config
           else apply_overrides(Config(), overrides))

    plane = args.plane if args.plane is not None else cfg.data.planes[0]
    data, label, pred, _, step = predict(cfg, args.input, args.event, plane,
                                         args.checkpoint, args.device)

    if data.ndim == 3:
        return _display_3d(args, cfg, data, label, pred, step, plt)

    masked = lambda a: np.ma.masked_where(data == 0, a)  # noqa: E731
    fig, axes = plt.subplots(1, 3, figsize=(15, 5), constrained_layout=True)
    im0 = axes[0].imshow(data, cmap="viridis", origin="lower")
    axes[0].set_title(f"charge (event {args.event}, plane {plane})")
    fig.colorbar(im0, ax=axes[0], shrink=0.8)
    cmap = plt.get_cmap("tab10", cfg.model.num_class)
    axes[1].imshow(masked(label), cmap=cmap, origin="lower",
                   vmin=-0.5, vmax=cfg.model.num_class - 0.5)
    axes[1].set_title("truth (bg/track/shower)")
    axes[2].imshow(masked(pred), cmap=cmap, origin="lower",
                   vmin=-0.5, vmax=cfg.model.num_class - 0.5)
    nz = data > 0
    acc = float((pred[nz] == label[nz]).mean()) if nz.any() else float("nan")
    axes[2].set_title(f"prediction @ step {step} (nonzero acc {acc:.3f})")
    for ax in axes:
        ax.set_xticks([]); ax.set_yticks([])
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"wrote {args.out} (nonzero-pixel acc {acc:.3f})")
    return 0


def _display_3d(args, cfg, data, label, pred, step, plt):
    """3D volumes: a 3x3 grid of max-intensity projections (one row per
    axis). Charge projects as max; truth/pred project by taking the class
    at the max-charge voxel along the axis (the visible surface), with
    charge-free lines masked. Accuracy is computed on the full 3D nonzero
    set, not the projection."""
    nz = data > 0
    acc = (float((pred[nz] == label[nz]).mean()) if nz.any()
           else float("nan"))

    cmap = plt.get_cmap("tab10", cfg.model.num_class)
    fig, axes = plt.subplots(3, 3, figsize=(15, 15), constrained_layout=True)
    for row, axis in enumerate(range(3)):
        charge = data.max(axis=axis)
        idx = np.expand_dims(data.argmax(axis=axis), axis)
        at_max = lambda a: np.squeeze(  # noqa: E731
            np.take_along_axis(a, idx, axis=axis), axis)
        masked = lambda a: np.ma.masked_where(charge == 0, a)  # noqa: E731
        im0 = axes[row][0].imshow(masked(charge), cmap="viridis",
                                  origin="lower")
        axes[row][0].set_ylabel(f"max-proj axis {axis}")
        fig.colorbar(im0, ax=axes[row][0], shrink=0.8)
        axes[row][1].imshow(masked(at_max(label)), cmap=cmap, origin="lower",
                            vmin=-0.5, vmax=cfg.model.num_class - 0.5)
        axes[row][2].imshow(masked(at_max(pred)), cmap=cmap, origin="lower",
                            vmin=-0.5, vmax=cfg.model.num_class - 0.5)
    axes[0][0].set_title(f"charge (event {args.event})")
    axes[0][1].set_title("truth (bg/track/shower)")
    axes[0][2].set_title(f"prediction @ step {step} "
                         f"(3D nonzero acc {acc:.3f})")
    for ax in axes.ravel():
        ax.set_xticks([]); ax.set_yticks([])
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"wrote {args.out} (nonzero-voxel acc {acc:.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
