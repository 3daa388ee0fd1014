"""The dense U-ResNet (harness/reference.py, harness/flops.py) as the
harness sees an architecture.

A configuration file names its architecture by the top-level key
``"arch"``; ``spec.cell`` loads ``archs/<arch>.py`` by file path and hands
it to the harness as ``Cell.arch``. Every hook takes ``conf``, the whole
configuration file as a dict, first:

  leaf_shapes(conf) -> {leaf name: shape}
      every leaf of the checkpoint in the order ``weights.make`` draws
      them: kernels (names ending in ``w``, laid out (*k, C_in, C_out)),
      scales, biases, statistics (names ending in ``mean`` or ``var``).
  is_stat(name) -> bool
      whether a leaf is a statistic and not a parameter.
  view(conf, batch, weight_mode) -> dict
      the reference's view of one pool batch (harness/events.py's padded
      sparse arrays), with the class weights of ``weight_mode``. The
      analysis check (harness/checks.py) reads three keys of it: ``valid``
      (B, P) whether each point counts, ``point_label`` (B, P) its label,
      ``origin`` (B, D) the crop's origin.
  calibrate(conf, leaves, view, *, device) -> None
      a serving cell's statistics, set in ``leaves`` from the float32
      reference's forward over ``view``.
  train_steps(conf, params, views, *, device, quant=None) -> dict
      Adam steps from ``params``, one per view: ``losses``, ``logits`` of
      the first step (on the host), ``grad_norms`` of its gradient as the
      optimizer gets it and ``change_norms`` over all steps, per leaf.
  train_logits(conf, params, view, *, device, quant=None) -> Tensor
      the first step's forward alone, on the host: with ``quant`` the
      yardstick of ``checks.logit_error``.
  analyse(conf, params, stats, view, *, device, quant=None) -> dict
      the analysis of one view: ``pscores`` (B, P, K) at the points,
      ``conf`` (K, K), ``n_pixels``, ``n_nonzero`` (B,), ``correct_nonzero``.
  batch_flops(conf, batch, *, train) -> int
      the useful FLOPs of one pool batch: the forward, or with ``train``
      the training step.

``quant`` is None (float32) or one of harness/quant.py's roundings.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import flops, reference

is_stat = reference.is_stat


def leaf_shapes(conf: dict):
    return reference.leaf_shapes(conf["model"])


def view(conf: dict, batch: dict, weight_mode: str) -> dict:
    d, m = conf["data"], conf["model"]
    out = reference.densify(batch, size=d["image_size"],
                            scale=d["normalize_scale"],
                            clip=d["normalize_clip"], weight_mode=weight_mode,
                            num_class=m["num_class"])
    out["point_label"] = np.take_along_axis(
        out["label"].reshape(len(out["flat"]), -1), out["flat"], 1)
    return out


@torch.no_grad()
def calibrate(conf: dict, leaves, view: dict, *, device) -> None:
    params = {k: v for k, v in leaves.items() if not is_stat(k)}
    stats = {k: v for k, v in leaves.items() if is_stat(k)}
    with reference.true_f32():
        reference.forward(params, stats,
                          torch.as_tensor(view["data"], device=device),
                          conf["model"], mode="calibrate")
    leaves.update(stats)


def train_steps(conf: dict, params, views, *, device, quant=None) -> dict:
    return reference.train_steps(conf["model"], conf["optim"], params, views,
                                 device=device, quant=quant)


def train_logits(conf: dict, params, view: dict, *, device, quant=None):
    return reference.train_logits(conf["model"], params, view, device=device,
                                  quant=quant)


def analyse(conf: dict, params, stats, view: dict, *, device,
            quant=None) -> dict:
    return reference.analyse(conf["model"], params, stats, view,
                             device=device, quant=quant)


def batch_flops(conf: dict, batch: dict, *, train: bool) -> int:
    """The canonical model's FLOPs (harness/flops.py) at the configured
    image size and batch, whatever the batch holds: every pixel of the
    dense image is computed."""
    m, d = conf["model"], conf["data"]
    count = flops.train_step_flops if train else flops.forward_flops
    return count(m, d["image_size"], d["batch_size"])
