"""The submanifold sparse U-ResNet of arXiv:1903.05663 as the harness sees
an architecture (the hooks are listed in archs/uresnet.py), over its plain
reference beside this file (archs/sparse_uresnet_reference.py), which
builds its own sites and rulebooks from each padded sparse batch.

The view of a batch is the batch itself with the points that count
(``valid``: inside the event's npoints and the extent), their labels
(``point_label``) and a zero ``origin``: the volume is not cropped. Logits
and scores are compared at the batch's points, (B, P, num_class), zeros at
padding, as the program's ``Trainer._loss_fn`` and ana step give them.
"""

from __future__ import annotations

import numpy as np
import torch

from archs import sparse_uresnet_reference as reference

is_stat = reference.is_stat


def leaf_shapes(conf: dict):
    return reference.leaf_shapes(conf["model"])


def view(conf: dict, batch: dict, weight_mode: str) -> dict:
    coords = np.asarray(batch["coords"])
    B, P, D = coords.shape
    extent = conf["data"]["image_size"]
    valid = ((np.arange(P)[None] < np.asarray(batch["npoints"])[:, None])
             & ((coords >= 0) & (coords < extent)).all(-1))
    return dict(batch, valid=valid,
                point_label=np.asarray(batch["labels"]).astype(np.int64),
                origin=np.zeros((B, D), np.int64), weight_mode=weight_mode)


def _conf(conf: dict, view: dict) -> dict:
    """``conf`` with the view's weight mode."""
    return dict(conf, data=dict(conf["data"], weight_mode=view["weight_mode"]))


def calibrate(conf: dict, leaves, view: dict, *, device) -> None:
    params = {k: v for k, v in leaves.items() if not is_stat(k)}
    stats = {k: v for k, v in leaves.items() if is_stat(k)}
    reference.calibrate(conf, params, stats, view, device=device)
    leaves.update(stats)


def train_steps(conf: dict, params, views, *, device, quant=None) -> dict:
    return reference.train_steps(_conf(conf, views[0]), params, views,
                                 device=device, quant=quant)


def train_logits(conf: dict, params, view: dict, *, device, quant=None):
    return reference.train_logits(conf, params, view, device=device,
                                  quant=quant)


def analyse(conf: dict, params, stats, view: dict, *, device,
            quant=None) -> dict:
    return reference.analyse(conf, params, stats, view, device=device,
                             quant=quant)


_FLOPS: dict = {}  # id of a batch's coords -> (the coords, its FLOPs)


def batch_flops(conf: dict, batch: dict, *, train: bool) -> int:
    """The useful FLOPs of one pool batch from the reference's own pairs
    (reference.step_flops): 2 x pairs x C_in x C_out for the forward and
    the weight gradient of every conv and linear map, and the input
    gradient of every one but the stem, the head's included. The pairs
    are counted once a batch, on the card where there is one."""
    key = (id(batch["coords"]), train)
    hit = _FLOPS.get(key)
    if hit is None or hit[0] is not batch["coords"]:
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        hit = _FLOPS[key] = (batch["coords"], reference.step_flops(
            conf, batch, train=train, device=dev))
    return hit[1]
