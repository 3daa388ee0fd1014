"""Seeded weights, made on the device in one draw and handed to both sides.

A training cell starts where training starts: Glorot-uniform kernels
(limit sqrt(6 / (fan_in + fan_out)), as TF1's conv layers draw them), BN
scale 1 and bias 0, running mean 0 and variance 1, a zero head bias. A
serving cell serves a model as training leaves it: BN scales in [0.5, 1.5),
BN and head biases in [-0.2, 0.2), and running statistics equal to the
batch statistics of the reference's own float32 forward over the pool's
first batch (the architecture's ``calibrate``), so that every activation
keeps its scale through the depth and the logits do not saturate. The
leaves, their order and which are statistics are the architecture's
(``cell.arch``, archs/<arch>.py).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from harness import spec


def make(cell: spec.Cell, seed: int, device, *,
         serve: bool) -> Dict[str, torch.Tensor]:
    """{leaf name: float32 tensor on ``device``}: parameters and BN
    statistics, from one ``torch.rand`` of a generator on ``device``
    seeded with ``seed``."""
    shapes = cell.arch.leaf_shapes(cell.config)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [math.prod(s) for s in shapes.values()]
    draw = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), u in zip(shapes.items(), torch.split(draw, sizes)):
        u = u.view(shape)
        if name.endswith("w"):
            k = math.prod(shape[:-2])
            limit = math.sqrt(6.0 / (k * shape[-2] + k * shape[-1]))
            out[name] = (u * 2 - 1) * limit
        elif name.endswith("scale"):
            out[name] = u + 0.5 if serve else torch.ones_like(u)
        elif name.endswith(("bias", "head.b")):
            out[name] = (u * 2 - 1) * 0.2 if serve else torch.zeros_like(u)
        elif name.endswith("mean"):
            out[name] = torch.zeros_like(u)
        else:
            out[name] = torch.ones_like(u)
    return out


def split(cell: spec.Cell, leaves: Dict[str, torch.Tensor]):
    """(parameters, BN statistics)."""
    stat = cell.arch.is_stat
    params = {k: v for k, v in leaves.items() if not stat(k)}
    stats = {k: v for k, v in leaves.items() if stat(k)}
    return params, stats
