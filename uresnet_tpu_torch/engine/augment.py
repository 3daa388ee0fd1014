"""Device-side augmentation: per-image random flips and 90-degree rotations
(port of uresnet_tpu/engine/augment.py).

Flips and rot90 are the physical symmetries of wire-plane images; they
apply identically to data, label and weight. The per-image decisions are
the (dims + 1, B) booleans of data/device_pipeline.py ``draw_decisions``
(a flip per spatial axis, then the 2D rot90), so augmenting a dense batch
here equals the in-scatter path of ``densify_on_device`` given the same
decisions.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from uresnet_tpu_torch.data.device_pipeline import draw_decisions


def augment_batch(batch: Dict[str, torch.Tensor], *, dims: int = 2,
                  decisions: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
    """Flip each image along each spatial axis where decided, then (2D,
    square images) rotate by 90 degrees where decided. ``decisions`` are
    given, or drawn from ``generator``."""
    data = batch["data"]
    B = data.shape[0]
    if decisions is None:
        decisions = draw_decisions(generator, B, dims)
    decisions = decisions.to(data.device)
    out = dict(batch)
    for key in ("data", "label", "weight"):
        a = out[key]

        def sel(do, b, a):
            return torch.where(do.reshape((B,) + (1,) * (a.dim() - 1)), b, a)

        for ax in range(dims):
            a = sel(decisions[ax], a.flip(1 + ax), a)
        if dims == 2 and a.shape[1] == a.shape[2]:
            a = sel(decisions[dims], torch.rot90(a, 1, (1, 2)), a)
        out[key] = a
    return out
