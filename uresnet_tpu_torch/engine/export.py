"""The serving function (port of uresnet_tpu/engine/export.py
``build_serving_fn``): BN-folded forward + f32 softmax over classes.

The ``.uxm`` serialized-artifact analogue is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from uresnet_tpu_torch.config import Config
from uresnet_tpu_torch.models.convert import trees
from uresnet_tpu_torch.models.fold import (fold_batchnorm, kernel_operands,
                                            uresnet_apply_folded)
from uresnet_tpu_torch.models.uresnet import UResNet


def build_serving_fn(cfg: Config,
                     model: UResNet) -> Callable[[torch.Tensor], torch.Tensor]:
    """x (B, H, W, C_in) normalized charge image, on the model's device ->
    f32 per-pixel softmax scores (B, H, W, num_class).

    Serving is canonical: ``pack`` is a TPU lane-filling training layout
    with identical outputs. Unlike the JAX package, which forces
    ``kernel_backend='xla'`` here because XLA beat its Pallas kernel on the
    TPU, the configured backend is kept: that measurement does not carry
    over to Hopper, so 'auto' runs the hand-written kernel."""
    mcfg = dataclasses.replace(cfg.model, pack=False, remat=False)
    if mcfg.compute_dtype == "float32":
        # f32 means true f32, as JAX's Precision.HIGHEST: no TF32 in cuDNN
        # or cuBLAS
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        folded = kernel_operands(fold_batchnorm(*trees(model), mcfg), mcfg)

    @torch.inference_mode()
    def serve(x: torch.Tensor) -> torch.Tensor:
        logits = uresnet_apply_folded(folded, x, cfg=mcfg)
        return torch.softmax(logits.float(), dim=-1)

    return serve
