"""U-ResNet (port of uresnet_tpu/models/uresnet.py), eval forward.

    input (B, H, W, C_in)
    stem: conv3(base_f) - BN - ReLU
    for level l in 0..depth-1:
        resblock x blocks_per_level @ f = base_f * 2^l
        skip[l] = activations
        downsample: conv3 stride2 -> 2f, BN, ReLU
    bottleneck: resblock x blocks_per_level @ base_f * 2^depth
    for level l in depth-1..0:
        conv_transpose stride2 -> base_f * 2^l, BN, ReLU
        concat(skip[l])
        resblock x blocks_per_level      # first block projects 2f -> f
    conv(final_kernel) -> num_class logits

Submodules carry the JAX unit names (``stem``, ``enc{l}_b{b}``,
``down{l}``, ``mid_b{b}``, ``up{l}``, ``dec{l}_b{b}``, ``head``).
``cfg.pack`` (a TPU lane-filling layout with canonical outputs) and
``cfg.remat`` (a training memory knob) are accepted and run canonical.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from uresnet_tpu.config import ModelConfig
from uresnet_tpu_torch.models.blocks import BlockCtx, Conv, ConvBN, ResBlock
from uresnet_tpu_torch.ops.conv import check_dims, conv, head_precision
from uresnet_tpu_torch.utils.dtypes import canonical_dtype


class UResNet(nn.Module):
    """Weights in the JAX layout (HWIO kernels) as parameters, BN running
    stats as buffers. ``forward`` is the eval forward:
    (B, H, W, C_in) -> float32 logits (B, H, W, num_class)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: Optional[torch.device] = None):
        super().__init__()
        check_dims(cfg.dims)
        self.cfg = cfg
        kw = dict(generator=generator, dims=cfg.dims,
                  param_dtype=canonical_dtype(cfg.param_dtype), device=device)
        f = cfg.base_filters
        self.stem = ConvBN(3, cfg.in_channels, f, **kw)
        for lvl in range(cfg.depth):
            fl = f * 2 ** lvl
            for b in range(cfg.blocks_per_level):
                self.add_module(f"enc{lvl}_b{b}", ResBlock(fl, fl, **kw))
            self.add_module(f"down{lvl}", ConvBN(3, fl, fl * 2, **kw))
        fb = f * 2 ** cfg.depth
        for b in range(cfg.blocks_per_level):
            self.add_module(f"mid_b{b}", ResBlock(fb, fb, **kw))
        for lvl in reversed(range(cfg.depth)):
            fl = f * 2 ** lvl
            self.add_module(f"up{lvl}", ConvBN(3, fl * 2, fl, **kw))
            for b in range(cfg.blocks_per_level):
                in_ch = fl * 2 if b == 0 else fl  # concat(skip) doubles
                self.add_module(f"dec{lvl}_b{b}", ResBlock(in_ch, fl, **kw))
        self.head = Conv(cfg.final_kernel, f, cfg.num_class, use_bias=True,
                         **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        ctx = BlockCtx(dims=cfg.dims,
                       compute_dtype=canonical_dtype(cfg.compute_dtype),
                       bn_eps=cfg.bn_eps)
        unit = self.get_submodule
        h = self.stem(x, ctx)
        skips = []
        for lvl in range(cfg.depth):
            for b in range(cfg.blocks_per_level):
                h = unit(f"enc{lvl}_b{b}")(h, ctx)
            skips.append(h)
            h = unit(f"down{lvl}")(h, ctx, stride=2)
        for b in range(cfg.blocks_per_level):
            h = unit(f"mid_b{b}")(h, ctx)
        for lvl in reversed(range(cfg.depth)):
            h = unit(f"up{lvl}")(h, ctx, stride=2, transpose=True)
            h = torch.cat([h, skips[lvl].to(h.dtype)], dim=-1)
            for b in range(cfg.blocks_per_level):
                h = unit(f"dec{lvl}_b{b}")(h, ctx)
        hd = canonical_dtype(cfg.head_dtype) if cfg.head_dtype else ctx.compute_dtype
        logits = conv(h, self.head.params(), dims=cfg.dims, compute_dtype=hd,
                      precision=head_precision(hd, ctx.compute_dtype))
        return logits.float()
