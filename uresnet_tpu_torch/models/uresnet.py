"""U-ResNet (port of uresnet_tpu/models/uresnet.py), train and eval forward.

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
``cfg.pack`` (a TPU lane-filling layout with canonical outputs) is
accepted and runs canonical. ``cfg.remat`` checkpoints activations in the
train forward, per U-Net level or per unit, with
``torch.utils.checkpoint``: the recomputation in the backward reruns BN
on the same (unwritten) buffers and its new stats are discarded, so the
running stats move once per step.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from uresnet_tpu_torch.config import ModelConfig
from uresnet_tpu_torch.models.blocks import BlockCtx, Conv, ConvBN, ResBlock
from uresnet_tpu_torch.ops.conv import check_dims, conv, head_precision
from uresnet_tpu_torch.utils.dtypes import canonical_dtype


def _checkpointed(fn):
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def remat_wrappers(remat):
    """(level, block) wrappers for cfg.remat: False | True/'level' |
    'block', as uresnet_tpu/models/uresnet.py ``remat_wrappers``."""
    mode = remat if isinstance(remat, str) else ("level" if remat else "none")
    if mode not in ("none", "level", "block"):
        raise ValueError(f"unknown remat mode {remat!r}")
    ident = lambda fn: fn  # noqa: E731
    return ((_checkpointed if mode == "level" else ident),
            (_checkpointed if mode == "block" else ident))


class UResNet(nn.Module):
    """Weights in the JAX layout (HWIO kernels) as parameters, BN running
    stats as buffers. ``forward(x, train)``: (B, H, W, C_in) ->
    (float32 logits (B, H, W, num_class), new BN-state tree)."""

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

    def forward(self, x: torch.Tensor, train: bool = False):
        """The BN-state tree is keyed as ``uresnet_apply``'s: new detached
        running stats in train mode, the buffers in eval mode."""
        cfg = self.cfg
        ctx = BlockCtx(dims=cfg.dims,
                       compute_dtype=canonical_dtype(cfg.compute_dtype),
                       bn_eps=cfg.bn_eps, bn_momentum=cfg.bn_momentum,
                       train=train)
        level, block = (remat_wrappers(cfg.remat)
                        if train and torch.is_grad_enabled()
                        else remat_wrappers(False))
        unit = self.get_submodule
        new_state = {}

        def run(name, h, **kw):
            h, new_state[name] = block(
                lambda hh: unit(name)(hh, ctx, **kw))(h)
            return h

        def run_blocks(prefix, h):
            for b in range(cfg.blocks_per_level):
                h = run(f"{prefix}_b{b}", h)
            return h

        h, new_state["stem"] = self.stem(x, ctx)
        skips = []
        for lvl in range(cfg.depth):
            def enc(h, lvl=lvl):
                skip = run_blocks(f"enc{lvl}", h)
                return run(f"down{lvl}", skip, stride=2), skip
            h, skip = level(enc)(h)
            skips.append(skip)
        h = level(lambda h: run_blocks("mid", h))(h)
        for lvl in reversed(range(cfg.depth)):
            def dec(h, skip, lvl=lvl):
                h = run(f"up{lvl}", h, stride=2, transpose=True)
                h = torch.cat([h, skip.to(h.dtype)], dim=-1)
                return run_blocks(f"dec{lvl}", h)
            h = level(dec)(h, skips[lvl])
        hd = canonical_dtype(cfg.head_dtype) if cfg.head_dtype else ctx.compute_dtype
        logits = conv(h, self.head.params(), dims=cfg.dims, compute_dtype=hd,
                      precision=head_precision(hd, ctx.compute_dtype))
        return logits.float(), {k: new_state[k] for k in self._unit_order}

    @property
    def _unit_order(self):
        """Unit names in ``uresnet_init`` order (the head holds no state)."""
        return [n for n, _ in self.named_children() if n != "head"]
