"""Packed (space-to-depth) U-ResNet forward, 2D and 3D (port of
uresnet_tpu/models/packed.py).

Every level whose channel count is below ``cfg.pack_threshold`` runs in
packed space with the exact-equivalence kernels of ops/pack.py: the same
``UResNet`` submodules and canonical parameters, packed on the fly in each
forward, the same function in another layout. Parameters, BN buffers,
Adam moments and checkpoints keep the canonical shapes and the JAX key
names, so a packed run and a canonical run read and write the same npz.
The JAX package packs to fill the TPU's 128 MXU lanes; on the card the
packed convs are cuDNN's, as the canonical ones are (PERF.md measures
both layouts).

Layout rules per level l (f = base_filters * 2^l, P = 2^dims):
  encoder: unpacked input -> [s2d] -> packed blocks -> packed-down conv ->
           UNPACKED (S/2, 2f) output; skip saved packed.
  decoder: unpacked (S/2, 2f) -> packed-up conv -> packed (P*f on the S/2
           grid) -> concat packed skip -> packed blocks -> [d2s] ->
           unpacked, except level 0, which stays packed through the head.
  2D block runs whose P*f <= 64 take an extra factor-2 H pack (s2d_h)
  with ``pack_extra_h``; at level 0 it stays resident from the stem to
  down0 and from up0 to the head.
BatchNorm in packed space views (..., P*C) as (..., P, C) so the
statistics span the spatial phases (ops/norm.py), equal to unpacked BN;
the running stats keep their canonical (C,) shape.

Under remat (``torch.utils.checkpoint``) the recompute reruns the weight
packing and BN on the same unwritten buffers and its stats are discarded,
so the running stats move once per step, as in the canonical forward.
"""

from __future__ import annotations

import torch

from uresnet_tpu_torch.config import ModelConfig
from uresnet_tpu_torch.ops.conv import head_precision
from uresnet_tpu_torch.ops.pack import (d2s_h, depth_to_space,
                                        pack_weight_concat, pack_weight_conv,
                                        pack_weight_conv_h, pack_weight_down,
                                        pack_weight_down_h, pack_weight_up,
                                        pack_weight_up_h, s2d_h,
                                        space_to_depth)
from uresnet_tpu_torch.utils.dtypes import canonical_dtype


def _packed_level(cfg: ModelConfig, lvl: int) -> bool:
    return cfg.base_filters * (2 ** lvl) < cfg.pack_threshold


def _hpack_level(cfg: ModelConfig, lvl: int) -> bool:
    """The extra H phase (2D only) where the packed channel count still
    underfills the TPU's 128 lanes; resident at level 0."""
    P = 2 ** cfg.dims
    return (cfg.pack_extra_h and cfg.dims == 2 and _packed_level(cfg, lvl)
            and P * cfg.base_filters * (2 ** lvl) <= 64)


def loss_layout_phases(cfg: ModelConfig) -> int:
    """Spatial phases per packed-head logit position (1 = canonical head).

    Per-pixel losses and metrics are layout-invariant, so the train step
    can take the head's PACKED logits (``UResNet.forward(...,
    packed_logits=True)``) and skip the relayout of the full-resolution
    logits; the targets are then packed to the same layout
    (`pack_like_logits`, or data/device_pipeline.py's packed scatter)."""
    if not cfg.pack or not _packed_level(cfg, 0):
        return 1
    P = 2 ** cfg.dims
    return 2 * P if _hpack_level(cfg, 0) else P


def pack_like_logits(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A per-pixel target (B, *S, K) in the packed-head logit layout
    (B, *S', phases*K), phase-major: the channel order the packed head
    conv emits (H phase outermost under the H pack)."""
    x = space_to_depth(x, dims=cfg.dims)
    if _hpack_level(cfg, 0):
        x = s2d_h(x)
    return x


def _pack_same_w(w, dims, in_splits, hpack, splits_hpacked):
    """Packed (optionally H-packed) stride-1 kernel for the input's layout:
    a transient H pack concatenates BEFORE s2d_h (its H phases span the
    whole concat: conv_h of the concat-packed kernel); a resident one
    concatenates already H-packed tensors (H phases per tensor: conv_h per
    slice, then concat)."""
    if in_splits and hpack and splits_hpacked:
        return torch.cat([pack_weight_conv_h(pack_weight_conv(w[..., a:b, :],
                                                              dims))
                          for a, b in in_splits], dim=-2)
    wp = (pack_weight_concat([w[..., a:b, :] for a, b in in_splits], dims)
          if in_splits else pack_weight_conv(w, dims))
    return pack_weight_conv_h(wp) if hpack else wp


def _conv_bn_packed(ctx, unit, x, *, relu=True, mode="same", in_splits=None,
                    hpack=False, splits_hpacked=False, residual=None):
    """Packed conv + BN (+ residual) (+ ReLU) of a ``ConvBN`` unit. mode:
    'same' | 'down' | 'up' | 'down_h' (H-packed in and out) | 'up_h'
    (unpacked in, H-packed out). ``hpack`` (2D): input and output carry an
    extra H phase."""
    w = unit.conv.w
    dims = ctx.dims
    P = 2 ** dims
    if mode == "same":
        y = ctx.conv_packed(x, _pack_same_w(w, dims, in_splits, hpack,
                                            splits_hpacked))
        phases = 2 * P if hpack else P
    elif mode == "down":  # unpacked out
        y = ctx.conv_packed(x, pack_weight_down(w, dims), padding=(0, 1))
        phases = 1
    elif mode == "down_h":
        y = ctx.conv_packed(x, pack_weight_down_h(pack_weight_down(w, dims)),
                            padding=(0, 1))
        phases = 2
    elif mode == "up":
        y = ctx.conv_packed(x, pack_weight_up(w, dims), padding=(1, 0))
        phases = P
    elif mode == "up_h":
        y = ctx.conv_packed(x, pack_weight_up_h(pack_weight_up(w, dims)),
                            padding=((1, 0), (1, 0)), stride=(2, 1))
        phases = 2 * P
    else:
        raise ValueError(mode)
    y, s = unit.bn(y, ctx, phases=phases, relu=relu, residual=residual)
    return y, {"bn": s}


def _resblock_packed(ctx, unit, x, *, in_splits=None, hpack=False,
                     splits_hpacked=False):
    y, s1 = _conv_bn_packed(ctx, unit.cb1, x, in_splits=in_splits,
                            hpack=hpack, splits_hpacked=splits_hpacked)
    shortcut = x
    if unit.proj is not None:
        shortcut = ctx.conv_packed(x, _pack_same_w(
            unit.proj.w, ctx.dims, in_splits, hpack, splits_hpacked))
    y, s2 = _conv_bn_packed(ctx, unit.cb2, y, hpack=hpack, residual=shortcut)
    return y, {"cb1": s1, "cb2": s2}


def packed_forward(model, x: torch.Tensor, ctx, *, level, block,
                   packed_logits: bool = False):
    """``model`` (models/uresnet.py ``UResNet``) on ``x`` (B, *S, C_in) in
    the packed layout: (logits, new BN-state tree by unit). ``level`` and
    ``block`` are the remat wrappers. ``packed_logits``: the head's logits
    in their packed layout (B, *S', phases * num_class) in the head's
    dtype, the train loss's input; else canonical f32 logits. A no-op when
    level 0 is not packed."""
    cfg = model.cfg
    if ctx.mesh is not None and ctx.mesh.model > 1:
        raise ValueError("parallel.model > 1 (tensor parallelism) requires "
                         "the canonical layout — set model.pack: false")
    dims = cfg.dims
    P = 2 ** dims
    unit = model.get_submodule
    new_state = {}
    resident = _hpack_level(cfg, 0)

    def run_blocks(prefix, h, packed, first_in_splits=None, hpack=False,
                   res=False, splits_hpacked=False):
        """``hpack``: the blocks run H-packed; ``res``: the input and
        output already are (resident), so no relayout here."""
        sub = {}
        if hpack and not res:
            h = s2d_h(h)
        for b in range(cfg.blocks_per_level):
            name = f"{prefix}_b{b}"
            splits = first_in_splits if b == 0 else None
            if packed:
                fn = lambda hh, name=name, splits=splits: _resblock_packed(  # noqa: E731
                    ctx, unit(name), hh, in_splits=splits, hpack=hpack,
                    splits_hpacked=splits_hpacked)
            else:
                fn = lambda hh, name=name: unit(name)(hh, ctx)  # noqa: E731
            h, sub[name] = block(fn)(h)
        if hpack and not res:
            h = d2s_h(h)
        return h, sub

    if _packed_level(cfg, 0):
        h = space_to_depth(x, dims=dims)
        if resident:
            h = s2d_h(h)
        h, new_state["stem"] = _conv_bn_packed(ctx, model.stem, h,
                                               hpack=resident)
    else:
        h, new_state["stem"] = model.stem(x, ctx)

    skips = []
    for lvl in range(cfg.depth):
        pk = _packed_level(cfg, lvl)

        def enc(h, lvl=lvl, pk=pk):
            res_lvl = resident and lvl == 0
            if pk and lvl > 0:  # level 0's input comes packed from the stem
                h = space_to_depth(h, dims=dims)
            h, sub = run_blocks(f"enc{lvl}", h, pk, hpack=_hpack_level(cfg, lvl),
                                res=res_lvl)
            skip = h  # resident: saved H-packed, as dec0 takes it
            name = f"down{lvl}"
            if pk:
                dn = lambda hh: _conv_bn_packed(  # noqa: E731
                    ctx, unit(name), hh, mode="down_h" if res_lvl else "down")
            else:
                dn = lambda hh: unit(name)(hh, ctx, stride=2)  # noqa: E731
            hs, sub[name] = block(dn)(h)
            if res_lvl:  # the next level takes the canonical layout
                hs = d2s_h(hs)
            return hs, skip, sub

        h, skip, sub = level(enc)(h)
        skips.append(skip)
        new_state.update(sub)

    h, sub = level(lambda h: run_blocks("mid", h, False))(h)
    new_state.update(sub)

    for lvl in reversed(range(cfg.depth)):
        pk = _packed_level(cfg, lvl)
        fl = cfg.base_filters * (2 ** lvl)

        def dec(h, skip, lvl=lvl, pk=pk, fl=fl):
            name = f"up{lvl}"
            sub = {}
            res_lvl = resident and lvl == 0
            if pk:
                h, sub[name] = block(lambda hh: _conv_bn_packed(
                    ctx, unit(name), hh,
                    mode="up_h" if res_lvl else "up"))(h)
                h = torch.cat([h, skip.to(h.dtype)], dim=-1)
                h, bsub = run_blocks(f"dec{lvl}", h, True,
                                     first_in_splits=((0, fl), (fl, 2 * fl)),
                                     hpack=_hpack_level(cfg, lvl), res=res_lvl,
                                     splits_hpacked=res_lvl)
                if lvl != 0:
                    h = depth_to_space(h, dims=dims)
            else:
                # the phase-decomposed upsample at unpacked levels too, as
                # the JAX package runs it: a packed 2^dims-tap conv + d2s
                def up(hh):
                    u = unit(name)
                    y = ctx.conv_packed(hh, pack_weight_up(u.conv.w, dims),
                                        padding=(1, 0))
                    y, s = u.bn(depth_to_space(y, dims=dims), ctx, relu=True)
                    return y, {"bn": s}

                h, sub[name] = block(up)(h)
                h = torch.cat([h, skip.to(h.dtype)], dim=-1)
                h, bsub = run_blocks(f"dec{lvl}", h, False)
            sub.update(bsub)
            return h, sub

        h, sub = level(dec)(h, skips[lvl])
        new_state.update(sub)

    hd = canonical_dtype(cfg.head_dtype) if cfg.head_dtype else ctx.compute_dtype
    prec = head_precision(hd, ctx.compute_dtype)
    if not _packed_level(cfg, 0):
        return ctx.conv(h, model.head.params(), compute_dtype=hd,
                        precision=prec).float(), new_state
    wp = pack_weight_conv(model.head.w, dims)
    if resident:
        wp = pack_weight_conv_h(wp)
    logits = ctx.conv_packed(h, wp, compute_dtype=hd, precision=prec)
    if getattr(model.head, "b", None) is not None:
        logits = logits + model.head.b.repeat(
            2 * P if resident else P).to(logits.dtype)
    if packed_logits:
        return logits, new_state
    if resident:
        logits = d2s_h(logits)
    return depth_to_space(logits, dims=dims).float(), new_state
