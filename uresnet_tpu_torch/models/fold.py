"""Inference-time BatchNorm folding and the folded forward with its kernel
dispatch (port of uresnet_tpu/models/fold.py).

In eval mode BN is an affine map with frozen stats, so it folds into the
preceding conv:

    BN(conv(x, w)) = conv(x, w * g) + b,   g = scale / sqrt(var + eps)
                                           b = bias - mean * g

The folded forward routes every eligible conv (`fused_eligible`) through
the hand-written kernel ops/cuda/conv2d.py ``fused_conv3x3_bn_relu_v2``,
with ``cb2`` taking the residual add and ReLU into the same pass.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from uresnet_tpu_torch.config import ModelConfig
from uresnet_tpu_torch.ops.conv import conv, conv_transpose, head_precision
from uresnet_tpu_torch.ops.cuda.conv2d import fused_conv3x3_bn_relu_v2
from uresnet_tpu_torch.utils.dtypes import canonical_dtype

KERNEL_BACKENDS = ("auto", "xla", "pallas")


def _fold_unit(conv_p: dict, bn_p: dict, bn_s: dict, eps: float) -> dict:
    g = bn_p["scale"].float() * torch.rsqrt(bn_s["var"].float() + eps)
    b = bn_p["bias"].float() - bn_s["mean"].float() * g
    w = conv_p["w"].float() * g  # broadcast over the out-channel dim
    out = {"w": w.to(conv_p["w"].dtype), "b": b.to(conv_p["w"].dtype)}
    if "b" in conv_p:
        out["b"] = (conv_p["b"].float() * g + b).to(conv_p["w"].dtype)
    return out


def fold_batchnorm(params: Dict[str, Any], state: Dict[str, Any],
                   cfg: ModelConfig) -> Dict[str, Any]:
    """Fold every conv+BN unit's stats into conv weights+bias.

    Same keys as ``params``; each conv-BN pair becomes a biased conv;
    projection shortcuts and the head conv (no BN) pass through."""
    folded: Dict[str, Any] = {}
    for name, p in params.items():
        if name == "head":
            folded[name] = p
        elif "cb1" in p:  # residual block
            folded[name] = {
                "cb1": _fold_unit(p["cb1"]["conv"], p["cb1"]["bn"],
                                  state[name]["cb1"]["bn"], cfg.bn_eps),
                "cb2": _fold_unit(p["cb2"]["conv"], p["cb2"]["bn"],
                                  state[name]["cb2"]["bn"], cfg.bn_eps),
            }
            if "proj" in p:
                folded[name]["proj"] = p["proj"]
        else:  # conv_bn unit (stem / down / up)
            folded[name] = _fold_unit(p["conv"], p["bn"], state[name]["bn"],
                                      cfg.bn_eps)
    return folded


def fused_eligible(w_shape, *, dims: int, stride: int, transpose: bool) -> bool:
    """Whether a conv runs through the fused kernel: 2D, 3x3, stride 1, not
    a transpose, C and Co multiples of 16. The 16 is the bf16 MMA depth on
    Hopper, so a tensor-core version of the kernel keeps this rule (the JAX
    package's 128-lane rule was a TPU Mosaic DMA limit)."""
    return (dims == 2 and not transpose and stride == 1
            and tuple(w_shape[:2]) == (3, 3)
            and w_shape[2] % 16 == 0 and w_shape[3] % 16 == 0)


def _kernel_unit(p: dict, cd: torch.dtype) -> dict:
    """A folded conv's operands in the form the kernel takes: weights in the
    compute dtype, contiguous; f32 bias; the all-ones f32 scale."""
    return {"w": p["w"].to(cd).contiguous(), "b": p["b"].float(),
            "scale": torch.ones((p["w"].shape[-1],), dtype=torch.float32,
                                device=p["w"].device)}


def kernel_operands(folded: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """``folded`` with every fused-eligible unit's kernel operands made once
    (`_kernel_unit`), so a forward casts and allocates none of them. The
    folded parameters never change while serving; engine/export.py calls
    this once per serving function."""
    if cfg.kernel_backend == "xla":
        return folded
    cd = canonical_dtype(cfg.compute_dtype)
    out = dict(folded)
    for name, p in folded.items():
        if "cb1" in p:  # residual block: its two 3x3 stride-1 convs
            out[name] = {
                k: (_kernel_unit(u, cd) if k in ("cb1", "cb2") and fused_eligible(
                    u["w"].shape, dims=cfg.dims, stride=1, transpose=False)
                    else u)
                for k, u in p.items()}
    return out


def uresnet_apply_folded(folded: Dict[str, Any], x: torch.Tensor, *,
                         cfg: ModelConfig) -> torch.Tensor:
    """Inference forward over BN-folded params: conv(+bias)+ReLU chains,
    equal to the eval forward (tests/test_torch_model.py).

    ``cfg.kernel_backend``: 'auto' and 'pallas' run eligible convs through
    the repo's hand-written kernel; 'xla' runs the plain torch composition
    (cuDNN conv, then bias, residual and ReLU) — the A/B switch."""
    if cfg.kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(
            f"model.kernel_backend must be 'auto', 'xla' or 'pallas', "
            f"got {cfg.kernel_backend!r}")
    use_kernel = cfg.kernel_backend != "xla"
    cd = canonical_dtype(cfg.compute_dtype)

    def eligible(p, stride=1, transpose=False):
        return use_kernel and fused_eligible(p["w"].shape, dims=cfg.dims,
                                             stride=stride, transpose=transpose)

    def fused(p, h, residual=None, do_relu=True):
        if "scale" not in p:  # not prepared by `kernel_operands`
            p = _kernel_unit(p, cd)
        return fused_conv3x3_bn_relu_v2(
            h.to(cd).contiguous(), p["w"], p["scale"], p["b"],
            residual, relu=do_relu)

    def cbr(p, h, stride=1, transpose=False):
        if eligible(p, stride, transpose):
            return fused(p, h)
        if transpose:
            h = conv_transpose(h, p, stride=stride, dims=cfg.dims,
                               compute_dtype=cd)
        else:
            h = conv(h, p, stride=stride, dims=cfg.dims, compute_dtype=cd)
        return torch.relu(h)

    def block(p, h):
        y = cbr(p["cb1"], h)
        sc = h if "proj" not in p else conv(h, p["proj"], dims=cfg.dims,
                                            compute_dtype=cd)
        if eligible(p["cb2"]):
            # conv + bias + residual add + ReLU in ONE fused pass
            return fused(p["cb2"], y, residual=sc.to(cd).contiguous())
        y = conv(y, p["cb2"], dims=cfg.dims, compute_dtype=cd)
        return torch.relu(y + sc.to(y.dtype))

    h = cbr(folded["stem"], x)
    skips = []
    for lvl in range(cfg.depth):
        for b in range(cfg.blocks_per_level):
            h = block(folded[f"enc{lvl}_b{b}"], h)
        skips.append(h)
        h = cbr(folded[f"down{lvl}"], h, stride=2)
    for b in range(cfg.blocks_per_level):
        h = block(folded[f"mid_b{b}"], h)
    for lvl in reversed(range(cfg.depth)):
        h = cbr(folded[f"up{lvl}"], h, stride=2, transpose=True)
        h = torch.cat([h, skips[lvl].to(h.dtype)], dim=-1)
        for b in range(cfg.blocks_per_level):
            h = block(folded[f"dec{lvl}_b{b}"], h)
    hd = canonical_dtype(cfg.head_dtype) if cfg.head_dtype else cd
    logits = conv(h, folded["head"], dims=cfg.dims, compute_dtype=hd,
                  precision=head_precision(hd, cd))
    return logits.float()
