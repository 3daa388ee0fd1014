"""2D convolution primitives, channels-last (B, H, W, C) at the interface.

Port of uresnet_tpu/ops/conv.py (forward only). Kernels keep the JAX
layout (kH, kW, C_in, C_out) so one checkpoint loads in either package.
Inside, activations are viewed as NCHW with channels-last strides, the
layout cuDNN runs natively, so the permutes at the boundary copy nothing.

SAME padding follows XLA, not torch's symmetric ``padding=``:

  * stride s pads each dimension by max((ceil(S/s)-1)*s + k - S, 0) split
    (floor, ceil) — (0, 1) for k=3, s=2 on even sizes;
  * ``lax.conv_transpose`` SAME at stride 2 equals zero-stuffing the input
    by 2, padding (2, 1) and correlating with the UNFLIPPED kernel. That is
    ``conv_transpose2d`` with the spatially flipped kernel, cropped to the
    first 2H x 2W — not ``ConvTranspose2d(padding=1, output_padding=1)``.

Float32 means true float32: callers turn TF32 off for cuDNN and matmul
(engine/export.py build_serving_fn), as JAX runs f32 at HIGHEST.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def check_dims(dims: int) -> None:
    if dims != 2:
        raise NotImplementedError(
            f"dims={dims}: the port runs 2D models only so far "
            "(ROADMAP.md, modules to port: 3D)")


def conv_init(generator: torch.Generator, kernel: int, in_ch: int,
              out_ch: int, *, dims: int = 2, use_bias: bool = True,
              param_dtype: torch.dtype = torch.float32,
              device: Optional[torch.device] = None) -> dict:
    """Glorot-uniform kernel (TF1 `tf.layers.conv2d` default) + zero bias.

    Drawn on the CPU from ``generator`` and then moved, so a seed gives the
    same weights on every device."""
    check_dims(dims)
    shape = (kernel,) * dims + (in_ch, out_ch)
    fan_in = in_ch * kernel ** dims
    fan_out = out_ch * kernel ** dims
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = (torch.rand(shape, generator=generator, dtype=torch.float32) * 2 - 1) * limit
    p = {"w": w.to(device=device, dtype=param_dtype)}
    if use_bias:
        p["b"] = torch.zeros((out_ch,), dtype=param_dtype, device=device)
    return p


def head_precision(head_dtype: torch.dtype,
                   compute_dtype: torch.dtype) -> Optional[torch.dtype]:
    """Operand rounding for a logits conv whose dtype is RAISED above the
    model's compute dtype (model.head_dtype): the operands are rounded to
    ``compute_dtype`` — the same products as the stock head — and summed
    into an unrounded ``head_dtype`` output. Same-dtype heads: None."""
    return compute_dtype if head_dtype != compute_dtype else None


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _operands(x, w, compute_dtype, precision):
    if precision is not None:  # round operands, compute in compute_dtype
        x = x.to(precision)
        w = w.to(precision)
    return x.to(compute_dtype), w.to(compute_dtype)


def conv(x: torch.Tensor, params: dict, *, stride: int = 1, dims: int = 2,
         compute_dtype: torch.dtype = torch.bfloat16,
         precision: Optional[torch.dtype] = None) -> torch.Tensor:
    """SAME-padded conv in ``compute_dtype``: (B, H, W, C) -> (B, H/s, W/s, Co).

    ``precision``: see `head_precision`."""
    check_dims(dims)
    x, w = _operands(x, params["w"], compute_dtype, precision)
    k = w.shape[0]
    xn = x.permute(0, 3, 1, 2)
    (ph0, ph1), (pw0, pw1) = (_same_pads(xn.shape[2], k, stride),
                              _same_pads(xn.shape[3], k, stride))
    if ph0 == ph1 and pw0 == pw1:  # cuDNN pads itself: no padded copy
        y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride,
                     padding=(ph0, pw0))
    else:
        y = F.conv2d(F.pad(xn, (pw0, pw1, ph0, ph1)), w.permute(3, 2, 0, 1),
                     stride=stride)
    y = y.permute(0, 2, 3, 1)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def conv_transpose(x: torch.Tensor, params: dict, *, stride: int = 2,
                   dims: int = 2,
                   compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """SAME fractionally-strided conv: (B, H, W, C) -> (B, sH, sW, Co),
    equal to ``lax.conv_transpose(..., padding='SAME')``."""
    check_dims(dims)
    x, w = _operands(x, params["w"], compute_dtype, None)
    H, W = x.shape[1], x.shape[2]
    wt = w.flip(0, 1).permute(2, 3, 0, 1)  # (C_in, C_out, kH, kW)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=stride)
    y = y[:, :, :H * stride, :W * stride].permute(0, 2, 3, 1)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y
