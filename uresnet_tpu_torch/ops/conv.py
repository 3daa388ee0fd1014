"""2D convolution primitives, channels-last (B, H, W, C) at the interface.

Port of uresnet_tpu/ops/conv.py. Kernels keep the JAX layout
(kH, kW, C_in, C_out) so one checkpoint loads in either package. Inside,
activations are viewed as NCHW with channels-last strides, the layout
cuDNN runs natively, so the permutes at the boundary copy nothing.

SAME padding follows XLA, not torch's symmetric ``padding=``:

  * stride s pads each dimension by max((ceil(S/s)-1)*s + k - S, 0) split
    (floor, ceil) — (0, 1) for k=3, s=2 on even sizes;
  * ``lax.conv_transpose`` SAME at stride 2 equals zero-stuffing the input
    by 2, padding (2, 1) and correlating with the UNFLIPPED kernel. That is
    ``conv_transpose2d`` with the spatially flipped kernel, cropped to the
    first 2H x 2W — not ``ConvTranspose2d(padding=1, output_padding=1)``.

bf16 convs go through `conv_general`'s autograd function: forward and data
gradient exactly as stock autograd (bf16 in, bf16 out), but the weight
gradient is computed from the upcast bf16 ``x`` and ``g`` into an f32
tensor that is never rounded to bf16. Stock autograd of
``conv(x.bfloat16(), w.bfloat16())`` would emit dw in bf16 and only then
upcast it. Every bf16 value is exact in TF32, so on the card the dw conv
runs with TF32 allowed: exact products, f32 sums — the numerics of the
TPU's DEFAULT pass.

Float32 means true float32: callers turn TF32 off for cuDNN and matmul
(engine/export.py build_serving_fn, engine/trainer.py), as JAX runs f32 at
HIGHEST.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def _tf32_convs():
    """TF32 allowed in cuDNN for the enclosed convs only. Not
    ``torch.backends.cudnn.flags(allow_tf32=True)``: that context manager
    also sets every other flag to its own defaults, cuDNN disabled among
    them."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _ConvF32WGrad(torch.autograd.Function):
    """``aten.convolution(x, w32.to(x.dtype))`` whose weight gradient is the
    f32 convolution of the upcast ``x`` and ``g`` (module docstring)."""

    @staticmethod
    def forward(ctx, x, w32, stride, padding, transposed):
        ctx.conf = (None, [stride] * 2, list(padding), [1, 1], transposed,
                    [0, 0], 1)
        ctx.save_for_backward(x, w32)
        return torch.ops.aten.convolution(x, w32.to(x.dtype), *ctx.conf)

    @staticmethod
    def backward(ctx, g):
        x, w32 = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                g, x, w32.to(x.dtype), *ctx.conf, [True, False, False])[0]
        if ctx.needs_input_grad[1]:
            with _tf32_convs():
                dw = torch.ops.aten.convolution_backward(
                    g.float(), x.float(), w32, *ctx.conf,
                    [False, True, False])[1]
        return dx, dw, None, None, None


class _RoundOperand(torch.autograd.Function):
    """Round to ``dtype`` and back in the forward; pass the gradient
    unrounded: operand precision, not a cast in the graph."""

    @staticmethod
    def forward(ctx, t, dtype):
        return t.to(dtype).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def conv_general(x: torch.Tensor, w: torch.Tensor, *, stride: int,
                 compute_dtype: torch.dtype, kind: str = "conv",
                 precision: Optional[torch.dtype] = None) -> torch.Tensor:
    """The one conv entry point: (B, H, W, C) x (k, k, C, Co) -> NHWC.

    ``kind='conv'``: SAME conv at ``stride``; ``kind='convt'``: SAME
    fractionally-strided conv (output ``stride`` x larger). 16-bit compute
    dtypes get the f32 weight gradient of `_ConvF32WGrad`; f32 (or wider)
    compute, an explicit ``precision`` (see `head_precision`) or no weight
    gradient runs stock autograd."""
    if precision is not None:  # round operands, compute in compute_dtype
        x = x.to(precision)
        w = _RoundOperand.apply(w, precision)
    x = x.to(compute_dtype)
    xn = x.permute(0, 3, 1, 2)
    k = w.shape[0]
    if kind == "conv":
        (ph0, ph1), (pw0, pw1) = (_same_pads(xn.shape[2], k, stride),
                                  _same_pads(xn.shape[3], k, stride))
        if ph0 != ph1 or pw0 != pw1:  # asymmetric: pad, then cuDNN pads 0
            xn = F.pad(xn, (pw0, pw1, ph0, ph1))
            ph0 = pw0 = 0
        wn = w.permute(3, 2, 0, 1)  # (Co, C, kH, kW)
        padding, transposed = (ph0, pw0), False
    elif kind == "convt":
        wn = w.flip(0, 1).permute(2, 3, 0, 1)  # (C_in, C_out, kH, kW)
        padding, transposed = (0, 0), True
    else:
        raise ValueError(f"unknown conv kind {kind!r}")
    f32_wgrad = (compute_dtype.itemsize < 4 and precision is None
                 and torch.is_grad_enabled() and w.requires_grad)
    if not f32_wgrad:
        y = torch.ops.aten.convolution(
            xn, wn.to(compute_dtype), None, [stride] * 2, list(padding),
            [1, 1], transposed, [0, 0], 1)
    else:
        y = _ConvF32WGrad.apply(xn, wn.float(), stride, padding, transposed)
    if kind == "convt":
        y = y[:, :, :x.shape[1] * stride, :x.shape[2] * stride]
    return y.permute(0, 2, 3, 1)


def conv(x: torch.Tensor, params: dict, *, stride: int = 1, dims: int = 2,
         compute_dtype: torch.dtype = torch.bfloat16,
         precision: Optional[torch.dtype] = None) -> torch.Tensor:
    """SAME-padded conv in ``compute_dtype``: (B, H, W, C) -> (B, H/s, W/s, Co).

    ``precision``: see `head_precision`."""
    check_dims(dims)
    y = conv_general(x, params["w"], stride=stride, compute_dtype=compute_dtype,
                     precision=precision)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def conv_transpose(x: torch.Tensor, params: dict, *, stride: int = 2,
                   dims: int = 2,
                   compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """SAME fractionally-strided conv: (B, H, W, C) -> (B, sH, sW, Co),
    equal to ``lax.conv_transpose(..., padding='SAME')``."""
    check_dims(dims)
    y = conv_general(x, params["w"], stride=stride, compute_dtype=compute_dtype,
                     kind="convt")
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y
