"""N-D convolution primitives, channels-last (B, *S, C) at the interface:
2D (B, H, W, C) and 3D (B, D, H, W, C).

Port of uresnet_tpu/ops/conv.py. Kernels keep the JAX layout
(*k, C_in, C_out) — HWIO, DHWIO — so one checkpoint loads in either
package. Inside, activations are viewed as (B, C, *S) with channels-last
strides (``channels_last`` / ``channels_last_3d``), the layout cuDNN runs
natively, so the permutes at the boundary copy nothing.

SAME padding follows XLA, not torch's symmetric ``padding=``:

  * stride s pads each spatial axis by max((ceil(S/s)-1)*s + k - S, 0)
    split (floor, ceil) — (0, 1) for k=3, s=2 on even sizes. cuDNN's
    ``padding=`` is symmetric, so an asymmetric pad is an ``F.pad`` (which
    keeps the channels-last strides) and cuDNN pads 0;
  * ``lax.conv_transpose`` SAME at stride 2 equals zero-stuffing the input
    by 2, padding (2, 1) and correlating with the UNFLIPPED kernel. That is
    the transposed conv with the spatially flipped kernel, cropped to the
    first 2S on every axis — not ``ConvTranspose(padding=1,
    output_padding=1)``.

bf16 convs go through `conv_general`'s autograd function: forward and data
gradient exactly as stock autograd (bf16 in, bf16 out), but the weight
gradient is computed from the upcast bf16 ``x`` and ``g`` into an f32
tensor that is never rounded to bf16. Stock autograd of
``conv(x.bfloat16(), w.bfloat16())`` would emit dw in bf16 and only then
upcast it. Every bf16 value is exact in TF32, so on the card the dw conv
runs with TF32 allowed: exact products, f32 sums — the numerics of the
TPU's DEFAULT pass.

The raised head (`head_precision`) convolves f32 tensors that hold
bf16-rounded operands; it runs with TF32 allowed in its forward and both
gradients (`_ConvTF32`), whatever the global flag says.

Float32 means true float32, as JAX runs f32 at HIGHEST: an f32 conv runs
with cuDNN's TF32 off in its forward and both gradients (`_ConvTrueF32`),
whatever the global flag says. Each of these scopes sets
``torch.backends.cudnn.allow_tf32`` for its own conv and puts it back, so
no conv of the port changes the process's flags.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F


def spatial_dims(x: torch.Tensor, dims: Optional[int] = None) -> int:
    """The number of spatial axes of a (B, *S, C) tensor: 2 or 3, as the
    JAX package's ``_dim_numbers``; other counts, or a ``dims`` that does not
    match the tensor, raise ValueError."""
    n = x.dim() - 2
    if n not in (2, 3) or (dims is not None and dims != n):
        raise ValueError(f"dims must be 2 or 3 and match the input, got "
                         f"dims={dims} for a {x.dim()}-d input")
    return n


def conv_init(generator: torch.Generator, kernel: int, in_ch: int,
              out_ch: int, *, dims: int = 2, use_bias: bool = True,
              param_dtype: torch.dtype = torch.float32,
              device: Optional[torch.device] = None) -> dict:
    """Glorot-uniform kernel (TF1 `tf.layers.conv2d` default) + zero bias.

    Drawn on the CPU from ``generator`` and then moved, so a seed gives the
    same weights on every device."""
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
    into an unrounded ``head_dtype`` output. Same-dtype heads: None.

    This is the TPU's DEFAULT pass. The JAX package on the CPU runs DEFAULT
    as true f32 and does not round the head weight, so the two differ there
    by the bf16 rounding of the head kernel (tests/test_torch_3d_model.py
    pins it). On the card the head conv runs in TF32 (`_ConvTF32`): exact
    on these bf16-rounded operands (TF32 keeps 10 mantissa bits, bf16 7),
    with f32 sums. Its gradients round the f32 incoming gradient to TF32,
    where the TPU's DEFAULT pass rounds it to bf16."""
    return compute_dtype if head_dtype != compute_dtype else None


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


@contextlib.contextmanager
def _cudnn_tf32(allow: bool):
    """cuDNN's ``allow_tf32`` set to ``allow`` for the enclosed convs only,
    then put back. Not ``torch.backends.cudnn.flags(allow_tf32=...)``: that
    context manager also sets every other flag to its own defaults, cuDNN
    disabled among them."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _tf32_convs():
    """TF32 allowed in cuDNN for the enclosed convs only."""
    return _cudnn_tf32(True)


def true_f32():
    """TF32 off in cuDNN for the enclosed convs only: f32 convs in true
    f32, as JAX's ``Precision.HIGHEST``."""
    return _cudnn_tf32(False)


def _conf(x, stride, padding, transposed):
    """``aten.convolution``'s arguments after the weight, for ``x``'s
    spatial axes (``stride``: one per axis)."""
    n = x.dim() - 2
    return (None, list(stride), list(padding), [1] * n, transposed, [0] * n, 1)


class _ConvF32WGrad(torch.autograd.Function):
    """``aten.convolution(x, w32.to(x.dtype))`` whose weight gradient is the
    f32 convolution of the upcast ``x`` and ``g`` (module docstring)."""

    @staticmethod
    def forward(ctx, x, w32, stride, padding, transposed):
        ctx.conf = _conf(x, stride, padding, transposed)
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


class _ConvTF32(torch.autograd.Function):
    """``aten.convolution(x, w)`` and its gradients with TF32 allowed: the
    raised head's f32 conv of bf16-rounded operands (`head_precision`).
    Stock autograd would follow the global flag, which a caller may have
    turned off, and cuDNN's true-f32 weight gradient of the config-4 head
    (16 -> 3 channels at 192^3) is a direct kernel many times slower than
    the TF32 one on the H100 (chip_smoke.py phase 9 times both; PERF.md)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, transposed):
        ctx.conf = _conf(x, stride, padding, transposed)
        ctx.save_for_backward(x, w)
        with _tf32_convs():
            return torch.ops.aten.convolution(x, w, *ctx.conf)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _tf32_convs():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, *ctx.conf, [ctx.needs_input_grad[0],
                                     ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None


class _ConvTrueF32(torch.autograd.Function):
    """``aten.convolution(x, w)`` and its gradients with TF32 off: the
    f32-compute conv in true f32 whatever the global flag says (torch
    allows TF32 in cuDNN by default)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, transposed):
        ctx.conf = _conf(x, stride, padding, transposed)
        ctx.save_for_backward(x, w)
        with true_f32():
            return torch.ops.aten.convolution(x, w, *ctx.conf)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with true_f32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, *ctx.conf, [ctx.needs_input_grad[0],
                                     ctx.needs_input_grad[1], False])
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


def conv_general(x: torch.Tensor, w: torch.Tensor, *, stride,
                 compute_dtype: torch.dtype, kind: str = "conv",
                 precision: Optional[torch.dtype] = None,
                 unpadded: Optional[int] = None,
                 padding=None) -> torch.Tensor:
    """The one conv entry point: (B, *S, C) x (*k, C, Co) -> (B, *S', Co),
    2 or 3 spatial axes.

    ``kind='conv'``: SAME conv at ``stride`` (an int, or one per spatial
    axis); ``padding``: explicit (lo, hi) pads instead of SAME, one pair
    for every axis or a pair per axis (the packed convs of ops/pack.py);
    ``kind='convt'``: SAME fractionally-strided conv (output ``stride`` x
    larger). 16-bit compute dtypes get the f32 weight gradient of
    `_ConvF32WGrad` (stock autograd when no weight gradient is taken); an
    explicit ``precision`` (see `head_precision`) runs `_ConvTF32`; f32
    compute runs `_ConvTrueF32`. ``unpadded`` (a conv's axis of ``x``, 1
    for H or D): that axis is not padded, its context came with ``x`` (a
    spatial shard's halo, parallel/halo.py)."""
    n = spatial_dims(x)
    strides = (stride,) * n if isinstance(stride, int) else tuple(stride)
    if precision is not None:  # round operands, compute in compute_dtype
        x = x.to(precision)
        w = _RoundOperand.apply(w, precision)
    x = x.to(compute_dtype)
    xn = x.permute(0, n + 1, *range(1, n + 1))  # (B, C, *S), channels-last
    if kind == "conv":
        if padding is None:
            pads = [_same_pads(xn.shape[2 + d], w.shape[d], strides[d])
                    for d in range(n)]
        elif isinstance(padding[0], int):
            pads = [tuple(padding)] * n
        else:
            pads = [tuple(p) for p in padding]
        if unpadded is not None:
            pads[unpadded - 1] = (0, 0)
        if any(lo != hi for lo, hi in pads):
            # asymmetric: pad (last axis first, as F.pad takes it), then
            # cuDNN pads 0
            xn = F.pad(xn, [p for lo_hi in reversed(pads) for p in lo_hi])
            pads = [(0, 0)] * n
        wn = w.permute(n + 1, n, *range(n))  # (Co, C, *k)
        padding, transposed = tuple(lo for lo, _ in pads), False
    elif kind == "convt":
        # (C_in, C_out, *k), spatially flipped
        wn = w.flip(*range(n)).permute(n, n + 1, *range(n))
        padding, transposed = (0,) * n, True
    else:
        raise ValueError(f"unknown conv kind {kind!r}")
    if precision is not None:
        y = _ConvTF32.apply(xn, wn.to(compute_dtype), strides, padding,
                            transposed)
    elif (compute_dtype.itemsize < 4 and torch.is_grad_enabled()
          and w.requires_grad):
        y = _ConvF32WGrad.apply(xn, wn.float(), strides, padding, transposed)
    elif compute_dtype == torch.float32:
        y = _ConvTrueF32.apply(xn, wn.to(compute_dtype), strides, padding,
                               transposed)
    else:
        y = torch.ops.aten.convolution(
            xn, wn.to(compute_dtype), *_conf(xn, strides, padding, transposed))
    if kind == "convt":
        y = y[(slice(None), slice(None))
              + tuple(slice(0, x.shape[1 + d] * strides[d]) for d in range(n))]
    return y.permute(0, *range(2, n + 2), 1)


def conv(x: torch.Tensor, params: dict, *, stride: int = 1, dims: int = 2,
         compute_dtype: torch.dtype = torch.bfloat16,
         precision: Optional[torch.dtype] = None) -> torch.Tensor:
    """SAME-padded conv in ``compute_dtype``: (B, *S, C) -> (B, *S/s, Co),
    ``dims`` (2 or 3) spatial axes.

    ``precision``: see `head_precision`."""
    spatial_dims(x, dims)
    y = conv_general(x, params["w"], stride=stride, compute_dtype=compute_dtype,
                     precision=precision)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def conv_transpose(x: torch.Tensor, params: dict, *, stride: int = 2,
                   dims: int = 2,
                   compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """SAME fractionally-strided conv: (B, *S, C) -> (B, s*S, Co), equal to
    ``lax.conv_transpose(..., padding='SAME')``."""
    spatial_dims(x, dims)
    y = conv_general(x, params["w"], stride=stride, compute_dtype=compute_dtype,
                     kind="convt")
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y
