"""Fused 3x3 conv + affine (+ residual) (+ ReLU): CUDA kernel wrapper and its
plain version.

Port of uresnet_tpu/ops/pallas/conv2d.py::fused_conv3x3_bn_relu_v2; the
kernels are csrc/conv2d.cu. ``block_h`` is gone: it was TPU tiling. The v1
Pallas kernel ``fused_conv3x3_bn_relu`` computes the same function with
another TPU blocking; its name is bound here to the same kernels and plain
version.

A CUDA call goes to one of two kernels, chosen by dtype and shape alone
(`uses_tensor_cores`): bf16 with C and Co multiples of 16 — every conv of
the serving forward — runs the tensor-core kernel; f32 (true f32, never
TF32) and other channel counts run the CUDA-core kernel.

Both wrappers launch a kernel for CUDA tensors — or raise; they never fall
back — and run the plain version for CPU tensors. ``launches`` (v2) and
``launches_v1`` count launches by entry point, ``launches_tensor_core`` and
``launches_cuda_core`` by kernel (plain-version calls count nowhere), so a
run can show which kernel served its path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

launches = 0
launches_v1 = 0
launches_tensor_core = 0
launches_cuda_core = 0

# the CUDA-core kernel's entry by dtype; the tensor-core kernel's entry
_ENTRY = {torch.float32: "uresnet_fused_conv3x3_f32",
          torch.bfloat16: "uresnet_fused_conv3x3_bf16"}
_TC_ENTRY = "uresnet_fused_conv3x3_bf16_tc"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (csrc/conv2d.cu)."""
    from uresnet_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    for name in (*_ENTRY.values(), _TC_ENTRY):
        fn = getattr(lib, name)
        # x, w, scale, bias, residual, out; B, H, W, C, Co, relu; stream
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.uresnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.uresnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_conv3x3_bn_relu_v2_reference(x, w, scale, bias, residual=None, *,
                                       relu: bool = True) -> torch.Tensor:
    """Plain version: f32 conv of the upcast inputs, the same f32 epilogue,
    one cast to x's dtype."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    y = y * scale.float() + bias.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _check(x, w, scale, bias, residual):
    if x.dtype not in _ENTRY:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    B, H, W, C = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"w must be (3, 3, {C}, Co), got {tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"w dtype {w.dtype} != x dtype {x.dtype}")
    Co = w.shape[3]
    for name, v in (("scale", scale), ("bias", bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (Co,):
            raise ValueError(f"{name} must be float32 ({Co},), got "
                             f"{v.dtype} {tuple(v.shape)}")
    if residual is not None and (tuple(residual.shape) != (B, H, W, Co)
                                 or residual.dtype != x.dtype):
        raise ValueError(f"residual must be {x.dtype} {(B, H, W, Co)}, got "
                         f"{residual.dtype} {tuple(residual.shape)}")
    return B, H, W, C, Co


def uses_tensor_cores(dtype: torch.dtype, C: int, Co: int) -> bool:
    """Whether a CUDA call runs the tensor-core kernel: bf16 with C and Co
    multiples of 16 (the bf16 MMA's depth and the kernel's channel tiles).
    Otherwise the CUDA-core kernel runs."""
    return dtype == torch.bfloat16 and C % 16 == 0 and Co % 16 == 0


def _fused(x, w, scale, bias, residual, relu):
    """(output, whether a kernel was launched)."""
    B, H, W, C, Co = _check(x, w, scale, bias, residual)
    if x.device.type == "cpu":
        return fused_conv3x3_bn_relu_v2_reference(x, w, scale, bias, residual,
                                                  relu=relu), False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    tensors = (x, w, scale, bias) + ((residual,) if residual is not None else ())
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous and on "
                             f"{x.device}")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid limit 65535")
    out = torch.empty((B, H, W, Co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out, False
    lib = _lib()
    tensor_core = uses_tensor_cores(x.dtype, C, Co)
    if tensor_core and any(t.data_ptr() % 16 for t in tensors + (out,)):
        raise ValueError("the tensor-core kernel needs 16-byte aligned "
                         "operands (a tensor starts inside its storage)")
    fn = getattr(lib, _TC_ENTRY if tensor_core else _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 out.data_ptr(), B, H, W, C, Co, int(relu), stream)
    if err != 0:
        msg = lib.uresnet_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_conv3x3 launch failed: CUDA error {err} ({msg})")
    global launches_tensor_core, launches_cuda_core
    if tensor_core:
        launches_tensor_core += 1
    else:
        launches_cuda_core += 1
    return out, True


def fused_conv3x3_bn_relu_v2(x: torch.Tensor, w: torch.Tensor,
                             scale: torch.Tensor, bias: torch.Tensor,
                             residual: Optional[torch.Tensor] = None, *,
                             relu: bool = True) -> torch.Tensor:
    """y = relu?(conv3x3_SAME(x, w) * scale + bias [+ residual]), NHWC.

    x (B, H, W, C) f32/bf16; w (3, 3, C, Co) in x's dtype; scale, bias
    (Co,) f32; residual (B, H, W, Co) in x's dtype or None. f32
    accumulation, one write in x's dtype."""
    out, launched = _fused(x, w, scale, bias, residual, relu)
    global launches
    launches += launched
    return out


# v1 (uresnet_tpu/ops/pallas/conv2d.py:182): the same function, so the same
# kernels and the same plain version.
fused_conv3x3_bn_relu_reference = fused_conv3x3_bn_relu_v2_reference


def fused_conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor,
                          residual: Optional[torch.Tensor] = None, *,
                          relu: bool = True) -> torch.Tensor:
    """The v1 entry point: `fused_conv3x3_bn_relu_v2`'s kernels and
    operands, counted in ``launches_v1``."""
    out, launched = _fused(x, w, scale, bias, residual, relu)
    global launches_v1
    launches_v1 += launched
    return out
