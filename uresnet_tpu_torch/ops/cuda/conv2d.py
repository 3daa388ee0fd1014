"""Fused 3x3 conv + affine (+ residual) (+ ReLU): CUDA kernel wrapper and its
plain version, registered as PyTorch operators.

Port of uresnet_tpu/ops/pallas/conv2d.py::fused_conv3x3_bn_relu_v2, for
each dtype the Pallas function takes that the port computes in (bf16, f16,
f32); the kernels are csrc/conv2d.cu and csrc/conv2d_f32tc.cu. ``block_h`` is gone:
it was TPU tiling. The v1 Pallas kernel ``fused_conv3x3_bn_relu`` computes
the same function with another TPU blocking; its name is bound here to the
same kernels and plain version.

Both entry points are ``torch.library`` custom ops,
``uresnet_tpu_torch::fused_conv3x3_bn_relu_v2`` and
``uresnet_tpu_torch::fused_conv3x3_bn_relu``, with one set of
implementations: on CUDA the kernel launch, on the CPU the plain version,
and a fake implementation that gives the output's shape and dtype for
tracing. So ``torch.export`` keeps the op as one node of the graph
(engine/export.py), and a loaded artifact launches the same kernel. Importing
this module registers them.

A CUDA call goes to one of three tensor-core kernels, named by `kernel_for`
from the dtype alone; each takes any H, W, C >= 1 and Co >= 1 (channel
counts that are not multiples of the MMA's depth run the kernel's
channel-tail form, zero-filled and masked in the kernel):

* ``'tensor_core'`` — bf16, every conv of the bf16 serving forward: bf16
  MMAs (csrc/conv2d.cu).
* ``'f16_tensor_core'`` — f16: the same kernel with the f16 MMA.
* ``'f32_tensor_core'`` — f32, every conv of the f32 serving forward: the
  3xTF32 kernel (csrc/conv2d_f32tc.cu; wgmma where C is a multiple of 8
  and Co of 32, mma.sync otherwise). Each f32 operand is split into
  hi = tf32(a) and lo = tf32(a - hi), and three TF32 MMAs (lo*hi + hi*lo +
  hi*hi) sum into f32, which keeps f32's accuracy (~5e-7 of the max
  against float64 at K = 9*C up to 4608). One TF32 product (1xTF32) would
  not: ~3e-4. So f32 stays true f32.

On a CUDA tensor an op launches its kernel or raises; it never falls back
to another kernel or to the plain version. On a CPU tensor it runs the
plain version. The counters are bumped inside the CUDA implementation,
where a kernel is launched, so launches from a loaded artifact count too:
``launches`` (v2) and ``launches_v1`` by entry point,
``launches_tensor_core``, ``launches_f16_tensor_core`` and
``launches_f32_tensor_core`` by kernel (plain-version calls count
nowhere), so a run can show which kernel served its path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from uresnet_tpu_torch.ops.conv import true_f32

launches = 0
launches_v1 = 0
launches_tensor_core = 0
launches_f16_tensor_core = 0
launches_f32_tensor_core = 0

# the kernel of each dtype, and each kernel's C entry
_KERNEL = {torch.bfloat16: "tensor_core", torch.float16: "f16_tensor_core",
           torch.float32: "f32_tensor_core"}
_ENTRY = {"tensor_core": "uresnet_fused_conv3x3_bf16_tc",
          "f16_tensor_core": "uresnet_fused_conv3x3_f16_tc",
          "f32_tensor_core": "uresnet_fused_conv3x3_f32_tc"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (csrc/*.cu)."""
    from uresnet_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        # x, w, scale, bias, residual, out; B, H, W, C, Co, relu; stream
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.uresnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.uresnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_conv3x3_bn_relu_v2_reference(x, w, scale, bias, residual=None, *,
                                       relu: bool = True) -> torch.Tensor:
    """Plain version: f32 conv of the upcast inputs (true f32: cuDNN's TF32
    off for it), the same f32 epilogue, one cast to x's dtype."""
    with true_f32():
        y = F.conv2d(x.float().permute(0, 3, 1, 2),
                     w.float().permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    y = y * scale.float() + bias.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _check(x, w, scale, bias, residual):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _KERNEL:
        raise TypeError(f"x must be float32, bfloat16 or float16, got {x.dtype}")
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


def kernel_for(dtype: torch.dtype, C: int, Co: int) -> str:
    """The kernel a CUDA call runs: 'tensor_core' for bf16,
    'f16_tensor_core' for f16, 'f32_tensor_core' for f32, at every C and
    Co (each kernel picks its own tile configuration from them)."""
    return _KERNEL[dtype]


def _launch(x, w, scale, bias, residual, relu, entry: str) -> torch.Tensor:
    """The CUDA implementation: one launch of the kernel `kernel_for`
    names, on the current stream, counted by kernel and in the module
    global ``entry`` (the entry point's counter). Raises on operands the
    kernel does not take and on a failed launch."""
    B, H, W, C, Co = _check(x, w, scale, bias, residual)
    tensors = (x, w, scale, bias) + ((residual,) if residual is not None else ())
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous and on "
                             f"{x.device}")
    out = torch.empty((B, H, W, Co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    kernel = kernel_for(x.dtype, C, Co)
    if any(t.data_ptr() % 16 for t in tensors + (out,)):
        raise ValueError(f"the {kernel} kernel needs 16-byte aligned "
                         "operands (a tensor starts inside its storage)")
    fn = getattr(lib, _ENTRY[kernel])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 out.data_ptr(), B, H, W, C, Co, int(relu), stream)
    if err != 0:
        msg = lib.uresnet_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_conv3x3 launch failed: CUDA error {err} ({msg})")
    globals()[f"launches_{kernel}"] += 1
    globals()[entry] += 1
    return out


_SCHEMA = ("(Tensor x, Tensor w, Tensor scale, Tensor bias, Tensor? residual, "
           "bool relu) -> Tensor")


def _register(name: str, counter: str):
    """The op ``uresnet_tpu_torch::<name>``: the plain version on the CPU,
    `_launch` on CUDA (counted in ``counter``), an empty output of the
    right shape and dtype when traced."""

    def cpu(x, w, scale, bias, residual, relu):
        return fused_conv3x3_bn_relu_v2_reference(
            x, w, scale, bias, residual, relu=relu).contiguous()

    op = torch.library.custom_op(f"uresnet_tpu_torch::{name}", cpu,
                                 mutates_args=(), device_types="cpu",
                                 schema=_SCHEMA)

    @op.register_kernel("cuda")
    def _(x, w, scale, bias, residual, relu):
        return _launch(x, w, scale, bias, residual, relu, counter)

    @op.register_fake
    def _(x, w, scale, bias, residual, relu):
        return x.new_empty((*x.shape[:3], w.shape[3]))

    return op


_op_v2 = _register("fused_conv3x3_bn_relu_v2", "launches")
_op_v1 = _register("fused_conv3x3_bn_relu", "launches_v1")


def fused_conv3x3_bn_relu_v2(x: torch.Tensor, w: torch.Tensor,
                             scale: torch.Tensor, bias: torch.Tensor,
                             residual: Optional[torch.Tensor] = None, *,
                             relu: bool = True) -> torch.Tensor:
    """y = relu?(conv3x3_SAME(x, w) * scale + bias [+ residual]), NHWC.

    x (B, H, W, C) f32/bf16/f16; w (3, 3, C, Co) in x's dtype; scale, bias
    (Co,) f32; residual (B, H, W, Co) in x's dtype or None. f32
    accumulation, one write in x's dtype. Checks the operands, then calls
    the op ``uresnet_tpu_torch::fused_conv3x3_bn_relu_v2``."""
    _check(x, w, scale, bias, residual)
    return _op_v2(x, w, scale, bias, residual, relu)


# v1 (uresnet_tpu/ops/pallas/conv2d.py:182): the same function, so the same
# kernels and the same plain version.
fused_conv3x3_bn_relu_reference = fused_conv3x3_bn_relu_v2_reference


def fused_conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor,
                          residual: Optional[torch.Tensor] = None, *,
                          relu: bool = True) -> torch.Tensor:
    """The v1 entry point: `fused_conv3x3_bn_relu_v2`'s operands and
    implementations under the op ``uresnet_tpu_torch::fused_conv3x3_bn_relu``,
    counted in ``launches_v1``."""
    _check(x, w, scale, bias, residual)
    return _op_v1(x, w, scale, bias, residual, relu)
