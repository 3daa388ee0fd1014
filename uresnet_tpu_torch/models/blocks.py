"""U-ResNet building blocks as nn.Modules (port of uresnet_tpu/models/blocks.py).

  residual block = conv3-BN-ReLU -> conv3-BN, projection shortcut (1x1 conv)
  on channel mismatch, add, ReLU;
  downsample = stride-2 conv3 + BN + ReLU;
  upsample = stride-2 transpose conv + BN + ReLU.

Parameter and buffer names follow the JAX param/state trees
(``cb1.conv.w``, ``cb1.bn.scale``, buffer ``cb1.bn.mean``), so a module's
state dict and a JAX checkpoint name the same leaves (models/convert.py).

Every unit returns ``(y, new_state)``, the unit's BN-state subtree as the
JAX functions return it. In train mode the new stats are new tensors; no
buffer is written during the forward (the trainer copies them in after
the step). In eval mode ``new_state`` holds the buffers themselves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from uresnet_tpu_torch.ops.conv import (conv, conv_init, conv_transpose,
                                        spatial_dims)
from uresnet_tpu_torch.ops.norm import batch_norm, batch_norm_train, bn_init
from uresnet_tpu_torch.ops.pack import conv_packed
from uresnet_tpu_torch.parallel.halo import sharded_conv
from uresnet_tpu_torch.parallel.mesh import Mesh
from uresnet_tpu_torch.parallel.tp import copy_to_model, gather_channels


@dataclass(frozen=True)
class BlockCtx:
    """Static per-call context: dims, compute dtype, BN hyperparameters,
    train or eval, and the parallel mesh (parallel/mesh.py; None: one
    process). ``conv_packed`` runs the packed layout's convs
    (models/packed.py).

    Under the mesh the train-mode BN statistics span its batch group. With
    a spatial axis every conv is the halo conv of parallel/halo.py on this
    rank's rows. With a model axis every conv is column-parallel
    (parallel/tp.py): it takes its whole input, `full`, and computes this
    rank's slice of its output channels, so activations between convs are
    channel slices."""

    dims: int = 2
    compute_dtype: torch.dtype = torch.bfloat16
    bn_eps: float = 1e-3
    bn_momentum: float = 0.99
    train: bool = False
    mesh: Optional[Mesh] = None

    @property
    def group(self):
        """The process group of the train-mode BN statistics."""
        return None if self.mesh is None else self.mesh.batch.group

    def _sliced(self, x, width: int) -> bool:
        return (self.mesh is not None and self.mesh.model > 1
                and x.shape[-1] != width)

    def full(self, x, width: int):
        """``x`` with all its ``width`` channels, as the input of
        column-parallel convs: a channel slice is gathered and its
        gradient summed over the model ranks; a whole tensor passes."""
        if not self._sliced(x, width):
            return x
        axis = self.mesh.model_axis
        return copy_to_model(gather_channels(x, axis), axis)

    def gather(self, x, width: int):
        """``x`` with all its ``width`` channels, as the input of a
        replicated op: a channel slice is gathered, its gradient sliced."""
        if not self._sliced(x, width):
            return x
        return gather_channels(x, self.mesh.model_axis)

    def conv(self, x, p, stride=1, *, compute_dtype=None, precision=None):
        cd = compute_dtype or self.compute_dtype
        if self.mesh is None or self.mesh.spatial == 1:
            return conv(x, p, stride=stride, dims=self.dims, compute_dtype=cd,
                        precision=precision)
        return self._halo(x, p, stride, "conv", cd, precision)

    def conv_t(self, x, p, stride=2):
        if self.mesh is None or self.mesh.spatial == 1:
            return conv_transpose(x, p, stride=stride, dims=self.dims,
                                  compute_dtype=self.compute_dtype)
        return self._halo(x, p, stride, "convt", self.compute_dtype, None)

    def conv_packed(self, x, w, *, padding="SAME", stride=1,
                    compute_dtype=None, precision=None):
        """A packed conv of ops/pack.py (``padding`` 'SAME' or explicit
        pads); with a spatial axis the halo conv of its pads on this rank's
        packed rows."""
        cd = compute_dtype or self.compute_dtype
        if self.mesh is None or self.mesh.spatial == 1:
            return conv_packed(x, w, padding=padding, stride=stride,
                               compute_dtype=cd, precision=precision)
        spatial_dims(x, self.dims)
        return sharded_conv(x, w, axis=self.mesh.spatial_axis, stride=stride,
                            compute_dtype=cd, precision=precision,
                            padding=None if padding == "SAME" else padding)

    def _halo(self, x, p, stride, kind, compute_dtype, precision):
        spatial_dims(x, self.dims)
        y = sharded_conv(x, p["w"], axis=self.mesh.spatial_axis,
                         stride=stride, kind=kind,
                         compute_dtype=compute_dtype, precision=precision)
        if "b" in p:
            y = y + p["b"].to(y.dtype)
        return y


class Conv(nn.Module):
    """Kernel ``w`` (*k, C_in, C_out), 2D or 3D, and optional bias ``b``."""

    def __init__(self, kernel: int, in_ch: int, out_ch: int, *,
                 generator: torch.Generator, dims: int, use_bias: bool,
                 param_dtype: torch.dtype,
                 device: Optional[torch.device] = None):
        super().__init__()
        for k, v in conv_init(generator, kernel, in_ch, out_ch, dims=dims,
                              use_bias=use_bias, param_dtype=param_dtype,
                              device=device).items():
            self.register_parameter(k, nn.Parameter(v))

    def params(self) -> dict:
        return dict(self._parameters)


class BatchNorm(nn.Module):
    """Affine params ``scale``/``bias``; running stats as buffers."""

    def __init__(self, ch: int, *, param_dtype: torch.dtype,
                 device: Optional[torch.device] = None):
        super().__init__()
        params, state = bn_init(ch, param_dtype, device)
        for k, v in params.items():
            self.register_parameter(k, nn.Parameter(v))
        for k, v in state.items():
            self.register_buffer(k, v)

    def forward(self, x, ctx: BlockCtx, phases: int = 1, *,
                relu: bool = False, residual=None):
        """relu?(BN(x) [+ residual]); ``phases``: ``x`` is space-to-depth
        packed (ops/norm.py)."""
        params, state = dict(self._parameters), dict(self._buffers)
        if ctx.train:
            return batch_norm_train(x, params, state, momentum=ctx.bn_momentum,
                                    eps=ctx.bn_eps, group=ctx.group,
                                    phases=phases, relu=relu,
                                    residual=residual)
        y = batch_norm(x, params, state, eps=ctx.bn_eps, phases=phases)
        if residual is not None:
            y = y + residual.to(y.dtype)
        return (torch.relu(y) if relu else y), state


class ConvBN(nn.Module):
    def __init__(self, kernel: int, in_ch: int, out_ch: int, *,
                 generator: torch.Generator, dims: int,
                 param_dtype: torch.dtype,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.conv = Conv(kernel, in_ch, out_ch, generator=generator,
                         dims=dims, use_bias=False, param_dtype=param_dtype,
                         device=device)
        self.bn = BatchNorm(out_ch, param_dtype=param_dtype, device=device)

    def forward(self, x, ctx: BlockCtx, *, stride=1, relu=True,
                transpose=False, residual=None):
        """relu?(BN(conv(x)) [+ residual])."""
        x = ctx.full(x, self.conv.w.shape[-2])
        if transpose:
            y = ctx.conv_t(x, self.conv.params(), stride=stride)
        else:
            y = ctx.conv(x, self.conv.params(), stride=stride)
        y, bn_state = self.bn(y, ctx, relu=relu, residual=residual)
        return y, {"bn": bn_state}


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, *, generator: torch.Generator,
                 dims: int, param_dtype: torch.dtype,
                 device: Optional[torch.device] = None):
        super().__init__()
        kw = dict(generator=generator, dims=dims, param_dtype=param_dtype,
                  device=device)
        self.cb1 = ConvBN(3, in_ch, out_ch, **kw)
        self.cb2 = ConvBN(3, out_ch, out_ch, **kw)
        self.proj = (Conv(1, in_ch, out_ch, use_bias=False, **kw)
                     if in_ch != out_ch else None)

    def forward(self, x, ctx: BlockCtx):
        xf = ctx.full(x, self.cb1.conv.w.shape[-2])  # cb1's and proj's input
        y, s1 = self.cb1(xf, ctx)
        shortcut = x if self.proj is None else ctx.conv(xf, self.proj.params())
        y, s2 = self.cb2(y, ctx, residual=shortcut)
        return y, {"cb1": s1, "cb2": s2}
