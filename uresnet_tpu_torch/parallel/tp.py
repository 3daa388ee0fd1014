"""Tensor (channel) parallelism over the mesh's model axis (port of
uresnet_tpu/parallel/tp.py).

Storage follows the JAX package's leaf rule (`tp_spec`): every conv
kernel ``w`` (``*k, Cin, Cout``) holds a slice of its output channels,
and every channel vector (BN ``scale``/``bias``, conv bias ``b``, BN
running ``mean``/``var``) the matching slice; Adam's moments mirror the
params. A leaf whose dim the model axis does not divide stays whole (the
``num_class`` head). `shard_state` and `gather_state` move a flat train
state between the two.

The JAX package lets GSPMD place the collectives. Here they are explicit,
in the Megatron form of column-parallel convs: a conv takes its whole
input (every channel, `gather_channels`) and computes its own output
slice; the BN statistics of a slice are whole on its rank. Each rank's
autograd sees only its own slice's path, so the gradient of a tensor that
feeds column-parallel convs is a partial sum over the model ranks:
`copy_to_model` (identity forward, SUM all-reduce backward) completes it.
A tensor that feeds a replicated op (the whole head) already has its whole
gradient on every rank, so `gather_channels`' backward only slices.

`conv_col` and `conv_row` are the explicit pair of the JAX module:
conv_col -> (elementwise) -> conv_row equals the unsharded pair with one
all-reduce.

The collectives are ``all_gather`` (list form) and ``all_reduce``, which
both NCCL and gloo take for CUDA tensors; a reduce-scatter is an
all-reduce and a slice.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from uresnet_tpu_torch.ops.conv import conv
from uresnet_tpu_torch.parallel.mesh import Axis

CHANNEL_LEAVES = ("scale", "bias", "b", "mean", "var")


def tp_spec(name: str, shape: Sequence[int]) -> Optional[int]:
    """The dim a train-state leaf is sharded on under tensor parallelism,
    or None (replicated), by its leaf name (the last '.' or '/' part):
    conv kernels ``w`` with ndim >= 3 on Cout (the last dim), channel
    vectors on dim 0. Everything else (the key, step counters) is
    replicated; Adam's moments carry their param's leaf name."""
    leaf = name.replace("/", ".").rsplit(".", 1)[-1]
    if leaf == "w" and len(shape) >= 3:
        return len(shape) - 1
    if leaf in CHANNEL_LEAVES and len(shape) == 1:
        return 0
    return None


def shard_dims(shapes: Mapping[str, Sequence[int]], n: int) -> Dict[str, int]:
    """{leaf: dim} of the leaves that are sharded over ``n`` model ranks,
    from their whole shapes: `tp_spec`'s dim where ``n`` divides it."""
    out = {}
    for name, shape in shapes.items():
        dim = tp_spec(name, shape)
        if n > 1 and dim is not None and shape[dim] % n == 0:
            out[name] = dim
    return out


def local_slice(t, dim: int, axis: Axis):
    """This rank's slice of a whole tensor or numpy array along ``dim``."""
    size = t.shape[dim] // axis.size
    index = (slice(None),) * dim + (slice(axis.index * size,
                                          (axis.index + 1) * size),)
    return t[index]


def shard_state(flat: Mapping[str, object], axis: Axis) -> Dict[str, object]:
    """Whole leaves (tensors or numpy) -> this rank's: a copy of the slice
    of every sharded leaf, the others as given."""
    dims = shard_dims({k: v.shape for k, v in flat.items()}, axis.size)
    out = {}
    for k, v in flat.items():
        if k in dims:
            s = local_slice(v, dims[k], axis)
            v = s.clone() if torch.is_tensor(s) else s.copy()
        out[k] = v
    return out


@torch.no_grad()
def gather_state(flat: Mapping[str, torch.Tensor], dims: Mapping[str, int],
                 axis: Axis) -> Dict[str, torch.Tensor]:
    """This rank's leaves -> the whole ones, on every rank of the model
    axis: the leaves of ``dims`` (`shard_dims` of the whole shapes) are
    gathered, one all-gather per dtype; the others are returned as given."""
    out = dict(flat)
    if axis.group is None:
        return out
    by_dtype: Dict[torch.dtype, list] = {}
    for k in flat:
        if k in dims:
            by_dtype.setdefault(flat[k].dtype, []).append(k)
    for keys in by_dtype.values():
        buf = torch.cat([flat[k].reshape(-1) for k in keys])
        parts = [torch.empty_like(buf) for _ in range(axis.size)]
        dist.all_gather(parts, buf, group=axis.group)
        sizes = [flat[k].numel() for k in keys]
        pieces = [p.split(sizes) for p in parts]
        for i, k in enumerate(keys):
            out[k] = torch.cat([pc[i].view_as(flat[k]) for pc in pieces],
                               dims[k])
    return out


# -- differentiable collectives ---------------------------------------------------


def _all_gather(x: torch.Tensor, axis: Axis):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return parts


def _all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis.group)
    return x


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.width = axis, x.shape[-1]
        return torch.cat(_all_gather(x, axis), -1)

    @staticmethod
    def backward(ctx, g):
        i = ctx.axis.index * ctx.width
        return g[..., i:i + ctx.width], None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_channels(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(..., C/n) slices -> (..., C) in the whole channel order on every
    rank of the model axis. Backward: this rank's slice of the gradient,
    which must be whole on every rank (a replicated consumer, or
    `copy_to_model` after this)."""
    return x if axis.group is None else _GatherChannels.apply(x, axis)


def copy_to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Identity forward; backward sums the ranks' partial gradients (the
    input of column-parallel convs)."""
    return x if axis.group is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """SUM over the model axis forward (the partial products of
    row-parallel convs); identity backward (the sum is replicated, each
    rank's gradient of it is whole)."""
    return x if axis.group is None else _ReduceFromModel.apply(x, axis)


def conv_col(x: torch.Tensor, w: torch.Tensor, axis: Axis, *, dims: int = 2,
             compute_dtype=torch.float32) -> torch.Tensor:
    """Column-parallel SAME conv: ``x`` whole (every channel, the same on
    every rank), ``w`` this rank's Cout slice; the output is this rank's
    channel slice. No communication forward."""
    return conv(copy_to_model(x, axis), {"w": w}, dims=dims,
                compute_dtype=compute_dtype)


def conv_row(x: torch.Tensor, w: torch.Tensor, axis: Axis, *, dims: int = 2,
             compute_dtype=torch.float32) -> torch.Tensor:
    """Row-parallel SAME conv: ``x`` this rank's channel slice, ``w`` the
    matching Cin rows; the partial sums meet in one all-reduce."""
    return reduce_from_model(conv(x, {"w": w}, dims=dims,
                                  compute_dtype=compute_dtype), axis)
