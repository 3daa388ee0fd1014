"""Spatial-domain decomposition with halo exchange (port of
uresnet_tpu/parallel/halo.py).

One spatial dim (H in 2D, D in 3D: dim 1 of a (B, *S, C) tensor) is split
over the mesh's spatial axis; each rank holds a contiguous block of rows,
rank order along the axis. Before each conv a rank fetches the rows its
outputs read from its neighbours (zeros at the global edge, as SAME pads)
and convolves without padding that dim: the sharded conv equals the
unsharded SAME conv.

SAME conv, kernel k, stride s (global extent a multiple of s): it pads
max(k - s, 0) split (floor, ceil), so global output o reads input rows
[o*s - lo, o*s - lo + k). A shard owning rows [r0, r0 + n) with r0 % s == 0
owns outputs [r0/s, (r0 + n)/s) and needs ``lo`` rows before r0 and
``k - s - lo`` after its end (`same_halo`).

SAME transposed conv, stride s (ops/conv.py: the transposed conv of the
flipped kernel, cropped to the first s*S): output o sums input rows i with
o - s*i in [0, k), so the outputs [s*r0, s*(r0 + n)) of a shard read rows
[r0 - (k-1)//s, r0 + n): ``(k-1)//s`` rows from the previous shard and
none from the next (`transpose_halo`; for the model's 3-tap stride-2
``up`` convs, one row from the previous shard).

The packed layout's convs (ops/pack.py, models/packed.py) pad explicitly,
and their halo is the sharded dim's pads: the packed stride-1 k=3 conv
(1, 1), one packed row from each side; the packed down conv (k=2, (0, 1))
one row from the next shard; the packed up conv (k=2, (1, 0)) one row from
the previous. The relayouts between them stay local: a shard's rows start
on an even row at every packed level, so its space-to-depth is its share
of the global one.

The exchange is an ``all_gather`` (list form) of every rank's edge rows
over the spatial group, which NCCL and gloo both take for CUDA tensors
(gloo has no send/recv for them); its backward returns each halo row's
gradient to its owner the same way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from uresnet_tpu_torch.ops.conv import conv_general
from uresnet_tpu_torch.parallel.mesh import Axis


def same_halo(kernel: int, stride: int) -> Tuple[int, int]:
    """(halo_lo, halo_hi) a shard needs along the sharded dim for a SAME
    conv."""
    total = max(kernel - stride, 0)
    lo = total // 2
    return lo, total - lo


def transpose_halo(kernel: int, stride: int) -> Tuple[int, int]:
    """(halo_lo, halo_hi) a shard needs along the sharded dim for a SAME
    transposed conv (module docstring)."""
    return (kernel - 1) // stride, 0


def _rows(x: torch.Tensor, dim: int, start: int, stop: int) -> torch.Tensor:
    return x.narrow(dim, start, stop - start)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, dim, axis):
        ctx.lo, ctx.hi, ctx.dim, ctx.axis = lo, hi, dim, axis
        n = x.shape[dim]
        # every rank's [first hi rows, last lo rows]
        parts = _gather(torch.cat([_rows(x, dim, 0, hi),
                                   _rows(x, dim, n - lo, n)], dim), axis)
        i, last = axis.index, axis.size - 1
        ext = []
        if lo:  # the previous shard's last lo rows
            ext.append(_rows(parts[i - 1], dim, hi, hi + lo) if i > 0
                       else x.new_zeros(_shape(x, dim, lo)))
        ext.append(x)
        if hi:  # the next shard's first hi rows
            ext.append(_rows(parts[i + 1], dim, 0, hi) if i < last
                       else x.new_zeros(_shape(x, dim, hi)))
        return torch.cat(ext, dim)

    @staticmethod
    def backward(ctx, g):
        lo, hi, dim, axis = ctx.lo, ctx.hi, ctx.dim, ctx.axis
        n = g.shape[dim] - lo - hi
        # every rank's gradients of the rows it received: [prev's, next's]
        parts = _gather(torch.cat([_rows(g, dim, 0, lo),
                                   _rows(g, dim, lo + n, lo + n + hi)], dim),
                        axis)
        dx = _rows(g, dim, lo, lo + n).clone()
        i, last = axis.index, axis.size - 1
        if lo and i < last:  # our last lo rows were the next shard's prev
            _rows(dx, dim, n - lo, n).add_(_rows(parts[i + 1], dim, 0, lo))
        if hi and i > 0:  # our first hi rows were the previous one's next
            _rows(dx, dim, 0, hi).add_(_rows(parts[i - 1], dim, lo, lo + hi))
        return dx, None, None, None, None


def _shape(x, dim, rows):
    shape = list(x.shape)
    shape[dim] = rows
    return shape


def _gather(t: torch.Tensor, axis: Axis):
    t = t.contiguous()
    if axis.group is None:
        return [t]
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return parts


def halo_exchange(x: torch.Tensor, lo: int, hi: int, dim: int,
                  axis: Axis) -> torch.Tensor:
    """Extend this rank's shard along ``dim`` with ``lo`` rows from the
    previous rank of ``axis`` and ``hi`` from the next (zeros at the global
    edge). Differentiable: the halo rows' gradients go back to their
    owners."""
    if lo == 0 and hi == 0:
        return x
    if max(lo, hi) > x.shape[dim]:
        # halos come from the IMMEDIATE neighbours only; a kernel whose
        # reach spans more than one shard would need multi-hop exchange
        raise ValueError(
            f"halo ({lo},{hi}) exceeds the local shard extent "
            f"{x.shape[dim]} along axis {dim}; use fewer 'spatial' shards "
            f"or a smaller kernel")
    return _HaloExchange.apply(x, lo, hi, dim, axis)


def sharded_conv(x: torch.Tensor, w: torch.Tensor, *, axis: Axis,
                 stride=1, kind: str = "conv",
                 compute_dtype: torch.dtype = torch.float32,
                 precision: Optional[torch.dtype] = None,
                 dim: int = 1, padding=None) -> torch.Tensor:
    """SAME conv (``kind='conv'``) or SAME transposed conv (``'convt'``)
    of this rank's shard ``x`` (B, *S, C), split along ``dim`` over
    ``axis``, with the whole kernel ``w``: this rank's shard of the
    unsharded conv's output. A strided conv needs a local extent that the
    stride divides (every shard then starts on a stride phase).

    ``padding`` (explicit (lo, hi) pads of ops/conv.py ``conv_general``:
    the packed convs of ops/pack.py): the halo is the sharded dim's pads,
    as SAME's halo is its pads. ``stride`` may be one per axis (the
    H-packed up conv strides H alone)."""
    k = w.shape[dim - 1]
    s = stride if isinstance(stride, int) else stride[dim - 1]
    if kind == "convt":
        lo, hi = transpose_halo(k, stride)
        y = conv_general(halo_exchange(x, lo, hi, dim, axis), w,
                         stride=stride, compute_dtype=compute_dtype,
                         kind=kind, precision=precision)
        return y.narrow(dim, stride * lo, stride * x.shape[dim])
    if x.shape[dim] % s:
        raise ValueError(
            f"local shard extent {x.shape[dim]} along axis {dim} is not a "
            f"multiple of the stride {s}; use fewer 'spatial' shards "
            f"or an image size with more factors of 2")
    if padding is None:
        lo, hi = same_halo(k, s)
    else:
        lo, hi = padding if isinstance(padding[0], int) else padding[dim - 1]
    return conv_general(halo_exchange(x, lo, hi, dim, axis), w, stride=stride,
                        compute_dtype=compute_dtype, kind=kind,
                        precision=precision, unpadded=dim, padding=padding)
