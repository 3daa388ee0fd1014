"""BatchNorm with TF1 semantics (port of uresnet_tpu/ops/norm.py).

No ``nn.BatchNorm*``: its running variance is unbiased, TF1's is biased.
The running stats are explicit state: the train form returns new stats
instead of writing buffers, so a forward that is run twice (activation
checkpointing reruns it in the backward) moves them once.

The train form runs as CUDA kernels on the card (ops/cuda/bn_train.py,
their plain versions on the CPU), with the residual add and the ReLU that
follow BN in the blocks. Under data parallelism its statistics are the
global batch's, as the JAX package's are under its batch-sharded mesh: one
SUM all-reduce per call of the per-channel sums, and one of their
gradients in the backward (no ``nn.SyncBatchNorm``, whose running
variance is unbiased too).

A space-to-depth packed activation (ops/pack.py) holds ``phases`` spatial
phases of each channel side by side, (..., phases * C): both forms view it
as (..., phases, C), so the phases are summed into the per-channel sums
(before that one all-reduce in the train form) and the statistics and
running stats are those of the unpacked tensor, shape (C,).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from uresnet_tpu_torch.ops.cuda.bn_train import (bn_train_apply,
                                                 bn_train_grad_input,
                                                 bn_train_grad_reduce,
                                                 bn_train_stats, moments,
                                                 running, stats_dtype)


def bn_init(ch: int, param_dtype: torch.dtype = torch.float32,
            device: Optional[torch.device] = None) -> Tuple[dict, dict]:
    params = {
        "scale": torch.ones((ch,), dtype=param_dtype, device=device),
        "bias": torch.zeros((ch,), dtype=param_dtype, device=device),
    }
    state = {
        "mean": torch.zeros((ch,), dtype=torch.float32, device=device),
        "var": torch.ones((ch,), dtype=torch.float32, device=device),
    }
    return params, state


def _affine(x, params, mean, var, eps):
    """y = x*g + b, g = scale/sqrt(var+eps), b = bias - mean*g: g, b in the
    statistics' dtype (f32, or f64 for f64 activations), the one
    elementwise pass in the activation dtype."""
    g = torch.rsqrt(var + eps) * params["scale"].to(var.dtype)
    b = params["bias"].to(var.dtype) - mean * g
    return x * g.to(x.dtype) + b.to(x.dtype)


def _by_phase(x: torch.Tensor, phases: int) -> torch.Tensor:
    """(..., phases * C) viewed as (..., phases, C)."""
    if phases == 1:
        return x
    return x.reshape(x.shape[:-1] + (phases, x.shape[-1] // phases))


def batch_norm(x: torch.Tensor, params: dict, state: dict, *,
               eps: float = 1e-3, phases: int = 1) -> torch.Tensor:
    """Eval form: normalize over all dims but the trailing channel dim with
    the running stats; ``phases``: a packed tensor (module docstring)."""
    y = _affine(_by_phase(x, phases), params, state["mean"].float(),
                state["var"].float(), eps)
    return y.reshape(x.shape)


class _BatchNormTrain(torch.autograd.Function):
    """Train BN (+ residual) (+ ReLU) on (rows, W) activations through the
    four ops of ops/cuda/bn_train.py: statistics and affine forward,
    gradient sums and input gradient backward. The backward is the
    analytic gradient of the whole function, the input gradient in one
    pass: dx = g / N * (N dy' - sum dy' - xhat * sum dy' xhat), g = scale *
    rstd, dy' the output gradient through the ReLU, N the elements of a
    channel. Saved: x, the output (the ReLU mask where a residual was
    added), mean, rstd and the count N. Also returns the running mean and
    var moved by ``momentum`` from ``running_mean`` and ``running_var``
    (the statistics' dtype).

    With a ``group`` the forward's (2C + 1) sums ``[sum x | sum x^2 |
    count]`` go through one SUM all-reduce, before the moments and the
    running stats are taken from them, and the backward's (2C,) ``[sum
    dy' | sum dy' xhat]`` through one more before the input gradient; the
    scale and bias gradients are this rank's sums."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, running_mean, running_var,
                C: int, eps: float, momentum: float, relu: bool, group):
        sums = bn_train_stats(x, C, eps, running_mean, running_var, momentum)
        if group is None:
            mean, _, rstd, new_mean, new_var = sums[2 * C + 1:].view(
                5, C).unbind()
        else:
            sums = sums[:2 * C + 1]
            dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
            mean, var, rstd = moments(sums, C, eps)
            new_mean = running(running_mean, mean, momentum)
            new_var = running(running_var, var, momentum)
        out = bn_train_apply(x, residual, mean, rstd, scale, bias, relu=relu)
        ctx.save_for_backward(x, out if relu and residual is not None
                              else None, mean, rstd, scale, bias,
                              sums[2 * C:2 * C + 1])
        ctx.relu, ctx.residual, ctx.group = relu, residual is not None, group
        ctx.mark_non_differentiable(new_mean, new_var)
        ctx.set_materialize_grads(False)
        return out, new_mean, new_var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, _dmean, _dvar):
        x, out, mean, rstd, scale, bias, count = ctx.saved_tensors
        C = mean.shape[0]
        dout = dout.contiguous()
        local = bn_train_grad_reduce(dout, x, out, mean, rstd, scale, bias,
                                     relu=ctx.relu)
        total = local
        if ctx.group is not None:
            total = local.clone()
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=ctx.group)
        dx, dres = bn_train_grad_input(dout, x, out, mean, rstd, scale, bias,
                                       total, count, relu=ctx.relu,
                                       residual=ctx.residual)
        return (dx, local[C:], local[:C], dres if ctx.residual else None,
                None, None, None, None, None, None, None)


def batch_norm_train(x: torch.Tensor, params: dict, state: dict, *,
                     momentum: float = 0.99, eps: float = 1e-3, group=None,
                     phases: int = 1, relu: bool = False,
                     residual: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, dict]:
    """Train form: returns (y, new_state), y = relu?(BN(x) [+ residual]).
    Batch statistics in f32 (f64 for f64 activations) over all dims but
    the channel, biased ``var = E[x^2] - E[x]^2``; gradients flow through
    them. ``residual`` (x's shape) is added after the affine and before
    the ReLU; one rounding to x's dtype. The new running stats are new,
    detached tensors.

    ``group`` (a data-parallel process group): the statistics are the
    global batch's. The ``sum x``, ``sum x^2`` and the element count go
    through one SUM all-reduce, and the backward's two gradient sums
    through one more, so every rank computes the same stats and running
    stats. ``phases``: a packed tensor (module docstring).

    The function runs as the four ops of ops/cuda/bn_train.py: CUDA
    kernels on the card, their plain versions on the CPU. The statistics
    op also moves the running stats (one process: in the kernel)."""
    shape, W = x.shape, x.shape[-1]
    x2 = x.reshape(-1, W).contiguous()
    sd = stats_dtype(x.dtype)
    res2 = (None if residual is None
            else residual.to(x.dtype).reshape(-1, W).contiguous())
    y, new_mean, new_var = _BatchNormTrain.apply(
        x2, params["scale"].to(sd), params["bias"].to(sd), res2,
        state["mean"].to(sd), state["var"].to(sd), W // phases, eps, momentum,
        relu, group)
    return y.reshape(shape), {"mean": new_mean, "var": new_var}
