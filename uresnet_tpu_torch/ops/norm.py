"""BatchNorm with TF1 semantics (port of uresnet_tpu/ops/norm.py).

No ``nn.BatchNorm*``: its running variance is unbiased, TF1's is biased.
The running stats are explicit state: the train form returns new stats
instead of writing buffers, so a forward that is run twice (activation
checkpointing reruns it in the backward) moves them once.

Under data parallelism the train form's statistics are the global batch's,
as the JAX package's are under its batch-sharded mesh: one differentiable
SUM all-reduce per call of the packed per-channel sums (no
``nn.SyncBatchNorm``, whose running variance is unbiased too).

A space-to-depth packed activation (ops/pack.py) holds ``phases`` spatial
phases of each channel side by side, (..., phases * C): both forms view it
as (..., phases, C), so the phases are summed into the per-channel sums
(before that one all-reduce in the train form) and the statistics and
running stats are those of the unpacked tensor, shape (C,).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from uresnet_tpu_torch.parallel.mesh import all_reduce_sum


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


def batch_norm_train(x: torch.Tensor, params: dict, state: dict, *,
                     momentum: float = 0.99, eps: float = 1e-3, group=None,
                     phases: int = 1) -> Tuple[torch.Tensor, dict]:
    """Train form: returns (y, new_state). Batch statistics in f32 (f64 for
    f64 activations) over all dims but the channel, biased ``var = E[x^2]
    - E[x]^2``; gradients flow through them. The new running stats are
    new, detached tensors.

    ``group`` (a data-parallel process group): the statistics are the
    global batch's. The f32 ``sum x``, ``sum x^2`` and the element count
    go through one SUM all-reduce whose backward all-reduces their
    gradients, so every rank computes the same stats and running stats.
    ``phases``: a packed tensor (module docstring)."""
    shape = x.shape
    x = _by_phase(x, phases)
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = tuple(range(x.dim() - 1))
    if group is None:
        mean = x32.mean(dims)
        var = x32.square().mean(dims) - mean.square()
    else:
        C = x.shape[-1]
        count = x32.new_full((1,), x32.numel() // C)
        sums = all_reduce_sum(torch.cat([x32.sum(dims),
                                         x32.square().sum(dims), count]),
                              group)
        mean = sums[:C] / sums[2 * C]
        var = sums[C:2 * C] / sums[2 * C] - mean.square()
    with torch.no_grad():
        new_state = {
            "mean": state["mean"] * momentum + mean * (1.0 - momentum),
            "var": state["var"] * momentum + var * (1.0 - momentum),
        }
    return _affine(x, params, mean, var, eps).reshape(shape), new_state
