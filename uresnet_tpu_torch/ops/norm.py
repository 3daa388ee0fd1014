"""BatchNorm with TF1 semantics (port of uresnet_tpu/ops/norm.py).

No ``nn.BatchNorm*``: its running variance is unbiased, TF1's is biased.
The running stats are explicit state: the train form returns new stats
instead of writing buffers, so a forward that is run twice (activation
checkpointing reruns it in the backward) moves them once.

Under data parallelism the train form's statistics are the global batch's,
as the JAX package's are under its batch-sharded mesh: one differentiable
SUM all-reduce per call of the packed per-channel sums (no
``nn.SyncBatchNorm``, whose running variance is unbiased too).
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
    """y = x*g + b, g = scale/sqrt(var+eps), b = bias - mean*g: g, b in f32,
    the one elementwise pass in the activation dtype."""
    g = torch.rsqrt(var + eps) * params["scale"].float()
    b = params["bias"].float() - mean * g
    return x * g.to(x.dtype) + b.to(x.dtype)


def batch_norm(x: torch.Tensor, params: dict, state: dict, *,
               eps: float = 1e-3) -> torch.Tensor:
    """Eval form: normalize over all dims but the trailing channel dim with
    the running stats."""
    return _affine(x, params, state["mean"].float(), state["var"].float(), eps)


def batch_norm_train(x: torch.Tensor, params: dict, state: dict, *,
                     momentum: float = 0.99, eps: float = 1e-3, group=None
                     ) -> Tuple[torch.Tensor, dict]:
    """Train form: returns (y, new_state). Batch statistics in f32 over all
    dims but the channel, biased ``var = E[x^2] - E[x]^2``; gradients flow
    through them. The new running stats are new, detached tensors.

    ``group`` (a data-parallel process group): the statistics are the
    global batch's. The f32 ``sum x``, ``sum x^2`` and the element count
    go through one SUM all-reduce whose backward all-reduces their
    gradients, so every rank computes the same stats and running stats."""
    x32 = x.float()
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
    return _affine(x, params, mean, var, eps), new_state
