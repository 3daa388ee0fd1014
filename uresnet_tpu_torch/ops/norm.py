"""Eval-mode BatchNorm with TF1 semantics (port of uresnet_tpu/ops/norm.py).

No ``nn.BatchNorm*``: its running variance is unbiased, TF1's is biased.
Only the eval form is ported so far; train-mode statistics come with the
training slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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


def batch_norm(x: torch.Tensor, params: dict, state: dict, *,
               eps: float = 1e-3) -> torch.Tensor:
    """Normalize over all dims but the trailing channel dim with the running
    stats, as ONE per-channel affine applied in the activation dtype:
    y = x*g + b, g = scale/sqrt(var+eps), b = bias - mean*g (g, b in f32)."""
    g = torch.rsqrt(state["var"].float() + eps) * params["scale"].float()
    b = params["bias"].float() - state["mean"].float() * g
    return x * g.to(x.dtype) + b.to(x.dtype)
