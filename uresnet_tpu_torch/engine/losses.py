"""Pixel-weighted softmax cross-entropy (port of uresnet_tpu/engine/losses.py).

``normalize='mean'`` is the reference's ``mean(weight * xent)`` over all
pixels; ``'weight_sum'`` divides by ``sum(weight)`` instead. The true-class
logit is a gather: the JAX package's one-hot multiply-sum was a TPU
workaround for a slow gather.
"""

from __future__ import annotations

import torch


def softmax_xent_per_pixel(logits: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """(B, *S, C) logits, (B, *S) int labels -> unreduced f32 (B, *S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return logz - true_logit


def weighted_softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor, *,
                          normalize: str = "mean") -> torch.Tensor:
    xent = softmax_xent_per_pixel(logits, labels)
    w = weights.float()
    if normalize == "mean":
        return torch.mean(w * xent)
    if normalize == "weight_sum":
        return torch.sum(w * xent) / torch.clamp(torch.sum(w), min=1e-6)
    raise ValueError(f"unknown normalize mode {normalize!r}")
