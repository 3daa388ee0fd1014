"""Segmentation metrics (port of uresnet_tpu/engine/metrics.py).

``segmentation_metrics`` (per-batch means, read by the trainer's summaries)
and ``segmentation_counts`` (confusion sums for dataset metrics) run on
tensors on the device. ``reduce_counts`` and ``metrics_from_counts`` are
the host side, numpy, copied because the JAX module imports jax.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from uresnet_tpu_torch.engine.losses import softmax_xent_per_pixel


def segmentation_metrics(logits: torch.Tensor, labels: torch.Tensor,
                         data: torch.Tensor, *,
                         num_class: int) -> Dict[str, torch.Tensor]:
    """All-pixel accuracy, nonzero-pixel accuracy (pixels with charge),
    per-class IoU and mIoU of one batch, as 0-d f32 tensors (empty union
    -> IoU 1.0). logits (B, *S, C), labels (B, *S), data (B, *S, C_in)."""
    pred = torch.argmax(logits, dim=-1)
    labels = labels.to(pred.dtype)
    correct = (pred == labels).float()
    nonzero = (data.abs().sum(-1) > 0).float()
    out = {
        "acc_all": correct.mean(),
        "acc_nonzero": (correct * nonzero).sum()
        / torch.clamp(nonzero.sum(), min=1.0),
    }
    ious = []
    for c in range(num_class):
        p, t = pred == c, labels == c
        inter = (p & t).float().sum()
        union = (p | t).float().sum()
        ious.append(torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                                torch.ones_like(union)))
    iou = torch.stack(ious)
    out["miou"] = iou.mean()
    for c in range(num_class):
        out[f"iou_class{c}"] = iou[c]
    return out


def segmentation_counts(logits: torch.Tensor, labels: torch.Tensor,
                        data: torch.Tensor, *, num_class: int,
                        row_valid: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
    """Sum form of `segmentation_metrics` for dataset evaluation: per-row
    (pred, true) confusion counts (B, C, C), the pixel count, and per-row
    nonzero-pixel counts; ``row_valid`` (B,) masks padded rows. Per-row
    f32 sums stay exact integers; `reduce_counts` adds rows in float64.

    The confusion counts take one compare-and-sum pass per (pred, true)
    bin: a ``scatter_add_`` into C*C bins per row serializes its atomics on
    the card, ten times slower than this form in the 3D ana step at 192^3
    on the H100 (chip_smoke.py phase 9 times both; PERF.md, PR 5)."""
    pred = torch.argmax(logits, dim=-1)
    labels = labels.to(pred.dtype)
    B = pred.shape[0]
    spatial = tuple(range(1, pred.dim()))
    valid = (torch.ones(B, device=pred.device) if row_valid is None
             else row_valid.float())
    vpix = valid.reshape((B,) + (1,) * len(spatial))
    idx = (pred * num_class + labels).reshape(B, -1)
    conf = torch.stack([(idx == k).sum(1) for k in range(num_class ** 2)],
                       1).float() * valid[:, None]
    nonzero = (data.abs().sum(-1) > 0).float() * vpix
    correct = (pred == labels).float()
    pix_per_row = int(np.prod(pred.shape[1:]))
    return {
        "conf": conf.reshape(B, num_class, num_class),
        "n_pixels": valid.sum() * float(pix_per_row),
        "correct_nonzero": (correct * nonzero).sum(spatial),
        "n_nonzero": nonzero.sum(spatial),
    }


def site_counts(logits: torch.Tensor, batch, *, num_class: int,
                row_valid: Optional[torch.Tensor] = None,
                loss_sums: bool = False) -> Dict[str, torch.Tensor]:
    """`segmentation_counts` of the sparse net: logits (n, C) at the sites
    of ``batch`` (a `SparseBatch`, ops/sparse.py), whose sites are the
    pixels. Per-row confusion counts (B, C, C) and nonzero counts (B,),
    ``row_valid`` (B,) masking padded rows; with ``loss_sums`` the masked
    xent sums ``loss_num`` and ``weight_sum`` of engine/evaluator.py."""
    B, event = batch.batch_size, batch.event
    pred = torch.argmax(logits, dim=-1)
    labels = batch.label.to(pred.dtype)
    valid = (torch.ones(B, device=pred.device) if row_valid is None
             else row_valid.float())
    keep = valid[event]
    conf = torch.zeros(B * num_class * num_class, device=pred.device)
    conf.index_add_(0, (event * num_class + pred) * num_class + labels, keep)
    nonzero = (batch.feats.abs().sum(-1) > 0).float() * keep
    correct = (pred == labels).float()
    per_row = torch.zeros((2, B), device=pred.device)
    per_row[0].index_add_(0, event, correct * nonzero)
    per_row[1].index_add_(0, event, nonzero)
    out = {"conf": conf.reshape(B, num_class, num_class),
           "n_pixels": keep.sum(), "correct_nonzero": per_row[0],
           "n_nonzero": per_row[1]}
    if loss_sums:
        w = batch.weight.float() * keep
        out["loss_num"] = torch.sum(w * softmax_xent_per_pixel(logits,
                                                               batch.label))
        out["weight_sum"] = torch.sum(w)
    return out


def reduce_counts(counts: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """float64 reduction of per-row count leaves: conf (B,C,C)->(C,C),
    per-row vectors -> scalars. Aggregate the results across batches by
    plain addition."""
    out = {}
    for k, v in counts.items():
        v = np.asarray(v, np.float64)
        if k == "conf" and v.ndim == 3:
            v = v.sum(axis=0)
        elif k != "conf" and v.ndim >= 1:
            v = v.sum()
        out[k] = v
    return out


def loss_from_counts(counts: Dict[str, Any], normalize: str = "mean") -> float:
    """The weighted xent of aggregated ``loss_num`` / ``weight_sum`` sums:
    'mean' over the counted pixels, 'weight_sum' over the weights."""
    if normalize == "weight_sum":
        return float(counts["loss_num"] / max(counts["weight_sum"], 1e-6))
    return float(counts["loss_num"] / max(counts["n_pixels"], 1.0))


def metrics_from_counts(counts: Dict[str, Any]) -> Dict[str, float]:
    """All-pixel accuracy, nonzero-pixel accuracy, per-class IoU and mIoU
    from aggregated (pred, true) confusion sums (empty union -> IoU 1.0)."""
    conf = np.asarray(counts["conf"], np.float64)
    num_class = conf.shape[0]
    n_pix = float(counts["n_pixels"])
    out = {
        "acc_all": float(np.trace(conf) / max(n_pix, 1.0)),
        "acc_nonzero": float(counts["correct_nonzero"]
                             / max(float(counts["n_nonzero"]), 1.0)),
    }
    ious = []
    for c in range(num_class):
        inter = conf[c, c]
        union = conf[c, :].sum() + conf[:, c].sum() - inter
        iou = inter / union if union > 0 else 1.0
        ious.append(iou)
        out[f"iou_class{c}"] = float(iou)
    out["miou"] = float(np.mean(ious))
    return out
