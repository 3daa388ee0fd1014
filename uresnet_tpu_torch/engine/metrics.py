"""Dataset segmentation metrics from confusion counts (host side, numpy).

Copied from uresnet_tpu/engine/metrics.py (``reduce_counts``,
``metrics_from_counts``), whose module imports jax.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


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
