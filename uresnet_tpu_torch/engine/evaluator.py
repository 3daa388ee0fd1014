"""Inference / analysis pass (port of uresnet_tpu/engine/evaluator.py
``run_inference`` on its host-densify dense-export path, JAX's
``streamed=False, export='dense'``).

Events are read in order, densified on the host (``densify_batch``), moved
to the device once per batch, scored by the serving function, and the
per-pixel softmax scores at the charge pixels are exported to an npz with
the JAX columns; dataset metrics come from a global (pred, true)
confusion over all pixels of the batch rows.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch

from uresnet_tpu_torch.config import Config
from uresnet_tpu_torch.data import events as ev
from uresnet_tpu_torch.data.pipeline import densify_batch
from uresnet_tpu_torch.engine.metrics import metrics_from_counts

def _write_npz(output_file: str, columns: Dict[str, list], *, dims: int,
               num_class: int) -> None:
    empty = {"event_id": np.zeros(0, np.int32), "plane_id": np.zeros(0, np.int32),
             "coords": np.zeros((0, dims), np.int32),
             "scores": np.zeros((0, num_class), np.float32),
             "pred": np.zeros(0, np.int32), "label": np.zeros(0, np.int32)}
    result = {k: np.concatenate(columns[k]) if columns[k] else v
              for k, v in empty.items()}
    tmp = output_file + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **result)
    os.replace(tmp, output_file)


def run_inference(cfg: Config, serve: Callable[[torch.Tensor], torch.Tensor],
                  input_file: str, output_file: str, *,
                  device: torch.device) -> Dict[str, float]:
    """Sequential pass over ``input_file``; writes the npz score export

      event_id (N,), plane_id (N,), coords (N, ndims),
      scores (N, num_class), pred (N,), label (N,)

    over the charge pixels of every (event, plane) row, and returns the
    dataset metrics plus ``n_events`` and ``n_pixels``. The other modes of
    the JAX pass (USEF writeback, streamed and sparse exports, tiled) are
    not ported; cli/infer.py refuses them."""
    n = ev.num_events(input_file)
    planes = tuple(cfg.data.planes)
    num_class = cfg.model.num_class
    bs_events = max(1, cfg.data.batch_size // len(planes))

    columns = {k: [] for k in ("event_id", "plane_id", "coords", "scores",
                               "pred", "label")}
    n_correct_nonzero = 0
    n_nonzero = 0
    conf = np.zeros((num_class, num_class), np.float64)
    n_pix_total = 0
    for start in range(0, n, bs_events):
        idxs = list(range(start, min(start + bs_events, n)))
        batch = densify_batch(
            ev.read_events(input_file, idxs), image_size=cfg.data.image_size,
            planes=planes, normalize_scale=cfg.data.normalize_scale,
            normalize_clip=cfg.data.normalize_clip, weight_mode="ones",
            num_class=num_class)
        x = torch.from_numpy(batch["data"]).to(device)
        scores = serve(x).cpu().numpy()
        data_b, label_b = batch["data"], batch["label"]
        pred = scores.argmax(-1)
        for bi, eidx in enumerate(idxs):
            for pi, pid in enumerate(planes):
                row = bi * len(planes) + pi
                label_img = label_b[row]
                mask = data_b[row, ..., 0] > 0
                coords = np.argwhere(mask)
                columns["event_id"].append(np.full(len(coords), eidx, np.int32))
                columns["plane_id"].append(np.full(len(coords), pid, np.int32))
                columns["coords"].append(coords.astype(np.int32))
                columns["scores"].append(scores[row][mask])
                columns["pred"].append(pred[row][mask].astype(np.int32))
                columns["label"].append(label_img[mask].astype(np.int32))
                n_correct_nonzero += int((pred[row][mask] == label_img[mask]).sum())
                n_nonzero += int(mask.sum())
                lmax = int(label_img.max()) if label_img.size else 0
                if lmax >= num_class:
                    raise ValueError(
                        f"label {lmax} >= model.num_class={num_class} in "
                        f"event {eidx} plane {pid} of {input_file!r} — "
                        f"wrong num_class or corrupt file")
                conf += np.bincount(
                    (pred[row].astype(np.int64) * num_class
                     + label_img.astype(np.int64)).ravel(),
                    minlength=num_class * num_class,
                ).reshape(num_class, num_class)
                n_pix_total += label_img.size

    metrics = metrics_from_counts({
        "conf": conf, "n_pixels": float(n_pix_total),
        "correct_nonzero": float(n_correct_nonzero),
        "n_nonzero": float(n_nonzero)})
    metrics.update(n_events=n, n_pixels=n_nonzero)
    _write_npz(output_file, columns, dims=cfg.model.dims, num_class=num_class)
    return metrics
