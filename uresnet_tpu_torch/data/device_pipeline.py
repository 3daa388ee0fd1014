"""On-device dense-ification: padded sparse events -> model-ready batches
(port of uresnet_tpu/data/device_pipeline.py).

The host ships per batch, as numpy (data/pipeline.py ``sparse_batch``):
    coords  (B, P, D) int16   event pixel coordinates (padded)
    values  (B, P)    float32 charge
    labels  (B, P)    uint8
    npoints (B,)      int32   valid prefix length
    shape   (B, D)    int32   source detector image extent
    [weights (B, P)   float32 per-point file weights, weight_mode 'file']
and this module reproduces ``uresnet_tpu.data.pipeline.densify_plane``
bit-exactly on the device: centroid crop with half-up rounding and window
clamping, normalization with clipping, the label map and the configured
weight map.

A pixel that appears twice in one event takes its LAST point's value, as
numpy's fancy assignment does. A CUDA scatter does not order duplicate
indices, so each row first keeps, per window pixel, only the highest point
index (``scatter_reduce(amax)``) and then scatters without duplicates.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Batch = Dict[str, torch.Tensor]


def _crop_window(sparse: Batch, image_size: int):
    """(shifted coords (B,P,D) int64, in_window (B,P) bool, point mask
    (B,P) bool, origin (B,D) int64), the crop of
    pipeline.crop_or_pad_coords."""
    coords = sparse["coords"].long()
    values = sparse["values"].float()
    npoints = sparse["npoints"].long()
    shape = sparse["shape"].long()
    B, P, D = coords.shape
    T = image_size
    dev = coords.device
    mask = torch.arange(P, device=dev)[None, :] < npoints[:, None]

    # pipeline.py's float64 formula: weights v/sum(v), centroid sum(c*w).
    # The host adds in file order, the device in its own; in float64 the
    # difference cannot move floor(centroid + 0.5) but at an exact tie.
    vmask = values.double() * mask
    vsum = vmask.sum(1)
    has = npoints > 0
    w = vmask / torch.where(vsum > 0, vsum, torch.ones_like(vsum))[:, None]
    center_w = (coords.double() * w[..., None]).sum(1)
    center_u = ((coords * mask[..., None]).sum(1).double()
                / torch.clamp(npoints, min=1).double()[:, None])
    center = torch.where((vsum > 0)[:, None], center_w, center_u)
    center = torch.where(has[:, None], center, shape.double() / 2.0)
    # anchor: the max-charge point (the first of equal maxima), else the
    # first point
    amax = torch.argmax(torch.where(mask, values, -torch.inf), dim=1)
    anchor = torch.where(
        (vsum > 0)[:, None],
        coords.gather(1, amax[:, None, None].expand(B, 1, D))[:, 0],
        coords[:, 0])
    lo = torch.floor(center - T / 2.0 + 0.5).long()
    lo = torch.minimum(torch.maximum(lo, anchor - T + 1), anchor)
    lo = torch.where(has[:, None], lo,
                     torch.floor(shape.double() / 2.0 - T / 2.0 + 0.5).long())
    hi = torch.clamp(shape - T, min=0)
    origin = torch.minimum(torch.clamp(lo, min=0), hi)
    shifted = coords - origin[:, None, :]
    in_win = ((shifted >= 0) & (shifted < T)).all(-1) & mask
    return shifted, in_win, mask, origin


def crop_origin(sparse: Batch, *, image_size: int) -> torch.Tensor:
    """(B, D) crop origin of each row: the window densify_on_device uses."""
    return _crop_window(sparse, image_size)[3]


def draw_decisions(generator: torch.Generator, batch: int,
                   dims: int) -> torch.Tensor:
    """(dims + 1, B) bool per-image augmentation decisions: a flip per
    spatial axis, then the 2D rot90. Drawn on the generator's device in
    this one order by both augmentation paths (engine/augment.py and the
    in-scatter path here)."""
    return torch.rand((dims + 1, batch), generator=generator,
                      device=generator.device) < 0.5


def _augment_coords(s: torch.Tensor, decisions: torch.Tensor, T: int):
    """Apply engine/augment.py's flips / rot90 to in-window coords: flip
    each axis where decided, then (2D) rot90 — np.rot90(a, 1, (1, 2)) puts
    the pixel at (y, x) at (T-1-x, y)."""
    D = s.shape[-1]
    s = torch.stack([torch.where(decisions[d][:, None], T - 1 - s[..., d],
                                 s[..., d]) for d in range(D)], -1)
    if D == 2:
        s = torch.where(decisions[D][:, None, None],
                        torch.stack([T - 1 - s[..., 1], s[..., 0]], -1), s)
    return s


def _scatter_last(flat: torch.Tensor, src: torch.Tensor, base: float,
                  npix: int) -> torch.Tensor:
    """Per row, out[flat[p]] = src[p] over a ``base``-filled (npix,) map;
    ``flat == npix`` drops the point. ``flat`` has no duplicate in-window
    index (see `_last_wins`)."""
    out = torch.full((flat.shape[0], npix + 1), base, dtype=src.dtype,
                     device=src.device)
    out.scatter_(1, flat, src)
    return out[:, :npix]


def _last_wins(flat: torch.Tensor, npix: int) -> torch.Tensor:
    """Send every point that a later point of its row overwrites to the drop
    slot ``npix``, so what remains has no duplicate in-window index."""
    B, P = flat.shape
    idx = torch.arange(P, device=flat.device).expand(B, P)
    last = torch.full((B, npix + 1), -1, dtype=idx.dtype, device=flat.device)
    last.scatter_reduce_(1, flat, idx, reduce="amax")
    return torch.where(last.gather(1, flat) == idx, flat,
                       torch.full_like(flat, npix))


def densify_on_device(sparse: Batch, *, image_size: int, num_class: int = 3,
                      normalize_scale: float = 0.01,
                      normalize_clip: float = 10.0,
                      weight_mode: str = "class_balance",
                      nonzero_boost: float = 1.0,
                      decisions: Optional[torch.Tensor] = None,
                      target_phases: int = 1,
                      target_hpack: bool = False) -> Batch:
    """Sparse batch tensors (on any device) -> {'data': (B,*S,1) f32,
    'label': (B,*S) int64, 'weight': (B,*S) f32} on the same device.

    ``decisions`` ((D+1, B) bool, `draw_decisions`): apply
    engine/augment.py's flips/rot90 inside the scatter, by moving the
    window coordinates — equal to augmenting the dense images with the same
    decisions, at point-cloud cost.

    ``target_phases > 1`` (``target_hpack``: with the extra H phase):
    scatter label and weight straight into the packed loss layout
    (models/packed.py ``loss_layout_phases`` / ``pack_like_logits``),
    (B, *S', target_phases), so the packed train loss needs no relayout of
    full-resolution targets; ``data`` stays canonical (the packed model
    packs its own input). The packed index is a bijection of the canonical
    one, so the same points survive `_last_wins`."""
    values = sparse["values"].float()
    B, P, D = sparse["coords"].shape
    T = image_size
    npix = T ** D
    shifted, in_win, _, _ = _crop_window(sparse, T)
    s = torch.clamp(shifted, 0, T - 1)
    if decisions is not None:
        s = _augment_coords(s, decisions.to(s.device), T)
    flat = torch.zeros((B, P), dtype=torch.long, device=s.device)
    for d in range(D):
        flat = flat * T + s[..., d]
    flat = _last_wins(torch.where(in_win, flat, torch.full_like(flat, npix)),
                      npix)
    img = (B,) + (T,) * D
    flat_t, timg = flat, img
    if target_phases > 1:
        # position on the coarse grid major, then the phase-major channel
        # (hp, p_0, ..., p_{D-1}): the order of pack_like_logits
        blk, ph = s // 2, s % 2
        pos = blk[..., 0] // 2 if target_hpack else blk[..., 0]
        phase = blk[..., 0] % 2 if target_hpack else torch.zeros_like(pos)
        for d in range(1, D):
            pos = pos * (T // 2) + blk[..., d]
        for d in range(D):
            phase = phase * 2 + ph[..., d]
        flat_t = torch.where(flat == npix, flat, pos * target_phases + phase)
        timg = ((B, T // (4 if target_hpack else 2)) + (T // 2,) * (D - 1)
                + (target_phases,))

    vals = torch.clamp(values * normalize_scale, 0.0, normalize_clip)
    data = _scatter_last(flat, vals, 0.0, npix)
    label = _scatter_last(flat_t, sparse["labels"].long(), 0, npix)
    if weight_mode == "ones":
        weight = torch.ones_like(data)
    elif weight_mode == "nonzero":
        data_t = data if flat_t is flat else _scatter_last(flat_t, vals, 0.0,
                                                           npix)
        weight = torch.ones_like(data) + (data_t > 0).float() * nonzero_boost
    elif weight_mode == "file":
        weight = _scatter_last(flat_t, sparse["weights"].float(), 1.0, npix)
    elif weight_mode == "class_balance":
        # one compare-and-sum pass per class: a scatter_add into C bins per
        # row serializes its atomics (8.4 ms of a 263 ms step on the H100)
        counts = torch.stack([(label == c).sum(1) for c in range(num_class)],
                             1).float()
        # tensor / tensor: a true f32 division (a scalar numerator would
        # be a reciprocal and a product, two roundings)
        w_class = torch.where(counts > 0, torch.full_like(counts, npix)
                              / (num_class * counts), torch.zeros_like(counts))
        weight = w_class.gather(1, label)
    else:
        raise ValueError(f"unknown weight mode {weight_mode!r}")
    return {"data": data.reshape(img + (1,)), "label": label.reshape(timg),
            "weight": weight.reshape(timg)}


def scores_at_points(sparse: Batch, scores: torch.Tensor, *,
                     image_size: int) -> torch.Tensor:
    """Per-pixel scores (B, *S, C) gathered back at the sparse batch's
    points: (B, P, C), through the window of `_crop_window`, so each point
    reads the pixel densify_on_device put it in. Padded and out-of-window
    points read pixel 0: mask them with the window rebuilt from
    `crop_origin`. The readback is then point-cloud sized, not the dense
    score volume."""
    T = image_size
    B, P, D = sparse["coords"].shape
    shifted, in_win, _, _ = _crop_window(sparse, T)
    flat = torch.zeros((B, P), dtype=torch.long, device=shifted.device)
    for d in range(D):
        flat = flat * T + torch.clamp(shifted[..., d], 0, T - 1)
    flat = torch.where(in_win, flat, torch.zeros_like(flat))
    C = scores.shape[-1]
    return torch.gather(scores.reshape(B, T ** D, C), 1,
                        flat[..., None].expand(B, P, C))
