"""Dense-ification pipeline: sparse events -> model-ready batches.

The port's own copy of ``uresnet_tpu/data/pipeline.py`` (imports rewritten to
this package); tests/test_torch_data.py holds the two equal.

Capability parity (SURVEY.md §2.2 larcv BatchFiller + BASELINE north_star):
"image2d decode, crop/pad to power-of-two, pixel-value normalization,
label/weight-map construction". This numpy implementation defines the
semantics; the C++ decoder (`cxx/decoder/`) implements the identical
transform for the threaded production path and is tested for equivalence
against this module (SURVEY.md §4 data-plane tests).

Weight-map modes (configurable — the reference's exact scheme is [K:low],
SURVEY.md §7 hard part #3):
  * 'ones'          — uniform weights (plain CE);
  * 'class_balance' — per-pixel weight inversely proportional to the pixel
                      count of its class in the image, normalized to mean 1;
  * 'nonzero'       — background pixels get weight 1, charge pixels get
                      1 + boost;
  * 'file'          — the reference's file-driven weight product (SURVEY.md
                      §2.1 larcv-IO row "data/label/weight"): per-point
                      weights stored in the USEF v2 file (events.py) are
                      scattered at the charge coordinates; pixels without a
                      point take weight 1.0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from uresnet_tpu_torch.data.events import SparseEvent, SparsePlane


def crop_or_pad_coords(
    coords: np.ndarray, src_shape: Sequence[int], target: int,
    values: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Shift coords so a `target`^ndims window maps to [0, target); returns
    (shifted_coords, in_window_mask).

    Window policy (identical in the device and C++ implementations): center
    on the CHARGE-WEIGHTED centroid, then clamp so the max-charge pixel is
    always inside (an unweighted centroid can land in dead space between
    tracks and produce an EMPTY crop), then clamp to the image."""
    ndims = coords.shape[1]
    n = len(coords)
    vsum = 0.0
    if n and values is not None:
        # Sequential float64 accumulation IN FILE ORDER (np.cumsum ==
        # ufunc.accumulate, a running sum), matching the C++ decoder's
        # `double acc; for (...) acc += v;` loop bit-for-bit: every term is
        # exact in f64 (f32 charge widened exactly; int coord x f64 weight
        # needs < 53 mantissa bits), so identical summation order means
        # identical rounding and an IDENTICAL crop origin even when the
        # centroid lands on a floor() half-integer boundary. The previous
        # f32 pairwise values.sum() could disagree with the C++ double sum
        # there and shift the crop by one pixel (round-3 review finding).
        v64 = values.astype(np.float64)
        vsum = float(np.cumsum(v64)[-1])
    if n and vsum > 0:
        w = v64 / vsum
        center = np.cumsum(coords * w[:, None], axis=0)[-1]
        anchor = coords[int(np.argmax(values))]
    elif n:
        # exact regardless of order: integer sums are exact in f64
        center = coords.mean(axis=0)
        anchor = coords[0]
    else:
        center = np.array([s / 2 for s in src_shape])
        anchor = None
    origin = np.empty(ndims, np.int64)
    for d in range(ndims):
        # floor(x + 0.5): deterministic half-up rounding, reproduced exactly
        # by the C++ decoder (std::floor), unlike Python's banker's round().
        lo = int(np.floor(center[d] - target / 2 + 0.5))
        if anchor is not None:
            lo = max(int(anchor[d]) - target + 1, min(lo, int(anchor[d])))
        lo = max(0, min(lo, max(src_shape[d] - target, 0)))
        origin[d] = lo
    shifted = coords.astype(np.int64) - origin[None, :]
    mask = np.all((shifted >= 0) & (shifted < target), axis=1)
    return shifted, mask


def make_weights(
    labels_img: np.ndarray,   # (*S,) int
    data_img: np.ndarray,     # (*S,) float
    *,
    mode: str,
    num_class: int,
    nonzero_boost: float = 1.0,
) -> np.ndarray:
    if mode == "ones":
        return np.ones_like(data_img, np.float32)
    if mode == "nonzero":
        w = np.ones_like(data_img, np.float32)
        w[data_img > 0] += nonzero_boost
        return w
    if mode == "class_balance":
        total = labels_img.size
        w = np.empty(labels_img.shape, np.float32)
        counts = np.bincount(labels_img.reshape(-1), minlength=num_class)
        if len(counts) > num_class and counts[num_class:].any():
            raise ValueError(
                f"label value >= num_class ({num_class}) in event "
                f"(corrupt file or wrong model.num_class)")
        # per-class weight = total / (num_class * count_c); mean over pixels ≈ 1
        for c in range(num_class):
            if counts[c]:
                w[labels_img == c] = total / (num_class * counts[c])
        return w
    raise ValueError(f"unknown weight mode {mode!r}")


def densify_plane(
    plane: SparsePlane,
    *,
    image_size: int,
    normalize_scale: float,
    normalize_clip: float,
    weight_mode: str,
    num_class: int,
    nonzero_boost: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (data (*S,), labels (*S,), weights (*S,)) at image_size^ndims."""
    ndims = plane.coords.shape[1]
    out_shape = (image_size,) * ndims
    data = np.zeros(out_shape, np.float32)
    labels = np.zeros(out_shape, np.int32)
    coords, mask = crop_or_pad_coords(plane.coords, plane.shape, image_size,
                                      values=plane.values)
    coords = coords[mask]
    vals = plane.values[mask]
    labs = plane.labels[mask]
    idx = tuple(coords[:, d] for d in range(ndims))
    data[idx] = np.clip(vals * normalize_scale, 0.0, normalize_clip)
    labels[idx] = labs
    if weight_mode == "file":
        if plane.weights is None:
            raise ValueError(
                "weight_mode='file' but the plane carries no stored weights "
                "(USEF v1 file, or converted without --weight-producer)")
        weights = np.ones(out_shape, np.float32)
        weights[idx] = plane.weights[mask]
    else:
        weights = make_weights(labels, data, mode=weight_mode,
                               num_class=num_class,
                               nonzero_boost=nonzero_boost)
    return data, labels, weights


def sparse_batch(
    events: Sequence[SparseEvent],
    *,
    planes: Sequence[int],
    max_points: int,
    ndims: int = 2,
    with_weights: bool = False,
) -> dict:
    """Padded sparse batch for on-device dense-ification
    (uresnet_tpu_torch.data.device_pipeline): one row per event x plane with
    coords/values/labels padded to `max_points` (overflow points dropped,
    rarest-first would require a policy — we keep the first P).
    ``with_weights`` adds the per-point file weights (USEF v2,
    weight_mode='file') as a (B, P) float32 leaf."""
    B = len(events) * len(planes)
    # Narrow WIRE dtypes (lossless; the device pipeline upcasts): the sparse
    # batch is the host->device payload and the link is the e2e bottleneck
    # (benchmarks/RESULTS.md round 2) — coords int16 (extents < 32768,
    # checked below), labels uint8 (class ids). Must match the C++ decoder's
    # slot layout (cxx/decoder/decoder.cpp urd_batch).
    coords = np.zeros((B, max_points, ndims), np.int16)
    values = np.zeros((B, max_points), np.float32)
    labels = np.zeros((B, max_points), np.uint8)
    weights = np.zeros((B, max_points), np.float32) if with_weights else None
    npoints = np.zeros((B,), np.int32)
    shape = np.zeros((B, ndims), np.int32)
    row = 0
    for evt in events:
        by_id = {p.plane_id: p for p in evt.planes}
        for pid in planes:
            pl = by_id.get(pid)
            if pl is None:
                raise KeyError(f"event missing plane {pid}")
            n = min(len(pl.values), max_points)
            if np.any(np.asarray(pl.shape) >= 32768):
                raise ValueError(
                    f"plane shape {tuple(pl.shape)} exceeds the int16 sparse "
                    f"wire format (detector extents must be < 32768)")
            # Fail loudly on corrupt content BEFORE the unsafe narrowing
            # casts below (int16 coords / uint8 labels would silently wrap)
            # — mirrored bit-for-bit by the C++ producer (decoder.cpp).
            if n:
                c = pl.coords[:n]
                if (c < 0).any() or (c >= np.asarray(pl.shape)[None, :]).any():
                    raise ValueError(
                        f"coordinate outside the declared plane shape "
                        f"{tuple(pl.shape)} (corrupt file)")
                labs = np.asarray(pl.labels[:n])
                if labs.size and (int(labs.min()) < 0
                                  or int(labs.max()) >= 256):
                    raise ValueError(
                        "label value outside [0, 256) exceeds the uint8 "
                        "sparse wire format (corrupt file)")
            coords[row, :n] = pl.coords[:n]
            values[row, :n] = pl.values[:n]
            labels[row, :n] = pl.labels[:n]
            if with_weights:
                if pl.weights is None:
                    raise ValueError(
                        "weight_mode='file' but the plane carries no stored "
                        "weights (USEF v1 file, or converted without "
                        "--weight-producer)")
                weights[row, :n] = pl.weights[:n]
            npoints[row] = n
            shape[row] = pl.shape
            row += 1
    out = {"coords": coords, "values": values, "labels": labels,
           "npoints": npoints, "shape": shape}
    if with_weights:
        out["weights"] = weights
    return out


def densify_batch(
    events: Sequence[SparseEvent],
    *,
    image_size: int,
    planes: Sequence[int],
    normalize_scale: float = 0.01,
    normalize_clip: float = 10.0,
    weight_mode: str = "class_balance",
    num_class: int = 3,
    nonzero_boost: float = 1.0,
) -> dict:
    """Batch of events -> {'data': (B,*S,1), 'label': (B,*S), 'weight': (B,*S)}.

    Multi-plane events contribute one batch row per selected plane
    (reference semantics: larcv `Channels` selects planes, each treated as
    an independent image — SURVEY.md §2.1 larcv IO configs).
    """
    datas, labels, weights = [], [], []
    for ev in events:
        by_id = {p.plane_id: p for p in ev.planes}
        for pid in planes:
            pl = by_id.get(pid)
            if pl is None:
                raise KeyError(f"event missing plane {pid}")
            d, l, w = densify_plane(
                pl, image_size=image_size, normalize_scale=normalize_scale,
                normalize_clip=normalize_clip, weight_mode=weight_mode,
                num_class=num_class, nonzero_boost=nonzero_boost)
            datas.append(d); labels.append(l); weights.append(w)
    return {
        "data": np.stack(datas)[..., None],
        "label": np.stack(labels),
        "weight": np.stack(weights),
    }
