"""The traffic source: LArTPC-like sparse events and their padded batches.

A frozen copy of ``uresnet_tpu_torch/data/synthetic.py`` (``generate_event``
and its helpers, generator revision 2) and of the batch layout of
``uresnet_tpu_torch/data/pipeline.py`` (``sparse_batch``), so that what the
benchmark sends cannot change with the program. An event is one plane:
(coords (N, D) int32, values (N,) float32, labels (N,) uint8), labels 1
for tracks (straight segments with Landau-like charge), 2 for showers
(branching cones) and 0 for noise hits; pixels hit twice sum their charge
and keep the label of the larger deposit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Event = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _clip_points(coords: np.ndarray, shape) -> np.ndarray:
    mask = np.ones(len(coords), bool)
    for d, s in enumerate(shape):
        mask &= (coords[:, d] >= 0) & (coords[:, d] < s)
    return mask


def _direction(rng, ndims: int) -> np.ndarray:
    theta = rng.uniform(0, 2 * np.pi)
    if ndims == 2:
        return np.array([np.sin(theta), np.cos(theta)])
    phi = rng.uniform(0, np.pi)
    return np.array([np.sin(phi) * np.sin(theta),
                     np.sin(phi) * np.cos(theta), np.cos(phi)])


def _track(rng, shape, ndims: int):
    start = np.array([rng.uniform(0, s) for s in shape])
    direction = _direction(rng, ndims)
    steps = int(rng.uniform(0.2, 0.9) * min(shape))
    if steps < 2:
        return None
    pts = start[None, :] + np.arange(steps)[:, None] * direction[None, :]
    coords = np.round(pts).astype(np.int32)
    q = 60.0 + 25.0 * rng.standard_gamma(2.0, steps).astype(np.float32)
    mask = _clip_points(coords, shape)
    return coords[mask], q[mask]


def _shower(rng, shape, ndims: int):
    start = np.array([rng.uniform(0.1 * s, 0.9 * s) for s in shape])
    axis = _direction(rng, ndims)
    if ndims == 3:
        sc = min(shape) / 256.0
        n = rng.integers(max(50, int(200 * sc)), max(120, int(1200 * sc)))
    else:
        n = rng.integers(40, 250)
    depth = rng.uniform(0.05, 0.35) * min(shape) * rng.beta(2.0, 2.0, n)
    spread = depth * rng.uniform(0.15, 0.45)
    noise = rng.standard_normal((n, ndims)) * spread[:, None]
    pts = start[None, :] + depth[:, None] * axis[None, :] + noise
    coords = np.round(pts).astype(np.int32)
    q = 20.0 + 40.0 * rng.exponential(1.0, n).astype(np.float32)
    mask = _clip_points(coords, shape)
    return coords[mask], q[mask]


def generate_event(rng: np.random.Generator, shape: Tuple[int, ...],
                   noise_points: int = 30) -> Event:
    """One plane of ``shape`` (2D: 1-3 tracks, 1-2 showers; 3D: counts and
    noise scaled with the extent, ~2k-20k voxels at 192^3-256^3)."""
    ndims = len(shape)
    if ndims == 3:
        sc = min(shape) / 256.0
        n_tracks = int(rng.integers(max(2, round(8 * sc)),
                                    max(5, round(24 * sc) + 1)))
        n_showers = int(rng.integers(max(1, round(4 * sc)),
                                     max(3, round(12 * sc) + 1)))
        if noise_points == 30:
            noise_points = max(50, int(200 * sc))
    else:
        n_tracks = int(rng.integers(1, 4))
        n_showers = int(rng.integers(1, 3))
    coords_l, vals_l, labs_l = [], [], []
    for _ in range(n_tracks):
        r = _track(rng, shape, ndims)
        if r is not None and len(r[0]):
            coords_l.append(r[0])
            vals_l.append(r[1])
            labs_l.append(np.full(len(r[1]), 1, np.uint8))
    for _ in range(n_showers):
        c, v = _shower(rng, shape, ndims)
        if len(c):
            coords_l.append(c)
            vals_l.append(v)
            labs_l.append(np.full(len(v), 2, np.uint8))
    if noise_points:
        c = np.stack([rng.integers(0, s, noise_points) for s in shape],
                     axis=1).astype(np.int32)
        coords_l.append(c)
        vals_l.append(rng.uniform(0.5, 8.0, noise_points).astype(np.float32))
        labs_l.append(np.zeros(noise_points, np.uint8))
    coords = np.concatenate(coords_l)
    values = np.concatenate(vals_l).astype(np.float32)
    labels = np.concatenate(labs_l)
    flat = np.ravel_multi_index(coords.T, shape)
    order = np.argsort(flat, kind="stable")
    flat, coords, values, labels = (flat[order], coords[order], values[order],
                                    labels[order])
    uniq, inv = np.unique(flat, return_inverse=True)
    summed = np.zeros(len(uniq), np.float32)
    np.add.at(summed, inv, values)
    best = np.zeros(len(uniq), np.int64)
    seen = np.full(len(uniq), -np.inf)
    for i in range(len(values)):
        if values[i] > seen[inv[i]]:
            seen[inv[i]] = values[i]
            best[inv[i]] = i
    return coords[best], summed, labels[best]


def sparse_batch(events: Sequence[Event], shape: Tuple[int, ...],
                 max_points: int) -> dict:
    """The program's sparse wire batch: coords (B, P, D) int16, values
    (B, P) f32, labels (B, P) uint8, npoints (B,) int32, shape (B, D)
    int32, each row padded to ``max_points`` (later points dropped)."""
    B, D = len(events), len(shape)
    out = {"coords": np.zeros((B, max_points, D), np.int16),
           "values": np.zeros((B, max_points), np.float32),
           "labels": np.zeros((B, max_points), np.uint8),
           "npoints": np.zeros((B,), np.int32),
           "shape": np.tile(np.asarray(shape, np.int32), (B, 1))}
    for r, (c, v, lab) in enumerate(events):
        n = min(len(v), max_points)
        out["coords"][r, :n] = c[:n]
        out["values"][r, :n] = v[:n]
        out["labels"][r, :n] = lab[:n]
        out["npoints"][r] = n
    return out


def make_pool(seed: int, *, batches: int, batch_size: int,
              shape: Tuple[int, ...], max_points: int) -> List[dict]:
    """``batches`` sparse batches of distinct events drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [sparse_batch([generate_event(rng, shape)
                          for _ in range(batch_size)], shape, max_points)
            for _ in range(batches)]
