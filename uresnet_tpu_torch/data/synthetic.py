"""Synthetic LArTPC-like event generator (tracks / showers / background).

The port's own copy of ``uresnet_tpu/data/synthetic.py`` (imports rewritten to
this package); tests/test_torch_data.py holds the two equal.

The reference trains on the DeepLearnPhysics open LArTPC dataset
(SURVEY.md §4); that data is not available in this environment, so this
module generates physics-shaped stand-ins with the same sparse structure:

  * tracks  (label 1): straight MIP-like line segments with Landau-ish
    charge fluctuations — the linear topology SSNet separates;
  * showers (label 2): EM-shower-like branching cascades — fuzzy, scattered
    depositions around a direction cone;
  * background (label 0): everything without charge (implicit) plus sparse
    low-charge noise hits.

Events are emitted in the USEF sparse format so the full decode path
(C++ or numpy) is exercised exactly as it would be on real exported larcv
data.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from uresnet_tpu_torch.data.events import SparseEvent, SparsePlane

# Generator revision, part of the synthetic-cache filename
# (loader.resolve_input_files): bump when generated events change so stale
# /tmp caches from older revisions are never silently reused.
# r2: realistic 3D occupancy — the original generator emitted the same
# structure COUNTS in 3D as in 2D (~600 points), i.e. 0.003% of a 192^3
# volume vs the ~0.1-1% of real voxelized LArTPC samples (and vs 0.23% in
# our own 2D). That regime made batch-1 3D training statistically
# degenerate (a handful of voxels carried class weights of ~14,000x; see
# benchmarks/RESULTS.md round-3 "3D quality"). 3D events now carry
# proportionally more tracks/showers and denser cascades; 2D output is
# byte-identical to r1.
GEN_VERSION = 2


def _clip_points(coords: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    mask = np.ones(len(coords), bool)
    for d, s in enumerate(shape):
        mask &= (coords[:, d] >= 0) & (coords[:, d] < s)
    return mask


def _track(rng: np.random.Generator, shape, ndims: int):
    """Straight line with per-step charge fluctuation."""
    start = np.array([rng.uniform(0, s) for s in shape])
    theta = rng.uniform(0, 2 * np.pi)
    if ndims == 2:
        direction = np.array([np.sin(theta), np.cos(theta)])
    else:
        phi = rng.uniform(0, np.pi)
        direction = np.array([np.sin(phi) * np.sin(theta),
                              np.sin(phi) * np.cos(theta), np.cos(phi)])
    length = rng.uniform(0.2, 0.9) * min(shape)
    steps = int(length)
    if steps < 2:
        return None
    t = np.arange(steps)[:, None]
    pts = start[None, :] + t * direction[None, :]
    coords = np.round(pts).astype(np.int32)
    # MIP dE/dx with Landau-like tail
    q = 60.0 + 25.0 * rng.standard_gamma(2.0, steps).astype(np.float32)
    mask = _clip_points(coords, shape)
    return coords[mask], q[mask]


def _shower(rng: np.random.Generator, shape, ndims: int):
    """Branching cascade: points scattered in a cone with falling profile.

    3D cascades carry more depositions (a cone section is a volume, not an
    area): n scales so 3D occupancy lands in the realistic regime (see
    GEN_VERSION note)."""
    start = np.array([rng.uniform(0.1 * s, 0.9 * s) for s in shape])
    theta = rng.uniform(0, 2 * np.pi)
    if ndims == 2:
        axis = np.array([np.sin(theta), np.cos(theta)])
    else:
        phi = rng.uniform(0, np.pi)
        axis = np.array([np.sin(phi) * np.sin(theta),
                         np.sin(phi) * np.cos(theta), np.cos(phi)])
    if ndims == 3:
        sc = min(shape) / 256.0        # extent-scaled cascade density
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


def generate_event(
    rng: np.random.Generator,
    *,
    shape: Tuple[int, ...] = (512, 512),
    planes: Tuple[int, ...] = (2,),
    noise_points: int = 30,
) -> SparseEvent:
    ndims = len(shape)
    out_planes: List[SparsePlane] = []
    if ndims == 3:
        # realistic 3D multiplicity (GEN_VERSION note): ~2k-20k voxels per
        # 192^3-256^3 event, matching the occupancy regime of public
        # voxelized LArTPC samples rather than a 2D event's structure
        # count; extent-scaled so small test volumes stay proportionate
        sc = min(shape) / 256.0
        n_tracks = int(rng.integers(max(2, round(8 * sc)),
                                    max(5, round(24 * sc) + 1)))
        n_showers = int(rng.integers(max(1, round(4 * sc)),
                                     max(3, round(12 * sc) + 1)))
        if noise_points == 30:          # the default; explicit values win
            noise_points = max(50, int(200 * sc))
    else:
        n_tracks = int(rng.integers(1, 4))
        n_showers = int(rng.integers(1, 3))
    for plane_id in planes:
        coords_l, vals_l, labs_l = [], [], []
        for _ in range(n_tracks):
            r = _track(rng, shape, ndims)
            if r is not None and len(r[0]):
                coords_l.append(r[0]); vals_l.append(r[1])
                labs_l.append(np.full(len(r[1]), 1, np.uint8))
        for _ in range(n_showers):
            c, v = _shower(rng, shape, ndims)
            if len(c):
                coords_l.append(c); vals_l.append(v)
                labs_l.append(np.full(len(v), 2, np.uint8))
        if noise_points:
            c = np.stack([rng.integers(0, s, noise_points) for s in shape],
                         axis=1).astype(np.int32)
            v = rng.uniform(0.5, 8.0, noise_points).astype(np.float32)
            coords_l.append(c); vals_l.append(v)
            labs_l.append(np.zeros(noise_points, np.uint8))
        coords = np.concatenate(coords_l)
        values = np.concatenate(vals_l).astype(np.float32)
        labels = np.concatenate(labs_l)
        # Deduplicate overlapping depositions: keep the max-charge label,
        # sum the charge (LArTPC-style charge accumulation).
        flat = np.ravel_multi_index(coords.T, shape)
        order = np.argsort(flat, kind="stable")
        flat, coords, values, labels = flat[order], coords[order], values[order], labels[order]
        uniq, inv = np.unique(flat, return_inverse=True)
        summed = np.zeros(len(uniq), np.float32)
        np.add.at(summed, inv, values)
        # label of the max-charge contributor per pixel
        best = np.zeros(len(uniq), np.int64)
        seen = np.full(len(uniq), -np.inf)
        for i in range(len(values)):
            if values[i] > seen[inv[i]]:
                seen[inv[i]] = values[i]
                best[inv[i]] = i
        out_planes.append(SparsePlane(
            plane_id=plane_id,
            shape=shape,
            coords=coords[best],
            values=summed,
            labels=labels[best],
        ))
    return SparseEvent(out_planes)


def generate_file(
    path: str,
    n_events: int,
    *,
    seed: int = 0,
    shape: Tuple[int, ...] = (512, 512),
    planes: Tuple[int, ...] = (2,),
) -> str:
    from uresnet_tpu_torch.data.events import write_events

    rng = np.random.default_rng(seed)
    events = [generate_event(rng, shape=shape, planes=planes)
              for _ in range(n_events)]
    write_events(path, events, ndims=len(shape))
    return path
