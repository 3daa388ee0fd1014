"""Rulebooks of the submanifold sparse U-ResNet (models/sparse_uresnet.py),
built on the device once per batch and shared by every convolution of a
level, forward and backward.

A padded sparse batch (coords (B, P, D), values, labels, npoints; the wire
layout of data/pipeline.py) becomes compact rows: one site per distinct
voxel of each event (the last of its points wins, as densify_on_device's
scatter), in Morton (z-order) order of (event, voxel). A level's site is
``coords >> level``; Morton order is kept under that shift, so one sort of
the points orders every level, and a tile of consecutive sites is a
compact block of space. Each level's tables hold row indices (int32, -1
where nothing is there), laid out (offsets, rows) so that the kernels of
ops/cuda/sparse_conv.py read a row tile's entries for one offset
contiguously:

  nbr   (3^D, n_l)         the site at coords + delta_k, delta_k the k-th of
                           {-1, 0, 1}^D in C order (the 3^D kernel's
                           (*k, C_in, C_out) layout): the submanifold
                           convolution, whose outputs are its inputs;
                           delta_{K-1-k} = -delta_k, so its input gradient
                           is the same table with the offsets mirrored
  down  (2^D, n_{l+1})     the child at octant o (coords mod 2, C order) of
                           each coarse site: the stride-2 kernel-2
                           convolution; each fine site has one parent
  up    (2^D, n_l)         each fine site's parent at its own octant, -1 at
                           the other octants: the transposed convolution,
                           and the input gradient of ``down``

Everything is torch on the batch's device and nothing is shaped by the
extent: the only dense index is over the batch's padded points. Two host
syncs a batch: the sites of every level at once (`prepare`), then the
pairs of every table at once (`rulebook`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from uresnet_tpu_torch.ops.cuda.sparse_conv import CHUNK

_SENTINEL = 1 << 62  # the key of a padded point: after every real one


@dataclasses.dataclass
class Rule:
    """A table (K, n_out) int32 (None: the identity, K = 1) and, for the
    weight gradient's kernel, its pairs: the output rows that each offset
    has, offset-major, each offset's run padded with -1 to a multiple of
    CHUNK; ``chunk_k`` the offset of each run of CHUNK."""
    table: Optional[torch.Tensor] = None
    pairs: Optional[torch.Tensor] = None
    chunk_k: Optional[torch.Tensor] = None

    @property
    def n_pairs(self) -> int:
        return int((self.table >= 0).sum())


IDENTITY = Rule()


@dataclasses.dataclass
class Level:
    n: int                  # sites
    coords: torch.Tensor    # (n, D) int64, the level's grid
    event: torch.Tensor     # (n,) int64, the row of the batch
    nbr: Rule               # (3^D, n)


@dataclasses.dataclass
class Rulebook:
    levels: List[Level]
    down: List[Rule]        # [l]: (2^D, n_{l+1})
    up: List[Rule]          # [l]: (2^D, n_l)


@dataclasses.dataclass
class SparseBatch:
    """A padded sparse batch as the sparse net takes it: level-0 site rows
    and the rulebook. ``point_site`` (B, P) maps each point to its site
    (-1 for padding); ``site_point`` (n_0,) is each site's point (the one
    that won), as a flat index into (B * P)."""
    feats: torch.Tensor       # (n_0, 1) f32 normalized charge
    label: torch.Tensor       # (n_0,) int64
    weight: torch.Tensor      # (n_0,) f32
    event: torch.Tensor       # (n_0,) int64, the row of the batch
    point_site: torch.Tensor  # (B, P) int64
    site_point: torch.Tensor  # (n_0,) int64
    origin: Optional[torch.Tensor] = None  # (B, D) int64, the window's
    rules: Optional[Rulebook] = None
    # what `prepare` sorted, kept for `rulebook`
    _sorted: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def batch_size(self) -> int:
        return self.point_site.shape[0]

    def at_points(self, rows: torch.Tensor) -> torch.Tensor:
        """Per-site rows (n_0, C) -> (B, P, C) at the batch's points, zeros
        at padding."""
        B, P = self.point_site.shape
        idx = self.point_site.reshape(-1)
        out = rows[idx.clamp(min=0)] * (idx >= 0)[:, None].to(rows.dtype)
        return out.reshape(B, P, rows.shape[-1])


def _spread(x: torch.Tensor, D: int) -> torch.Tensor:
    """The bits of ``x`` spread to every D-th bit (bit b to bit b * D)."""
    if D == 3:  # up to 21 bits
        x = x & 0x1FFFFF
        for shift, mask in ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                            (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                            (2, 0x1249249249249249)):
            x = (x | (x << shift)) & mask
        return x
    if D == 2:  # up to 31 bits
        x = x & 0x7FFFFFFF
        for shift, mask in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
                            (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
                            (1, 0x5555555555555555)):
            x = (x | (x << shift)) & mask
        return x
    out = torch.zeros_like(x)
    for b in range(62 // D):
        out |= ((x >> b) & 1) << (b * D)
    return out


def morton(coords: torch.Tensor) -> torch.Tensor:
    """(..., D) non-negative int64 coordinates -> (...,) Morton keys: bit b
    of axis d at b * D + (D - 1 - d), so axis 0 is the most significant of
    each group of D bits."""
    D = coords.shape[-1]
    key = _spread(coords[..., 0], D)
    for d in range(1, D):
        key = (key << 1) | _spread(coords[..., d], D)
    return key


def _axis_mask(D: int, d: int, bits: int) -> int:
    """The bits of axis ``d`` in a Morton key of ``bits`` bits an axis."""
    return sum(1 << (b * D + D - 1 - d) for b in range(bits))


def extent_bits(extent: int) -> int:
    return max(1, (int(extent) - 1).bit_length())


def _kept(keep: torch.Tensor, n: int) -> torch.Tensor:
    """The positions of the ``n`` True entries of ``keep``, in order: the
    k-th first (or last) point of a run is the k-th site's."""
    return torch.nonzero_static(keep, size=n)[:, 0]


def _site_weight(label, event, B: int, num_class: int, mode: str,
                 feats, point_weight, boost: float) -> torch.Tensor:
    """Per-site loss weights: 'ones'; 'class_balance' n / (num_class *
    sites of the class), over each event's sites (0 for an absent class,
    as densify_on_device over pixels); 'nonzero' 1 + boost where charged;
    'file' the winning point's stored weight."""
    if mode == "ones":
        return torch.ones_like(feats[:, 0])
    if mode == "nonzero":
        return 1.0 + (feats[:, 0] > 0).float() * boost
    if mode == "file":
        return point_weight.float()
    if mode != "class_balance":
        raise ValueError(f"unknown weight mode {mode!r}")
    # the sites are in event order: each event's class counts are the
    # differences of each class's running count at the event's bounds (an
    # index_add into B x num_class bins serializes its atomics: 1.1 ms of
    # a 768^3 batch on the H100; one scan a class runs along a contiguous
    # row)
    seen = torch.stack([(label == c).cumsum(0) for c in range(num_class)])
    seen = torch.nn.functional.pad(seen, (1, 0))
    bounds = torch.searchsorted(event, torch.arange(B + 1,
                                                    device=event.device))
    counts = (seen[:, bounds[1:]] - seen[:, bounds[:-1]]).T.float()
    n = counts.sum(1, keepdim=True)
    w = torch.where(counts > 0, n / (num_class * counts.clamp(min=1)),
                    torch.zeros_like(counts))
    return w.reshape(-1)[event * num_class + label]


def prepare(sparse: Dict[str, torch.Tensor], *, extent: int, levels: int,
            num_class: int, normalize_scale: float, normalize_clip: float,
            weight_mode: str = "ones", nonzero_boost: float = 1.0,
            origin: Optional[torch.Tensor] = None) -> SparseBatch:
    """A padded sparse batch (on any device) -> its level-0 rows, sorted
    for a rulebook of ``levels`` levels (`rulebook`). ``origin`` (B, D):
    each event's window, whose corner is moved to 0. Points outside [0,
    extent)^D, or beyond an event's ``npoints``, are dropped. One host
    sync, for the sites of every level."""
    coords = sparse["coords"].long()
    if origin is not None:
        coords = coords - origin[:, None, :]
    B, P, D = coords.shape
    dev = coords.device
    bits = extent_bits(extent)
    if levels - 1 > bits:
        raise ValueError(f"{levels} levels need an extent of at least "
                         f"2^{levels - 1}, got {extent}")
    valid = ((torch.arange(P, device=dev)[None, :]
              < sparse["npoints"].long()[:, None])
             & ((coords >= 0) & (coords < extent)).all(-1))
    event = torch.arange(B, device=dev)[:, None].expand(B, P)
    key = morton(coords.clamp(0, extent - 1)) | (event << (bits * D))
    key = torch.where(valid, key, torch.full_like(key, _SENTINEL)).view(-1)
    skey, perm = torch.sort(key, stable=True)
    real = skey != _SENTINEL
    # per level: the first point of each site, the site of each point
    firsts, sidx = [], []
    for lvl in range(levels):
        k = skey >> (D * lvl)
        first = real.clone()
        first[1:] &= k[1:] != k[:-1]
        firsts.append(first)
        sidx.append(torch.cumsum(first, 0) - 1)
    ns = [int(n) for n in torch.stack([f.sum() for f in firsts]).tolist()]
    n0 = ns[0]
    last = real.clone()  # the last point of each level-0 site wins
    last[:-1] &= firsts[0][1:] | ~real[1:]
    site_point = perm[_kept(last, n0)]
    feats = torch.clamp(sparse["values"].float().view(-1)[site_point]
                        * normalize_scale, 0.0, normalize_clip)[:, None]
    label = sparse["labels"].long().view(-1)[site_point]
    site_event = site_point // P
    pw = sparse.get("weights")
    weight = _site_weight(
        label, site_event, B, num_class, weight_mode, feats,
        None if pw is None else pw.float().view(-1)[site_point],
        nonzero_boost)
    point_site = torch.full((B * P,), -1, dtype=torch.int64, device=dev)
    point_site[perm] = torch.where(real, sidx[0], torch.full_like(sidx[0], -1))
    batch = SparseBatch(feats=feats, label=label, weight=weight,
                        event=site_event, point_site=point_site.view(B, P),
                        site_point=site_point, origin=origin)
    batch._sorted = (skey, coords.view(-1, D)[perm], firsts, sidx, ns, bits,
                     extent)
    return batch


def prepare_for(cfg, sparse: Dict[str, torch.Tensor], *,
                weight_mode: Optional[str] = None) -> SparseBatch:
    """`prepare` with a Config's sizes and data settings: the window of
    ``data.image_size`` that densify_on_device would crop (its
    ``crop_origin``: 0 where the event's extent is the window's),
    ``model.depth + 1`` levels, and ``data.weight_mode`` unless
    ``weight_mode`` is given."""
    from uresnet_tpu_torch.data.device_pipeline import crop_origin

    d, m = cfg.data, cfg.model
    return prepare(sparse, extent=d.image_size, levels=m.depth + 1,
                   num_class=m.num_class, normalize_scale=d.normalize_scale,
                   normalize_clip=d.normalize_clip,
                   weight_mode=weight_mode or d.weight_mode,
                   nonzero_boost=d.weight_nonzero_boost,
                   origin=crop_origin(sparse, image_size=d.image_size))


def rulebook(batch: SparseBatch) -> Rulebook:
    """The rulebook of a batch from `prepare`: every level's sites and
    neighbour table, and the maps between levels, with their pair lists.
    Frees what `prepare` kept for it. One host sync, for the pairs of
    every table."""
    skey, flat_c, firsts, sidx, ns, bits, extent = batch._sorted
    batch._sorted = None
    D = flat_c.shape[1]
    dev = skey.device
    levels, nbr, down, up, octs = [], [], [], [], []
    for lvl, n in enumerate(ns):
        at = _kept(firsts[lvl], n)
        k = skey[at] >> (D * lvl)
        c = flat_c[at] >> lvl
        octs.append(k & ((1 << D) - 1))
        levels.append((n, c, k >> ((bits - lvl) * D)))
        nbr.append(_neighbours(k, c, bits - lvl,
                               (extent + (1 << lvl) - 1) >> lvl))
    for lvl in range(len(ns) - 1):
        n, nc = ns[lvl], ns[lvl + 1]
        parent = sidx[lvl + 1][_kept(firsts[lvl], n)]
        rows = torch.arange(n, device=dev)
        oc = octs[lvl]
        d = torch.full(((1 << D) * nc,), -1, dtype=torch.int32, device=dev)
        d[oc * nc + parent] = rows.int()
        u = torch.full(((1 << D) * n,), -1, dtype=torch.int32, device=dev)
        u[oc * n + rows] = parent.int()
        down.append(d.view(1 << D, nc))
        up.append(u.view(1 << D, n))
    tables = nbr + down + up
    counts = [(t >= 0).sum(1) for t in tables]
    host = torch.cat(counts).tolist()
    rules = []
    for t, count in zip(tables, counts):
        rules.append(_rule(t, count, host[:t.shape[0]]))
        host = host[t.shape[0]:]
    L = len(ns)
    return Rulebook(
        levels=[Level(n=n, coords=c, event=e, nbr=r)
                for (n, c, e), r in zip(levels, rules[:L])],
        down=rules[L:2 * L - 1], up=rules[2 * L - 1:])


def _neighbours(keys: torch.Tensor, coords: torch.Tensor, bits: int,
                extent: int) -> torch.Tensor:
    """(3^D, n) int32: the index of the site at coords + delta_k among the
    level's sorted, distinct ``keys`` (Morton keys of ``bits`` bits an
    axis, the event above them), or -1. Each axis's -1, 0 and +1 is added
    to the key in place (masked carries), and the 3^D keys are their
    combinations. Only the first half of the offsets is searched: the
    centre is the site itself, and delta_{K-1-k} = -delta_k, so j is i's
    neighbour at K-1-k where i is j's at k."""
    n, D = coords.shape
    K = 3 ** D
    shape = [1] * D + [n]
    want = keys & ~sum(_axis_mask(D, d, bits) for d in range(D))
    inside = torch.ones((1,) * D + (n,), dtype=torch.bool, device=keys.device)
    for d in range(D):
        m, one = _axis_mask(D, d, bits), 1 << (D - 1 - d)
        own = keys & m
        part = torch.stack([(own - one) & m, own, ((keys | ~m) + one) & m])
        c = coords[:, d]
        ok = torch.stack([c > 0, torch.ones_like(c, dtype=torch.bool),
                          c < extent - 1])
        shape[d] = 3
        want = want | part.view(shape)
        inside = inside & ok.view(shape)
        shape[d] = 1
    half = K // 2
    want = want.reshape(K, n)[:half]
    inside = inside.reshape(K, n)[:half]
    rows = torch.arange(n, device=keys.device)
    nbr = torch.full((K, n + 1), -1, dtype=torch.int64, device=keys.device)
    nbr[half, :n] = rows
    if n:
        pos = torch.searchsorted(keys, want.reshape(-1)).view(want.shape)
        pos = pos.clamp(max=n - 1)
        hit = inside & (keys[pos] == want)
        nbr[:half, :n] = torch.where(hit, pos, torch.full_like(pos, -1))
        # the mirrored offsets; misses go to the spare column n
        nbr[K - 1 - torch.arange(half, device=keys.device)[:, None],
            torch.where(hit, pos, torch.full_like(pos, n))] = rows
    return nbr[:, :n].int().contiguous()


def _rule(table: torch.Tensor, count: torch.Tensor, host: List[int]) -> Rule:
    """``table`` with its pairs (`Rule`): ``count`` each offset's pairs,
    on the device and (``host``) on the host, which sizes them without a
    sync."""
    K, n = table.shape
    dev = table.device
    total = sum(host)
    n_chunks = sum(-(-c // CHUNK) for c in host)
    nz = torch.nonzero_static(table >= 0, size=total)  # offset-major
    runs = (count + CHUNK - 1) // CHUNK
    first_run = torch.cumsum(runs, 0) - runs
    first_pair = torch.cumsum(count, 0) - count
    k = nz[:, 0]
    at = first_run[k] * CHUNK + torch.arange(total, device=dev) - first_pair[k]
    pairs = torch.full((n_chunks * CHUNK,), -1, dtype=torch.int32, device=dev)
    pairs[at] = nz[:, 1].int()
    chunk_k = torch.repeat_interleave(
        torch.arange(K, device=dev, dtype=torch.int32), runs,
        output_size=n_chunks)
    return Rule(table=table, pairs=pairs, chunk_k=chunk_k)
