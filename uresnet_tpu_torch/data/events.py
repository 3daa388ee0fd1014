"""USEF — U-ResNet Sparse Event Format (ROOT-free larcv replacement).

The port's own copy of ``uresnet_tpu/data/events.py`` (imports rewritten to
this package); tests/test_torch_data.py holds the two equal.

Capability parity (SURVEY.md §2.2): the reference stores LArTPC events as
larcv `Image2D`/`Voxel3D` sparse products inside ROOT TTrees. ROOT support is
an explicit non-goal (SURVEY.md §7); instead we define a flat binary format
carrying the same physics content — per-event sparse (coords, charge, label)
per wire plane — readable by both numpy (this module) and the C++ decoder
(`cxx/decoder/decoder.cpp`), with an O(1) per-event index table for random
access (the TTree-random-access equivalent, SURVEY.md §3.4).

Layout (little-endian):
    header:  magic 'USEF' | u32 version (1|2) | u32 ndims (2|3) | u64 num_events
    index:   u64 byte offset of each event (num_events entries)
    event:   u32 num_planes
             per plane: u32 plane_id | u32 shape[ndims] | u32 npoints
                        i32 coords[npoints*ndims] | f32 values[npoints]
                        u8 labels[npoints]
                        (v2 only) u8 has_weights | f32 weights[npoints] if 1

Labels are sparse at the charge coordinates; pixels with no charge are
background (class 0) by construction — matching LArTPC semantics where
~99% of the image is empty (SURVEY.md §2.1 "Loss & metrics").

Version 2 adds the reference's per-pixel WEIGHT product (SURVEY.md §2.1
larcv-IO row: BatchFillerImage2D entries for data/label/weight; §2.2
"weights as parallel images"): an optional f32 weight per point, carried
alongside charge and label. Weights are sparse at the charge coordinates;
pixels without a point take weight 1.0 at densify time (plain CE on the
background — the file-driven maps the reference exports weight the charge
topology). The writer emits version 1 (bit-identical to round-2 files)
when no plane carries weights, so v1 readers/goldens are unaffected.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

MAGIC = b"USEF"
VERSION = 2          # highest version this module reads/writes
_READABLE = (1, 2)


@dataclass
class SparsePlane:
    plane_id: int
    shape: Tuple[int, ...]            # full detector image shape (rows, cols[, depth])
    coords: np.ndarray                # (npoints, ndims) int32
    values: np.ndarray                # (npoints,) float32
    labels: np.ndarray                # (npoints,) uint8
    weights: np.ndarray | None = None  # (npoints,) float32 per-pixel weight
                                       # product (v2; None = not stored)


@dataclass
class SparseEvent:
    planes: List[SparsePlane]

    @property
    def ndims(self) -> int:
        return self.planes[0].coords.shape[1] if self.planes else 2


def write_events(path: str, events: Sequence[SparseEvent], ndims: int = 2) -> None:
    # v1 unless some plane carries weights: weightless files stay
    # byte-identical to pre-v2 output (old readers/goldens unaffected).
    version = 1
    for evt in events:
        if any(pl.weights is not None for pl in evt.planes):
            version = 2
            break
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<IIQ", version, ndims, len(events)))
        index_pos = f.tell()
        f.write(b"\x00" * (8 * len(events)))  # placeholder index
        offsets = []
        for evt in events:
            offsets.append(f.tell())
            f.write(struct.pack("<I", len(evt.planes)))
            for pl in evt.planes:
                assert pl.coords.shape[1] == ndims
                f.write(struct.pack("<I", pl.plane_id))
                f.write(struct.pack(f"<{ndims}I", *pl.shape))
                n = len(pl.values)
                f.write(struct.pack("<I", n))
                f.write(np.ascontiguousarray(pl.coords, np.int32).tobytes())
                f.write(np.ascontiguousarray(pl.values, np.float32).tobytes())
                f.write(np.ascontiguousarray(pl.labels, np.uint8).tobytes())
                if version >= 2:
                    if pl.weights is not None:
                        assert len(pl.weights) == n
                        f.write(struct.pack("<B", 1))
                        f.write(np.ascontiguousarray(
                            pl.weights, np.float32).tobytes())
                    else:
                        f.write(struct.pack("<B", 0))
        f.seek(index_pos)
        f.write(np.asarray(offsets, np.uint64).tobytes())


def read_header(path: str) -> Tuple[int, int, np.ndarray]:
    """Returns (version, ndims, offsets)."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: not a USEF file")
        version, ndims, n = struct.unpack("<IIQ", f.read(16))
        if version not in _READABLE:
            raise ValueError(f"{path}: unsupported USEF version {version}")
        if not 1 <= ndims <= 8:
            # corrupt dimensionality (mirrors the C++ reader's bound;
            # ndims=0 would otherwise silently mis-parse every plane)
            raise ValueError(f"{path}: corrupt USEF ndims {ndims}")
        # Size-bound the count BEFORE the read (mirrors the C++ reader's
        # guard): a corrupt header with n ~ 2^60 would otherwise overflow
        # f.read(8*n) instead of hitting the truncated-index error below.
        size = os.fstat(f.fileno()).st_size
        if n > max(size - 20, 0) // 8:
            raise ValueError(
                f"{path}: truncated USEF index ({max(size - 20, 0) // 8} "
                f"of {n} event offsets)")
        offsets = np.frombuffer(f.read(8 * n), np.uint64)
        if len(offsets) != n:
            # an index truncated at an 8-byte boundary would otherwise
            # silently present as a shorter (valid-looking) file
            raise ValueError(
                f"{path}: truncated USEF index ({len(offsets)} of {n} "
                f"event offsets)")
        # Every event offset must land inside the payload region (mirrors
        # the C++ reader): a corrupt index pointing into the header/index
        # or past EOF would otherwise parse garbage bytes as an event.
        hdr_end = 20 + 8 * n
        if n and (int(offsets.min()) < hdr_end
                  or int(offsets.max()) >= size):
            raise ValueError(
                f"{path}: corrupt USEF index (event offset outside the "
                f"payload region [{hdr_end}, {size}))")
    return version, ndims, offsets


def read_events(path: str, indices: Sequence[int] | None = None) -> List[SparseEvent]:
    version, ndims, offsets = read_header(path)
    if indices is None:
        indices = range(len(offsets))
    events = []
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size

        def take(nbytes: int, what: str) -> bytes:
            # every payload read is length-validated: np.frombuffer accepts
            # a SHORT read without error for uint8 (labels) and for any
            # multiple of the item size (values/weights), so a truncated
            # event would otherwise come back as silently shorter arrays
            # instead of a loud rejection (mirrors the C++ reader's
            # read()==n contract)
            b = f.read(nbytes)
            if len(b) != nbytes:
                raise ValueError(
                    f"{path}: truncated USEF event ({what}: {len(b)} of "
                    f"{nbytes} bytes)")
            return b

        for i in indices:
            f.seek(int(offsets[i]))
            (num_planes,) = struct.unpack("<I", take(4, "num_planes"))
            if num_planes > size // 12:
                # size-bound corrupt counts (C++ reader parity): a plane
                # record occupies >= 12 bytes
                raise ValueError(
                    f"{path}: corrupt USEF event (num_planes {num_planes} "
                    f"exceeds the file size bound)")
            planes = []
            for _ in range(num_planes):
                (plane_id,) = struct.unpack("<I", take(4, "plane_id"))
                shape = struct.unpack(f"<{ndims}I", take(4 * ndims, "shape"))
                (n,) = struct.unpack("<I", take(4, "npoints"))
                if n > size // (4 * ndims + 5):
                    # a point occupies >= 4*ndims + 5 bytes (C++ parity)
                    raise ValueError(
                        f"{path}: corrupt USEF plane (npoints {n} exceeds "
                        f"the file size bound)")
                coords = np.frombuffer(take(4 * n * ndims, "coords"),
                                       np.int32).reshape(n, ndims)
                values = np.frombuffer(take(4 * n, "values"), np.float32)
                labels = np.frombuffer(take(n, "labels"), np.uint8)
                weights = None
                if version >= 2:
                    (has_w,) = struct.unpack("<B", take(1, "has_weights"))
                    if has_w:
                        weights = np.frombuffer(
                            take(4 * n, "weights"), np.float32).copy()
                planes.append(SparsePlane(plane_id, shape, coords.copy(),
                                          values.copy(), labels.copy(),
                                          weights))
            events.append(SparseEvent(planes))
    return events


def num_events(path: str) -> int:
    return len(read_header(path)[2])


def max_plane_points(path: str,
                     planes: Sequence[int] | None = None) -> int:
    """Largest per-plane point count in the file (metadata-only scan — one
    seek per plane, payloads skipped), optionally restricted to the given
    plane ids (an unselected busy plane must not inflate the pad). The
    inference path sizes its sparse pad length from this so ana NEVER
    truncates events, whatever data.max_points the training wire uses
    (engine/evaluator.py)."""
    version, ndims, offsets = read_header(path)
    sel = None if planes is None else set(planes)
    m = 0
    with open(path, "rb") as f:
        for off in offsets:
            f.seek(int(off))
            (n_planes,) = struct.unpack("<I", f.read(4))
            for _ in range(n_planes):
                (plane_id,) = struct.unpack("<I", f.read(4))
                f.seek(4 * ndims, 1)                # shape
                (n,) = struct.unpack("<I", f.read(4))
                if sel is None or plane_id in sel:
                    m = max(m, n)
                f.seek(n * (4 * ndims + 4 + 1), 1)  # coords+values+labels
                if version >= 2:
                    (has_w,) = struct.unpack("<B", f.read(1))
                    if has_w:
                        f.seek(4 * n, 1)
    return m
