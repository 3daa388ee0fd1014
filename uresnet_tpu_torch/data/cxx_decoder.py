"""ctypes binding for the native threaded decoder (cxx/decoder).

The port's own copy of ``uresnet_tpu/data/cxx_decoder.py`` (imports rewritten to
this package); tests/test_torch_data.py holds the two equal.

Capability parity (SURVEY.md §2.2, larcv `larcv_threadio` shim [K:high]):
configure -> start_manager -> next -> fetch_data semantics, zero-copy numpy
views over the C++ rotating batch buffers. pybind11 is not in this image,
so the binding is a plain C ABI via ctypes (per environment constraints).

Build: `make -C cxx/decoder` produces liburesnet_decoder.so. `available()`
reports whether the library is loadable; the Python `BatchLoader` is the
semantics oracle and portable fallback (uresnet_tpu_torch/data/loader.py).
"""

from __future__ import annotations

import ctypes as C
import os
from typing import Dict, Optional, Sequence

import numpy as np

from uresnet_tpu_torch.config import DataConfig

_WEIGHT_MODES = {"ones": 0, "class_balance": 1, "nonzero": 2, "file": 3}

_LIB_PATHS = [
    # explicit override first (an installed package has no repo checkout)
    os.environ.get("URESNET_DECODER_LIB", ""),
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "cxx", "decoder", "liburesnet_decoder.so"),
    "liburesnet_decoder.so",
]
_LIB_PATHS = [p for p in _LIB_PATHS if p]


class _UrdConfig(C.Structure):
    _fields_ = [
        ("image_size", C.c_int32),
        ("ndims", C.c_int32),
        ("batch_size", C.c_int32),
        ("num_class", C.c_int32),
        ("n_planes", C.c_int32),
        ("planes", C.c_int32 * 8),
        ("normalize_scale", C.c_float),
        ("normalize_clip", C.c_float),
        ("weight_mode", C.c_int32),
        ("nonzero_boost", C.c_float),
        ("random_access", C.c_int32),
        ("seed", C.c_uint64),
        ("num_batch_storage", C.c_int32),
        ("sparse", C.c_int32),
        ("max_points", C.c_int32),
        ("shard_rank", C.c_int32),
        ("shard_count", C.c_int32),
        ("sparse_weights", C.c_int32),
    ]


class _UrdBatch(C.Structure):
    _fields_ = [
        ("data", C.POINTER(C.c_float)),
        ("label", C.POINTER(C.c_int32)),
        ("weight", C.POINTER(C.c_float)),
        ("coords", C.POINTER(C.c_int16)),
        ("values", C.POINTER(C.c_float)),
        ("slabels", C.POINTER(C.c_uint8)),
        ("sweights", C.POINTER(C.c_float)),
        ("npoints", C.POINTER(C.c_int32)),
        ("shape", C.POINTER(C.c_int32)),
        ("cursor", C.c_int64),
        ("slot", C.c_int32),
    ]


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        try:
            lib = C.CDLL(p)
            break
        except OSError:
            lib = None
    if lib is None:
        raise OSError("liburesnet_decoder.so not found; run `make -C cxx/decoder`")
    lib.urd_open.restype = C.c_void_p
    lib.urd_open.argtypes = [C.POINTER(C.c_char_p), C.c_int, C.POINTER(_UrdConfig)]
    lib.urd_start.argtypes = [C.c_void_p, C.c_int]
    lib.urd_next.restype = C.c_int
    lib.urd_next.argtypes = [C.c_void_p, C.POINTER(_UrdBatch)]
    lib.urd_release.argtypes = [C.c_void_p, C.c_int]
    lib.urd_stop.argtypes = [C.c_void_p]
    lib.urd_close.argtypes = [C.c_void_p]
    lib.urd_seek.argtypes = [C.c_void_p, C.c_int64]
    lib.urd_num_events.restype = C.c_int64
    lib.urd_num_events.argtypes = [C.c_void_p]
    lib.urd_last_error.restype = C.c_char_p
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


class CxxBatchLoader:
    """Drop-in counterpart of `BatchLoader` backed by the C++ decoder.

    `next(copy=True)` returns owned numpy arrays (slot released immediately);
    `copy=False` returns zero-copy views + slot id — call `release(slot)`
    after the arrays are consumed (e.g. after jax.device_put completes).
    """

    def __init__(self, cfg: DataConfig, *, num_class: int = 3,
                 train: bool = True, ndims: int = 2, start_event: int = 0,
                 files: Optional[Sequence[str]] = None,
                 shard: tuple = (0, 1)):
        lib = _load()
        self._lib = lib
        self.cfg = cfg
        self.ndims = ndims
        self.shard = shard
        # Row math MUST mirror the C++ slot allocation (decoder.cpp
        # urd_open): rows = (batch_size/n_planes/shard_count) * n_planes.
        # Anything else makes the numpy views over- or under-run the slot
        # buffers.
        from uresnet_tpu_torch.data.loader import check_batch_geometry

        n_planes = len(cfg.planes)
        self._rows = check_batch_geometry(cfg.batch_size, n_planes, shard[1])
        paths = list(files if files is not None else cfg.input_files)
        if not paths:
            raise ValueError("CxxBatchLoader requires input files")
        self._files = paths  # same introspection surface as BatchLoader
        c = _UrdConfig(
            image_size=cfg.image_size,
            ndims=ndims,
            batch_size=cfg.batch_size,
            num_class=num_class,
            n_planes=len(cfg.planes),
            normalize_scale=cfg.normalize_scale,
            normalize_clip=cfg.normalize_clip,
            weight_mode=_WEIGHT_MODES[cfg.weight_mode],
            nonzero_boost=cfg.weight_nonzero_boost,
            random_access=1 if (cfg.random_access and train) else 0,
            seed=cfg.seed,
            num_batch_storage=cfg.num_batch_storage,
            sparse=1 if cfg.transfer == "sparse" else 0,
            max_points=cfg.max_points,
            shard_rank=shard[0],
            shard_count=shard[1],
            sparse_weights=1 if (cfg.transfer == "sparse"
                                 and cfg.weight_mode == "file") else 0,
        )
        self._sparse = cfg.transfer == "sparse"
        self._sparse_weights = bool(c.sparse_weights)
        for i, p in enumerate(cfg.planes):
            c.planes[i] = p
        arr = (C.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._h = lib.urd_open(arr, len(paths), C.byref(c))
        if not self._h:
            raise RuntimeError(lib.urd_last_error().decode())
        if start_event:
            lib.urd_seek(self._h, start_event)
        self._shape = (self._rows,) + (cfg.image_size,) * ndims
        self._started = False

    def start(self, num_threads: Optional[int] = None) -> "CxxBatchLoader":
        n = num_threads if num_threads is not None else self.cfg.num_threads
        self._lib.urd_start(self._h, max(1, n))
        self._started = True
        return self

    def next(self, copy: bool = True) -> Dict[str, np.ndarray]:
        if not self._started:
            self.start()
        b = _UrdBatch()
        slot = self._lib.urd_next(self._h, C.byref(b))
        if slot < 0:
            raise RuntimeError(self._lib.urd_last_error().decode())
        B = self._rows
        if self._sparse:
            P, nd = self.cfg.max_points, self.ndims
            arr = lambda ptr, shape: np.ctypeslib.as_array(
                ptr, (int(np.prod(shape)),)).reshape(shape)
            out = {
                "coords": arr(b.coords, (B, P, nd)),
                "values": arr(b.values, (B, P)),
                "labels": arr(b.slabels, (B, P)),
                "npoints": arr(b.npoints, (B,)),
                "shape": arr(b.shape, (B, nd)),
            }
            if self._sparse_weights:
                out["weights"] = arr(b.sweights, (B, P))
            if copy:
                out = {k: v.copy() for k, v in out.items()}
            out["cursor"] = np.int64(b.cursor)
        else:
            n = int(np.prod(self._shape))
            data = np.ctypeslib.as_array(b.data, (n,)).reshape(self._shape)
            label = np.ctypeslib.as_array(b.label, (n,)).reshape(self._shape)
            weight = np.ctypeslib.as_array(b.weight, (n,)).reshape(self._shape)
            out = {
                "data": (data.copy() if copy else data)[..., None],
                "label": label.copy() if copy else label,
                "weight": weight.copy() if copy else weight,
                "cursor": np.int64(b.cursor),
            }
        if copy:
            self._lib.urd_release(self._h, slot)
        else:
            out["slot"] = slot
        return out

    def release(self, slot: int):
        self._lib.urd_release(self._h, slot)

    def seek(self, cursor: int):
        """Restore the data cursor. Only valid on a stopped loader — the
        C++ fill workers derive each ticket's event range from the cursor
        at fill time, so seeking mid-stream would interleave two streams
        and break deterministic resume (same contract as BatchLoader.seek).
        stop() -> seek() -> start() on the SAME handle resumes the exact
        deterministic stream (urd_stop rewinds the ticket/slot ring,
        urd_start clears the stop flag — decoder.cpp)."""
        if self._started:
            raise RuntimeError("seek() requires a stopped loader")
        self._lib.urd_seek(self._h, cursor)

    def num_events(self) -> int:
        return int(self._lib.urd_num_events(self._h))

    def total_events(self) -> int:
        """Pre-shard dataset total (same contract as
        BatchLoader.total_events — the exactly-once evaluator's SPMD-safe
        batch count derives from this host-independent number)."""
        from uresnet_tpu_torch.data import events as ev

        return sum(ev.num_events(f) for f in self._files)

    def stop(self):
        if self._h:
            self._lib.urd_stop(self._h)
            self._started = False

    def close(self):
        if self._h:
            self._lib.urd_close(self._h)
            self._h = None

    def __iter__(self):
        while True:
            yield self.next()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
