"""Batch loader.

The port's own copy of ``uresnet_tpu/data/loader.py`` (imports rewritten to
this package); tests/test_torch_data.py holds the two equal.

Capability parity (SURVEY.md §2.1/§3.4): the reference's `larcv_threadio`
contract — configure(files, batch size, threads, random access), start,
`next()` returning (data, label, weight) batches filled ahead of the
training loop by native worker threads. The JAX module's jax-based
``device_prefetch`` and its ``stack_batches`` are left out: the port stages
batches on the card with ``data/prefetch.py``.

Two host-side producers with identical semantics:
  * the C++ threaded decoder (`cxx/decoder`, via `uresnet_tpu_torch.data.cxx_decoder`)
    — the production path (SURVEY.md §2.2);
  * this module's Python threaded producer — portable fallback, and the
    semantics oracle the C++ path is tested against (SURVEY.md §4).
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from uresnet_tpu_torch.config import DataConfig
from uresnet_tpu_torch.data import events as ev
from uresnet_tpu_torch.data.pipeline import densify_batch, sparse_batch


def resolve_input_files(cfg: DataConfig, ndims: int) -> list:
    """Input files, materializing the cached synthetic USEF file if needed.

    Entries containing shell wildcards (* ? [) are glob-expanded and
    sorted, so converted multi-file samples can be pointed at with
    `data.input_files=run1_*.usef`; a wildcard matching nothing is a named
    error (a silent empty expansion would train on the wrong data)."""
    if cfg.input_files:
        import glob as _glob

        out = []
        for entry in cfg.input_files:
            if any(c in entry for c in "*?[") and not os.path.exists(entry):
                # existing literal paths win over wildcard interpretation —
                # '[' is a glob character class, but 'run[2024].usef' may be
                # a real filename (round-3 review)
                matches = sorted(_glob.glob(entry))
                if not matches:
                    raise FileNotFoundError(
                        f"data.input_files pattern {entry!r} matched no "
                        f"files")
                out.extend(matches)
            else:
                out.append(entry)
        return out
    if not cfg.synthetic:
        raise ValueError("no input files and synthetic=False")
    from uresnet_tpu_torch.data.synthetic import GEN_VERSION, generate_file

    shape = (max(cfg.image_size, 256),) * ndims
    # GEN_VERSION in the key: a generator revision must never silently
    # reuse a stale cache written by an older revision
    cache = os.path.join(
        tempfile.gettempdir(),
        f"uresnet_synth_g{GEN_VERSION}_{ndims}d_{cfg.synthetic_events}"
        f"_{shape[0]}_{cfg.seed}_p{'-'.join(map(str, cfg.planes))}.usef",
    )
    if not os.path.exists(cache):
        generate_file(cache + ".tmp", cfg.synthetic_events, seed=cfg.seed,
                      shape=shape, planes=tuple(cfg.planes))
        os.replace(cache + ".tmp", cache)
    return [cache]


def make_batch_loader(cfg: DataConfig, *, num_class: int = 3,
                      train: bool = True, ndims: int = 2,
                      start_event: int = 0, shard: tuple = (0, 1)):
    """Backend-selecting factory: native C++ decoder when built and
    requested ('cxx' or 'auto'), Python fallback otherwise. Both support
    multi-host input sharding: shard=(rank, count) reads every count-th
    event and produces this host's 1/count slice of the GLOBAL batch."""
    files = resolve_input_files(cfg, ndims)
    if cfg.backend in ("cxx", "auto"):
        from uresnet_tpu_torch.data import cxx_decoder

        if cxx_decoder.available():
            return cxx_decoder.CxxBatchLoader(
                cfg, num_class=num_class, train=train, ndims=ndims,
                start_event=start_event, files=files, shard=shard)
        if cfg.backend == "cxx":
            raise OSError("backend='cxx' requested but liburesnet_decoder.so "
                          "is not built (make -C cxx/decoder)")
    import dataclasses

    return BatchLoader(dataclasses.replace(cfg, input_files=tuple(files)),
                       num_class=num_class, train=train, ndims=ndims,
                       start_event=start_event, shard=shard)


def check_batch_geometry(batch_size: int, n_planes: int,
                         shard_count: int = 1) -> int:
    """Validate the (batch_size, planes, hosts) geometry shared by BOTH
    producers (this module and cxx_decoder.CxxBatchLoader, mirroring the
    C++ slot allocation in decoder.cpp urd_open). Returns the LOCAL row
    count: (batch_size / n_planes / shard_count) * n_planes. Raises
    ValueError on any violation — also used by tests/test_configs.py to
    keep every shipped config constructible."""
    if not 1 <= n_planes <= 8:
        raise ValueError(f"planes must select 1..8 planes, got {n_planes}")
    if batch_size < 1 or batch_size % n_planes:
        raise ValueError(
            f"batch_size ({batch_size}) must be a positive multiple "
            f"of the number of selected planes ({n_planes}) — each event "
            f"contributes one row per plane")
    shard_count = max(shard_count, 1)
    global_events = batch_size // n_planes
    if global_events % shard_count:
        raise ValueError(
            f"events per batch ({global_events}) must be divisible by "
            f"the host count ({shard_count})")
    return (global_events // shard_count) * n_planes


_SM64_MASK = (1 << 64) - 1
_SM64_GOLD = 0x9E3779B97F4A7C15


def epoch_order(n: int, seed: int, epoch: int, shuffle: bool) -> np.ndarray:
    """Event order for one epoch: splitmix64 Fisher-Yates, bit-identical to
    the C++ decoder's (cxx/decoder/decoder.cpp SplitMix64 +
    reshuffle_for_epoch). A pure function of (seed, epoch), so resume — even
    switching decoder backends — replays the exact same stream."""
    order = np.arange(n, dtype=np.int64)
    if not shuffle:
        return order
    s = (seed + _SM64_GOLD * (epoch + 1)) & _SM64_MASK
    for i in range(n, 1, -1):
        s = (s + _SM64_GOLD) & _SM64_MASK
        z = s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _SM64_MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _SM64_MASK
        z = z ^ (z >> 31)
        j = z % i
        order[i - 1], order[j] = order[j], order[i - 1]
    return order


class BatchLoader:
    """Threaded host-side batch producer over USEF files.

    ``batch_size`` counts images (= events x selected planes). Iteration is
    infinite (cycling the event list); per-epoch reshuffle when
    ``random_access`` else sequential — matching larcv ThreadProcessor's
    RandomAccess knob (SURVEY.md §2.1 larcv IO configs).

    Determinism contract (SURVEY.md §5 checkpoint/resume), matching the C++
    decoder (cxx/decoder/decoder.cpp):
      * the event stream is a pure function of (seed, absolute cursor):
        epoch ``ep``'s order is an independent splitmix64 shuffle
        (`epoch_order`), identical across backends;
      * producer threads claim fill tickets and batches are DELIVERED in
        ticket order — the stream is identical for any thread count;
      * each batch's ``cursor`` is the ABSOLUTE event position after it
        (epoch = cursor // n_events), so resume past an epoch boundary
        replays the correct epoch's shuffle, not epoch 0's.
    """

    def __init__(
        self,
        cfg: DataConfig,
        *,
        num_class: int = 3,
        train: bool = True,
        ndims: int = 2,
        start_event: int = 0,
        queue_depth: Optional[int] = None,
        shard: tuple = (0, 1),
    ):
        """`shard=(rank, count)`: multi-host SPMD input sharding (SURVEY.md
        §2.3 "sharded input pipeline") — this host reads every count-th
        event and produces its 1/count slice of the GLOBAL batch
        (cfg.batch_size stays the global size)."""
        self.cfg = cfg
        self.num_class = num_class
        self.train = train
        self.ndims = ndims
        self.shard = shard
        self._files = resolve_input_files(cfg, ndims)
        # global event index: (file_idx, event_idx), sharded per host
        self._index = []
        pos = 0
        for fi, path in enumerate(self._files):
            f_ndims = ev.read_header(path)[1]
            if f_ndims != ndims:
                # C++ decoder parity (decoder.cpp urd_open "ndims
                # mismatch"): a 3D file fed to a 2D model (or a corrupt
                # dimensionality) must fail loudly here, not mis-parse
                # event payloads downstream
                raise ValueError(
                    f"{path}: USEF ndims {f_ndims} != requested {ndims} "
                    f"(wrong model.dims for this file, or corrupt header)")
            n = ev.num_events(path)
            for ei in range(n):
                if pos % shard[1] == shard[0]:
                    self._index.append((fi, ei))
                pos += 1
        if not self._index:
            raise ValueError("no events in input files (after sharding)")
        rows_per_event = max(len(cfg.planes), 1)
        local_rows = check_batch_geometry(cfg.batch_size, rows_per_event,
                                          shard[1])
        self._events_per_batch = max(1, local_rows // rows_per_event)
        self._cursor = max(0, int(start_event))  # ABSOLUTE event position
        self._orders: Dict[int, np.ndarray] = {}  # epoch -> permutation
        self._order_lock = threading.Lock()
        self._depth = queue_depth or cfg.num_batch_storage
        # ticket-ordered reorder buffer (ADR: mirrors the C++ decoder's
        # ticket-ordered rotating slots so both producers are deterministic
        # for any thread count)
        self._cond = threading.Condition()
        self._ready: Dict[int, Dict[str, np.ndarray]] = {}
        self._next_ticket = 0
        self._next_consume = 0
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._threads = []
        # Stream generation, bumped by stop(): workers capture it at claim
        # time and discard their batch (and exit) if a stop/rewind happened
        # while they were building — a worker that outlives stop()'s bounded
        # join can never insert a stale pre-rewind batch into the restarted
        # stream (deterministic stop/start contract).
        self._gen = 0
        # back-compat shim: tests/tools peek at `_q.qsize()` for the
        # decode-queue-depth metric
        self._q = _ReadyDepth(self)

    # -- producer ------------------------------------------------------------

    def _event_for_pos(self, pos: int):
        """(file_idx, event_idx) for an absolute stream position."""
        n = len(self._index)
        epoch, within = divmod(pos, n)
        with self._order_lock:
            order = self._orders.get(epoch)
            if order is None:
                order = epoch_order(n, self.cfg.seed, epoch,
                                    self.cfg.random_access and self.train)
                self._orders[epoch] = order
                # bound the cache but keep a few epochs: with deep producer
                # pipelines on tiny datasets, in-flight tickets can span
                # several epochs — evicting a still-active epoch forces an
                # O(n) Fisher-Yates regeneration under the lock per lookup
                for k in [k for k in self._orders if k < epoch - 3]:
                    del self._orders[k]  # regenerable (pure fn of seed+epoch)
        return self._index[order[within]]

    def _claim(self):
        """Atomically claim the next (ticket, start position, generation).

        Returns None while the loader is stopped: a worker that outlived
        stop()'s bounded join and resumed AFTER the rewind must not claim —
        it would take ticket 0 of the NEW generation, advance the cursor,
        then discard its batch on the `_stop` check below, leaving a
        permanent hole at ticket 0 that deadlocks next() after restart."""
        with self._cond:
            if self._stop.is_set():
                return None
            ticket = self._next_ticket
            self._next_ticket += 1
            start = self._cursor
            self._cursor += self._events_per_batch
            gen = self._gen
        return ticket, start, gen

    def _build_batch(self, start: int) -> Dict[str, np.ndarray]:
        idxs = [self._event_for_pos(p)
                for p in range(start, start + self._events_per_batch)]
        # group reads per file for IO locality, but reassemble rows in the
        # sampled order (the C++ decoder emits strict index-order rows)
        by_file: Dict[int, list] = {}
        for j, (fi, ei) in enumerate(idxs):
            by_file.setdefault(fi, []).append((j, ei))
        evs = [None] * len(idxs)
        for fi, pairs in by_file.items():
            got = ev.read_events(self._files[fi], [ei for _, ei in pairs])
            for (j, _), e in zip(pairs, got):
                evs[j] = e
        if self.cfg.transfer == "sparse":
            batch = sparse_batch(evs, planes=self.cfg.planes,
                                 max_points=self.cfg.max_points,
                                 ndims=self.ndims,
                                 with_weights=self.cfg.weight_mode == "file")
        else:
            batch = densify_batch(
                evs,
                image_size=self.cfg.image_size,
                planes=self.cfg.planes,
                normalize_scale=self.cfg.normalize_scale,
                normalize_clip=self.cfg.normalize_clip,
                weight_mode=self.cfg.weight_mode,
                num_class=self.num_class,
                nonzero_boost=self.cfg.weight_nonzero_boost,
            )
        batch["cursor"] = np.int64(start + self._events_per_batch)
        return batch

    def _make_batch(self) -> Dict[str, np.ndarray]:
        """Synchronous claim+build+consume (also used by tests/tools
        directly). Marks its ticket consumed so a later `start()` hands the
        NEXT ticket to the threaded consumer."""
        with self._cond:
            ticket = self._next_ticket
            self._next_ticket += 1
            start = self._cursor
            self._cursor += self._events_per_batch
            self._next_consume = ticket + 1
        return self._build_batch(start)

    def _worker(self):
        while not self._stop.is_set():
            claimed = self._claim()
            if claimed is None:  # stop() landed between the loop check and
                return           # the claim — exit without taking a ticket
            ticket, start, gen = claimed
            try:
                b = self._build_batch(start)
            except BaseException as e:  # surface in consumer
                with self._cond:
                    if gen == self._gen:
                        self._error = e
                        self._cond.notify_all()
                raise
            with self._cond:
                # backpressure: never run more than `depth` tickets ahead
                while (gen == self._gen and not self._stop.is_set()
                       and ticket - self._next_consume >= self._depth):
                    self._cond.wait(0.1)
                if gen != self._gen:
                    return  # stale pre-stop ticket: discard, orphan exits
                if self._stop.is_set():
                    return
                self._ready[ticket] = b
                self._cond.notify_all()

    def start(self, num_threads: Optional[int] = None) -> "BatchLoader":
        n = num_threads if num_threads is not None else self.cfg.num_threads
        self._stop.clear()          # allow stop() -> start() restart
        for _ in range(max(1, n)):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def next(self) -> Dict[str, np.ndarray]:
        if not self._threads:
            return self._make_batch()  # synchronous mode
        with self._cond:
            while (self._next_consume not in self._ready
                   and self._error is None):
                self._cond.wait(0.1)
            if self._next_consume not in self._ready:
                raise RuntimeError(
                    "loader worker died; see traceback above") from self._error
            b = self._ready.pop(self._next_consume)
            self._next_consume += 1
            self._cond.notify_all()
        return b

    def stop(self):
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []
        # Restartable contract: rewind to the position after the last
        # CONSUMED batch and drop claimed-but-undelivered tickets, so a
        # later start() resumes the exact deterministic stream (without
        # this, holes in the ticket sequence hang the consumer forever).
        # The generation bump makes the rewind safe even if a worker
        # outlived the bounded join above: its claim captured the old
        # generation, so it discards its batch instead of colliding with
        # the restarted stream's reissued ticket numbers.
        with self._cond:
            self._gen += 1
            inflight = self._next_ticket - self._next_consume
            self._cursor -= inflight * self._events_per_batch
            self._ready.clear()
            self._next_ticket = 0
            self._next_consume = 0
            self._error = None  # a pre-stop worker error dies with its gen
            self._cond.notify_all()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    def num_events(self) -> int:
        """Events visible to THIS host (after sharding) — same contract as
        CxxBatchLoader.num_events / decoder.cpp urd_num_events."""
        return len(self._index)

    def total_events(self) -> int:
        """Pre-shard dataset total over all input files. Every host computes
        the same number, which is what the exactly-once evaluator derives
        its SPMD-safe batch count from (engine/evaluator.py)."""
        return sum(ev.num_events(f) for f in self._files)

    @property
    def cursor(self) -> int:
        """Next unclaimed ABSOLUTE event position. For checkpointing, prefer
        each consumed batch's own `cursor` (positions claimed by in-flight
        producer tickets are included here)."""
        with self._cond:
            return self._cursor

    def seek(self, cursor: int):
        """Restore the data cursor (checkpoint/resume contract, SURVEY.md
        §5). `cursor` is the ABSOLUTE event position (a consumed batch's
        `cursor` value). Call before `start()`."""
        with self._cond:
            if self._threads:
                raise RuntimeError("seek() requires a stopped loader")
            self._cursor = max(0, int(cursor))
            self._next_ticket = 0
            self._next_consume = 0
            self._ready.clear()


class _ReadyDepth:
    """Minimal queue-like facade over the reorder buffer (qsize only)."""

    def __init__(self, loader: "BatchLoader"):
        self._loader = loader

    def qsize(self) -> int:
        with self._loader._cond:
            return len(self._loader._ready)

