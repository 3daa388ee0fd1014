"""Inference / analysis pass and dataset evaluation (port of
uresnet_tpu/engine/evaluator.py).

``run_inference`` streams the events of a file in order, runs the batched
forward and writes per-pixel softmax scores at the charge pixels (npz), or
the reference-style per-class score planes (USEF), with dataset metrics.
``evaluate_dataset`` is the held-out metric pass, exactly once over the
dataset or over k sampled batches, sharded over the ranks under data
parallelism. ``run_inference`` is one process: the rank that calls it
scores the whole file.

Every forward here is the BN-folded one (engine/export.py
``build_logits_fn``), folded once per pass, so every eligible conv runs the
hand-written kernel. The JAX package calls its unfolded eval forward,
which the fold equals in eval mode (tests/test_torch_model.py).

Modes of ``run_inference``, all with the same exports:
  * host (``streamed=False``): events densified on the host; the equality
    oracle;
  * streamed dense: the threaded loader (C++ decoder when built), sparse or
    dense transfer, densify on the device, dense score volumes read back;
  * streamed sparse (the default): scores gathered at the points and the
    metrics reduced to confusion counts on the device, so the readback is
    point-cloud sized;
  * tiled: every charge point of events larger than one window scored,
    through a grid of clamped tiles.

Readbacks go into pinned host buffers by non-blocking copies issued right
after each step, with one CUDA event after them; the host waits on that
event before it reads any of the step's bytes.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from uresnet_tpu_torch.data import events as ev
from uresnet_tpu_torch.data.device_pipeline import (crop_origin,
                                                    densify_on_device,
                                                    scores_at_points)
from uresnet_tpu_torch.data.loader import make_batch_loader
from uresnet_tpu_torch.data.pipeline import crop_or_pad_coords, densify_batch
from uresnet_tpu_torch.data.prefetch import device_prefetch
from uresnet_tpu_torch.engine.export import build_logits_fn
from uresnet_tpu_torch.engine.losses import softmax_xent_per_pixel
from uresnet_tpu_torch.engine.metrics import (loss_from_counts,
                                              metrics_from_counts,
                                              reduce_counts,
                                              segmentation_counts)
from uresnet_tpu_torch.engine.profiling import annotate
from uresnet_tpu_torch.parallel.mesh import all_reduce_counts


def score_plane_id(plane_id: int, cls: int, num_class: int) -> int:
    """USEF score-export plane id: the class-``cls`` score image of input
    plane ``plane_id`` is stored as plane ``plane_id * num_class + cls``
    (the reference writes one larcv Image2D per class)."""
    return plane_id * num_class + cls


def _write_export(output_file, fmt, *, dims, num_class, usef_events,
                  npz_columns):
    """Atomic export writer shared by every pass: fmt='usef' writes the
    score-plane events; fmt='npz' concatenates the per-plane column lists
    (empty-safe)."""
    if fmt == "usef":
        tmpu = output_file + ".tmp"
        ev.write_events(tmpu, usef_events, ndims=dims)
        os.replace(tmpu, output_file)
        return
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32),
             np.zeros((0, dims), np.int32), np.zeros((0, num_class), np.float32),
             np.zeros(0, np.int32), np.zeros(0, np.int32))
    names = ("event_id", "plane_id", "coords", "scores", "pred", "label")
    result = {k: np.concatenate(col) if col else e
              for k, col, e in zip(names, npz_columns, empty)}
    tmp = output_file + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **result)
    os.replace(tmp, output_file)


def _select_export_pixels(coords, values, extents, *, scale, clip):
    """The npz export's pixel selection, shared by the single-window and
    tiled passes: dedupe points that share a pixel LAST-WINS (densify
    scatters in file order, so the last assignment sticks), then keep the
    pixels whose clipped normalized value is positive, in sorted flat-index
    (np.argwhere) order. ``coords`` are non-negative positions inside a box
    of per-dimension ``extents``. Returns indices into ``coords``."""
    npt = len(coords)
    if npt == 0:
        return np.zeros(0, np.int64)
    flat = np.zeros(npt, np.int64)
    for d, ext in enumerate(extents):
        flat = flat * int(ext) + coords[:, d]
    order = np.argsort(flat, kind="stable")
    flat_s = flat[order]
    keep = np.ones(npt, bool)
    keep[:-1] = flat_s[1:] != flat_s[:-1]      # keep the LAST of each run
    sel = order[keep]
    return sel[np.clip(values[sel] * scale, 0.0, clip) > 0]


def _check_labels(labels, num_class, eidx, pid, input_file):
    lmax = int(labels.max()) if labels.size else 0
    if lmax >= num_class:
        raise ValueError(
            f"label {lmax} >= model.num_class={num_class} in event {eidx} "
            f"plane {pid} of {input_file!r} — wrong num_class or corrupt file")


def _say_decoder(loader) -> None:
    """Which host decoder data.backend chose (C++ when built, else Python)."""
    name = "cxx" if type(loader).__name__ == "CxxBatchLoader" else "python"
    print(f"[uresnet_tpu_torch] host decoder: {name}", flush=True)


def _close(loader) -> None:
    loader.stop()
    if hasattr(loader, "close"):
        loader.close()


# -- device steps ---------------------------------------------------------------


def _densify_ones(cfg, sparse):
    d = cfg.data
    return densify_on_device(
        sparse, image_size=d.image_size, num_class=cfg.model.num_class,
        normalize_scale=d.normalize_scale, normalize_clip=d.normalize_clip,
        weight_mode="ones")


@torch.inference_mode()
def _ana_step(cfg, logits_fn, batch) -> Dict[str, torch.Tensor]:
    """Dense ana step: (sparse or dense) batch -> data, label, softmax
    scores, and for a sparse batch the device crop ``origin``, which the
    USEF writeback applies (a host-recomputed centroid could disagree by
    one pixel at a rounding boundary)."""
    out = {}
    if "coords" in batch:
        dense = _densify_ones(cfg, batch)
        out["origin"] = crop_origin(batch, image_size=cfg.data.image_size)
    else:
        dense = batch
    out.update(data=dense["data"], label=dense["label"].int(),
               scores=torch.softmax(logits_fn(dense["data"]), dim=-1))
    return out


@torch.inference_mode()
def _ana_step_sparse(cfg, logits_fn, batch) -> Dict[str, torch.Tensor]:
    """Sparse ana step: densify, forward, softmax, the scores gathered at
    the points (B, P, C) and the crop ``origin`` (B, D). With a
    ``row_valid`` (B,) leaf, also the confusion counts of the valid rows
    (the sparse export); without it, points only (the tiled pass rebuilds
    its metrics from the exported points)."""
    S = cfg.data.image_size
    sparse = {k: v for k, v in batch.items() if k != "row_valid"}
    with annotate("uresnet.ana.densify"):
        dense = _densify_ones(cfg, sparse)
    with annotate("uresnet.ana.forward"):
        logits = logits_fn(dense["data"])
    with annotate("uresnet.ana.scores"):
        out = {"pscores": scores_at_points(
                   sparse, torch.softmax(logits, dim=-1), image_size=S),
               "origin": crop_origin(sparse, image_size=S)}
        if "row_valid" in batch:
            out.update(segmentation_counts(
                logits, dense["label"], dense["data"],
                num_class=cfg.model.num_class, row_valid=batch["row_valid"]))
    return out


@torch.inference_mode()
def _count_step(trainer, logits_fn, batch) -> Dict[str, torch.Tensor]:
    """Exact-evaluation step: forward + sum-form counts with the padded
    tail rows masked by the ``row_valid`` leaf, and the masked loss sums."""
    row_valid = batch["row_valid"].float()
    prep = trainer._prepare({k: v for k, v in batch.items()
                             if k != "row_valid"})
    logits = logits_fn(prep["data"])
    counts = segmentation_counts(logits, prep["label"], prep["data"],
                                 num_class=trainer.cfg.model.num_class,
                                 row_valid=row_valid)
    xent = softmax_xent_per_pixel(logits, prep["label"])
    w = prep["weight"].float() * row_valid.reshape(
        (-1,) + (1,) * (xent.dim() - 1))
    counts["loss_num"] = torch.sum(w * xent)
    counts["weight_sum"] = torch.sum(w)
    return counts


# -- readback -------------------------------------------------------------------


def _readback(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Start the device->host copies of one step's outputs: pinned host
    tensors filled by non-blocking copies queued on the current stream
    behind the step. Their bytes land only when the stream reaches the
    copies: wait on an event recorded after them (`_mark`) before reading.
    CPU tensors pass through."""
    host = {}
    for k, v in out.items():
        if v.is_cuda:
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            v = h
        host[k] = v
    return host


def _mark(device: torch.device):
    """A CUDA event after everything queued so far (None on the CPU)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _landed(host: Dict[str, torch.Tensor], event) -> Dict[str, np.ndarray]:
    """The host copies as numpy, once ``event`` says they have landed."""
    if event is not None:
        event.synchronize()
    return {k: v.numpy() for k, v in host.items()}


# -- producers ------------------------------------------------------------------


def _produce_host(trainer, logits_fn, input_file, n, bs_events):
    """Synchronous producer: host densify, then the forward."""
    cfg = trainer.cfg
    for start in range(0, n, bs_events):
        idxs = list(range(start, min(start + bs_events, n)))
        events = ev.read_events(input_file, idxs)
        # pad the trailing batch to the full batch shape
        pad = bs_events - len(events)
        batch = densify_batch(
            events + [events[-1]] * pad, image_size=cfg.data.image_size,
            planes=tuple(cfg.data.planes),
            normalize_scale=cfg.data.normalize_scale,
            normalize_clip=cfg.data.normalize_clip, weight_mode="ones",
            num_class=cfg.model.num_class)
        with torch.inference_mode():
            # standard strides, as the densified batch of the streamed
            # paths: the host batch's channel axis has stride 0 (numpy's
            # [..., None]), which sends the CPU stem conv down another
            # algorithm, with other rounding
            x = torch.empty(batch["data"].shape, device=trainer.device)
            x.copy_(torch.from_numpy(batch["data"]))
            scores = torch.softmax(logits_fn(x), dim=-1).cpu().numpy()
        yield idxs, events, {"data": batch["data"], "label": batch["label"],
                             "scores": scores}


def _produce_streamed(trainer, logits_fn, input_file, n, bs_events,
                      max_points, *, sparse_export=False):
    """Streamed producer: threaded loader -> device_prefetch -> the ana step
    (dense, or with ``sparse_export`` the per-point step with the wrapped
    tail rows of the last batch masked out of the counts by ``row_valid``)
    -> readbacks. Yields (idxs, events, numpy outputs) in order.

    Each step's readback is queued right behind it with its own CUDA
    event; ``prefetch_depth + 1`` steps stay in flight before the host
    waits on the oldest one's event."""
    cfg = trainer.cfg
    n_planes = len(cfg.data.planes)
    dcfg = dataclasses.replace(
        cfg.data, input_files=(input_file,), synthetic=False,
        random_access=False, weight_mode="ones", max_points=max_points,
        batch_size=bs_events * n_planes,
        **({"transfer": "sparse"} if sparse_export else {}))
    loader = make_batch_loader(dcfg, num_class=cfg.model.num_class,
                               train=False, ndims=cfg.model.dims)
    _say_decoder(loader)
    loader.start()
    step = _ana_step_sparse if sparse_export else _ana_step
    depth = max(1, cfg.data.prefetch_depth) + 1
    try:
        it = device_prefetch(iter(loader), device=trainer.device,
                             depth=cfg.data.prefetch_depth)
        pending = collections.deque()  # (idxs, events, host outputs, event)

        def landed():
            idxs, events, host, event = pending.popleft()
            return idxs, events, _landed(host, event)

        for k in range(-(-n // bs_events)):
            batch = next(it)
            batch.pop("cursor", None)
            idxs = list(range(k * bs_events, min((k + 1) * bs_events, n)))
            if sparse_export:
                batch["row_valid"] = torch.as_tensor(
                    np.arange(bs_events * n_planes) // n_planes < len(idxs),
                    dtype=torch.float32, device=trainer.device)
            host = _readback(step(cfg, logits_fn, batch))
            pending.append((idxs, ev.read_events(input_file, idxs), host,
                            _mark(trainer.device)))
            if len(pending) >= depth:
                yield landed()
        while pending:
            yield landed()
    finally:
        _close(loader)


# -- passes -----------------------------------------------------------------------


def _run_inference_sparse(trainer, logits_fn, input_file, output_file, *,
                          fmt, bs_events, max_points) -> Dict[str, float]:
    """Sparse-export pass: the device returns per-point scores, confusion
    counts and its crop origins; the host rebuilds the window from the
    exported origin with integer math and writes the same export as the
    dense pass."""
    cfg = trainer.cfg
    n = ev.num_events(input_file)
    planes = tuple(cfg.data.planes)
    num_class = cfg.model.num_class
    S = cfg.data.image_size
    P = max_points
    scale, clip = cfg.data.normalize_scale, cfg.data.normalize_clip

    cols = tuple([] for _ in range(6))  # event, plane, coords, scores, pred, label
    usef_events = []
    n_exported = 0
    agg_counts: Dict[str, np.ndarray] = {}

    for idxs, events, out in _produce_streamed(
            trainer, logits_fn, input_file, n, bs_events, P,
            sparse_export=True):
        pscores = out.pop("pscores")
        origin_b = out.pop("origin")        # (B, D) device crop origins
        for key, v in reduce_counts(out).items():
            agg_counts[key] = agg_counts.get(key, 0.0) + v
        for bi, (eidx, evt) in enumerate(zip(idxs, events)):
            by_id = {p.plane_id: p for p in evt.planes}
            score_planes = []
            for pi, pid in enumerate(planes):
                row = bi * len(planes) + pi
                pl = by_id[pid]
                # P >= the busiest selected plane, so this is every point;
                # the min() guards a hand-passed P
                npt = min(len(pl.values), P)
                c, v, l = pl.coords[:npt], pl.values[:npt], pl.labels[:npt]
                _check_labels(l, num_class, eidx, pid, input_file)
                # the device's own window, from its origin
                shifted = c.astype(np.int64) - origin_b[row].astype(np.int64)
                inwin = np.all((shifted >= 0) & (shifted < S), axis=1)
                sc_all = np.asarray(pscores[row, :npt], np.float32)
                pred_pts = sc_all.argmax(-1)
                win_all = shifted[inwin]
                sc_in, pr_in = sc_all[inwin], pred_pts[inwin]
                sel = _select_export_pixels(win_all, v[inwin],
                                            (S,) * c.shape[1], scale=scale,
                                            clip=clip)
                for col, val in zip(cols, (
                        np.full(len(sel), eidx, np.int32),
                        np.full(len(sel), pid, np.int32),
                        win_all[sel].astype(np.int32), sc_in[sel],
                        pr_in[sel].astype(np.int32),
                        l[inwin][sel].astype(np.int32))):
                    col.append(val)
                n_exported += int(len(sel))
                if fmt == "usef":
                    # the writeback keeps FILE order over in-window points
                    score_planes += _score_planes(
                        pid, pl.shape, c[inwin], sc_in, pr_in, num_class)
            if fmt == "usef":
                usef_events.append(ev.SparseEvent(planes=score_planes))

    metrics = metrics_from_counts(agg_counts)
    metrics.update(n_events=n, n_pixels=n_exported)
    _write_export(output_file, fmt, dims=cfg.model.dims, num_class=num_class,
                  usef_events=usef_events, npz_columns=cols)
    return metrics


def _score_planes(pid, shape, coords, scores, pred, num_class):
    """One input plane's USEF score planes: one per class, at the given
    detector coords, labels the predicted class."""
    return [ev.SparsePlane(plane_id=score_plane_id(pid, cls, num_class),
                           shape=tuple(shape),
                           coords=np.asarray(coords).astype(np.int32),
                           values=np.asarray(scores[:, cls], np.float32),
                           labels=np.asarray(pred).astype(np.uint8))
            for cls in range(num_class)]


def _tile_rows_for_plane(pl, S: int):
    """Tile cover of a plane for full-coverage inference: grid tiles of
    side ``S`` aligned to multiples of S (the last tile per dim clamped to
    the detector edge), keeping only tiles that OWN at least one point.
    Every point is owned by exactly one tile (per-dim index
    ``min(c // S, k-1)``); a tile's row also carries the CONTEXT points of
    neighbouring tiles inside its (possibly clamped) window, so the network
    sees the local evidence a centered crop would.

    Returns a list of dicts with 'origin' (D,) int64, 'ctx_idx' (m,) point
    indices inside the window (file order), and 'owned' (m,) bool marking
    the points this tile exports."""
    c = pl.coords.astype(np.int64)
    n = len(pl.values)
    if n == 0:
        return []
    D = c.shape[1]
    ks = [max(1, -(-int(s) // S)) for s in pl.shape]
    origins = [[min(i * S, max(int(s) - S, 0)) for i in range(k)]
               for s, k in zip(pl.shape, ks)]
    tile = np.minimum(c // S, np.array([k - 1 for k in ks])[None, :])
    owner = np.zeros(n, np.int64)
    for d in range(D):
        owner = owner * ks[d] + tile[:, d]
    rows = []
    for tid in np.unique(owner):                    # sorted -> deterministic
        rem, tdims = int(tid), []
        for d in reversed(range(D)):
            tdims.append(rem % ks[d])
            rem //= ks[d]
        o = np.array([origins[d][td] for d, td in
                      zip(range(D), reversed(tdims))], np.int64)
        ctx_idx = np.nonzero(np.all((c >= o) & (c < o + S), axis=1))[0]
        rows.append({"origin": o, "ctx_idx": ctx_idx,
                     "owned": owner[ctx_idx] == tid})
    return rows


def _run_inference_tiled(trainer, logits_fn, input_file, output_file, *,
                         fmt, bs_events) -> Dict[str, float]:
    """Full-coverage tiled pass: EVERY charge point receives a score,
    however far the event extends beyond one ``image_size`` window.

    Each occupied grid tile becomes one sparse batch row with coords
    shifted by the tile origin and the declared shape set to image_size,
    so the device crop clamps to origin 0; the points step scores the tile
    and the host maps points back with integer math. Context points of
    neighbouring tiles ride along in the window, but only the owning tile
    exports a point.

    Metrics are over the EXPORTED charge pixels (each once), so acc_all ==
    acc_nonzero and the IoUs are charge-pixel IoUs here."""
    cfg = trainer.cfg
    S = cfg.data.image_size
    D = cfg.model.dims
    planes_sel = tuple(cfg.data.planes)
    num_class = cfg.model.num_class
    n = ev.num_events(input_file)
    n_rows = bs_events * len(planes_sel)
    scale, clip = cfg.data.normalize_scale, cfg.data.normalize_clip
    # pre-pass: the pad covers the busiest TILE window (with its context),
    # not the busiest plane; only the max is kept, the tiles are rebuilt
    # per chunk below
    needed = 0
    for start in range(0, n, bs_events):
        for evt in ev.read_events(
                input_file, list(range(start, min(start + bs_events, n)))):
            by_id = {p.plane_id: p for p in evt.planes}
            for pid in planes_sel:
                for r in _tile_rows_for_plane(by_id[pid], S):
                    needed = max(needed, len(r["ctx_idx"]))
    P = max(256, ((needed + 255) // 256) * 256)

    cols = tuple([] for _ in range(6))
    usef_events = []
    n_exported = 0
    n_tiles = 0
    conf = np.zeros((num_class, num_class), np.float64)

    for start in range(0, n, bs_events):
        idxs = list(range(start, min(start + bs_events, n)))
        events = ev.read_events(input_file, idxs)
        rows = []                       # (eidx, pid, plane, tile-row dict)
        for eidx, evt in zip(idxs, events):
            by_id = {p.plane_id: p for p in evt.planes}
            for pid in planes_sel:
                pl = by_id[pid]
                _check_labels(np.asarray(pl.labels), num_class, eidx, pid,
                              input_file)
                for r in _tile_rows_for_plane(pl, S):
                    if len(r["ctx_idx"]) > P:
                        raise RuntimeError(
                            f"tile holds {len(r['ctx_idx'])} points > pad "
                            f"length {P} (the pre-pass sizes P over every "
                            f"tile, so the file changed mid-run)")
                    rows.append((eidx, pid, pl, r))
        n_tiles += len(rows)
        # a BOUNDED in-flight queue (prefetch_depth deep): the tile count is
        # data-dependent, and an unbounded one could hold O(file) device
        # buffers for a pathological event
        pending: collections.deque = collections.deque()
        # per-(event, plane) score buffers filled from the owning tiles
        buf: Dict[tuple, np.ndarray] = {}

        def drain_one():
            rb, host, event = pending.popleft()
            got = _landed(host, event)
            if np.any(got["origin"][:len(rb)]):
                # not an assert: python -O must not strip it into silently
                # mis-paired scores. Tile rows declare shape == image_size,
                # so the device crop must clamp to 0.
                raise RuntimeError(
                    "tiled invariant violated: device crop origin != 0 for "
                    "a tile row (shape == image_size should clamp it)")
            ps = np.asarray(got["pscores"], np.float32)
            for ri, (eidx, pid, pl, r) in enumerate(rb):
                key = (eidx, pid)
                if key not in buf:
                    buf[key] = np.full((len(pl.values), num_class), np.nan,
                                       np.float32)
                ci = r["ctx_idx"]
                buf[key][ci[r["owned"]]] = ps[ri, :len(ci)][r["owned"]]

        for b0 in range(0, len(rows), n_rows):
            rb = rows[b0:b0 + n_rows]
            coords = np.zeros((n_rows, P, D), np.int16)
            values = np.zeros((n_rows, P), np.float32)
            labels = np.zeros((n_rows, P), np.uint8)
            npoints = np.zeros((n_rows,), np.int32)
            for ri, (_, _, pl, r) in enumerate(rb):
                ci = r["ctx_idx"]
                coords[ri, :len(ci)] = (pl.coords[ci].astype(np.int64)
                                        - r["origin"][None, :])
                values[ri, :len(ci)] = pl.values[ci]
                labels[ri, :len(ci)] = pl.labels[ci]
                npoints[ri] = len(ci)
            batch = trainer.device_batch({
                "coords": coords, "values": values, "labels": labels,
                "npoints": npoints, "shape": np.full((n_rows, D), S, np.int32)})
            host = _readback(_ana_step_sparse(cfg, logits_fn, batch))
            pending.append((rb, host, _mark(trainer.device)))
            if len(pending) > max(1, cfg.data.prefetch_depth):
                drain_one()
        while pending:
            drain_one()
        # finalize the chunk's events in order
        for eidx, evt in zip(idxs, events):
            by_id = {p.plane_id: p for p in evt.planes}
            score_planes = []
            for pid in planes_sel:
                pl = by_id[pid]
                npt = len(pl.values)
                sc = buf.get((eidx, pid), np.zeros((0, num_class), np.float32))
                if np.isnan(sc).any():
                    # not an assert: under python -O a coverage hole would
                    # argmax NaN rows to confident class-0 exports
                    raise RuntimeError(
                        "tiled coverage hole: a point was owned by no tile "
                        f"(event {eidx} plane {pid})")
                pred_pts = sc.argmax(-1) if npt else np.zeros(0, np.int64)
                # the detector plane is the window: coords stay in ORIGINAL
                # detector space
                sel = _select_export_pixels(
                    pl.coords.astype(np.int64), pl.values, pl.shape,
                    scale=scale, clip=clip)
                for col, val in zip(cols, (
                        np.full(len(sel), eidx, np.int32),
                        np.full(len(sel), pid, np.int32),
                        pl.coords[sel].astype(np.int32), sc[sel],
                        pred_pts[sel].astype(np.int32),
                        pl.labels[sel].astype(np.int32))):
                    col.append(val)
                n_exported += int(len(sel))
                if len(sel):
                    conf += np.bincount(
                        pred_pts[sel].astype(np.int64) * num_class
                        + pl.labels[sel].astype(np.int64),
                        minlength=num_class * num_class,
                    ).reshape(num_class, num_class)
                if fmt == "usef":
                    # ALL points in FILE order: full coverage is the point
                    score_planes += _score_planes(pid, pl.shape, pl.coords,
                                                  sc, pred_pts, num_class)
            if fmt == "usef":
                usef_events.append(ev.SparseEvent(planes=score_planes))

    metrics = metrics_from_counts({
        "conf": conf, "n_pixels": float(n_exported),
        "correct_nonzero": float(np.trace(conf)),
        "n_nonzero": float(n_exported)})
    metrics.update(n_events=n, n_pixels=n_exported, n_tiles=n_tiles)
    _write_export(output_file, fmt, dims=D, num_class=num_class,
                  usef_events=usef_events, npz_columns=cols)
    return metrics


def run_inference(
    trainer,
    ts,
    input_file: str,
    output_file: str,
    *,
    batch_events: Optional[int] = None,
    fmt: str = "npz",
    streamed: bool = True,
    export: str = "auto",
    tiled: bool = False,
    readback_group: int = 1,
) -> Dict[str, float]:
    """Sequential pass over ``input_file`` with the model of ``ts`` on
    ``trainer.device``; writes the score export and returns the dataset
    metrics with ``n_events`` and ``n_pixels``.

    fmt="npz" (arrays concatenated over all events):
      event_id (N,), plane_id (N,), coords (N, ndims),
      scores (N, num_class), pred (N,), label (N,)

    fmt="usef" (reference-style score-map writeback): a USEF file readable
    by data/events.py, one event per input event; each input plane ``p``
    gives ``num_class`` score planes with plane_id ``p * num_class + cls``
    (`score_plane_id`), coords in ORIGINAL detector space, values the
    softmax scores, labels the predicted class.

    ``streamed=True`` (default) runs the loader, device densify and
    grouped readbacks; ``streamed=False`` is the synchronous host-densify
    path, kept as the equality oracle. ``export``: 'dense' reads back the
    score volumes; 'sparse' gathers the scores at the points and reduces
    the metrics to confusion counts on the device; 'auto' (default) is
    'sparse' when streamed. The streamed wire's pad length covers the
    file's busiest selected plane (rounded up to 256), so inference never
    truncates an event, whatever the training-time data.max_points. The
    exports are the same in every mode.

    ``readback_group`` is accepted for parity with the JAX package, where
    one host transfer carries K steps' outputs over a high-latency link.
    Here each step's readback has its own CUDA event whatever K is (K = 1
    and 4 measured the same on an H100, PERF.md), so K changes nothing.

    ``tiled=True``: the full-coverage pass (`_run_inference_tiled`); npz
    coords are then ORIGINAL detector coords and the metrics are over the
    exported charge pixels.

    The rank that calls it scores the whole file. Under a model axis the
    state is gathered first, so every rank of that axis calls it.
    """
    if fmt not in ("npz", "usef"):
        raise ValueError(f"unknown score export format {fmt!r}")
    if export not in ("auto", "dense", "sparse"):
        raise ValueError(f"unknown export mode {export!r}")
    cfg = trainer.cfg
    n = ev.num_events(input_file)
    planes = tuple(cfg.data.planes)
    num_class = cfg.model.num_class
    bs_events = batch_events or max(1, cfg.data.batch_size // len(planes))
    if export == "auto":
        export = "sparse" if streamed else "dense"
    if export == "sparse" and not streamed:
        raise ValueError("export='sparse' requires streamed=True")
    if n == 0:
        # a valid 0-event file: the empty export and zeroed metrics (no
        # loader can be built over it)
        metrics = metrics_from_counts({
            "conf": np.zeros((num_class, num_class), np.float64),
            "n_pixels": 0.0, "correct_nonzero": 0.0, "n_nonzero": 0.0})
        metrics.update(n_events=0, n_pixels=0)
        _write_export(output_file, fmt, dims=cfg.model.dims,
                      num_class=num_class, usef_events=[],
                      npz_columns=([],) * 6)
        return metrics
    logits_fn = build_logits_fn(cfg, trainer.gather_state(ts).model)
    if tiled:
        return _run_inference_tiled(trainer, logits_fn, input_file,
                                    output_file, fmt=fmt, bs_events=bs_events)
    if streamed:
        needed = ev.max_plane_points(input_file, planes)
        ana_points = max(cfg.data.max_points, ((needed + 255) // 256) * 256)
    if export == "sparse":
        return _run_inference_sparse(trainer, logits_fn, input_file,
                                     output_file, fmt=fmt, bs_events=bs_events,
                                     max_points=ana_points)

    cols = tuple([] for _ in range(6))
    usef_events = []
    n_correct_nonzero = 0
    n_nonzero = 0
    # dataset-global (pred, true) confusion over ALL pixels of the real
    # rows: the exact single-pass mIoU, as evaluate_dataset's exact mode
    conf = np.zeros((num_class, num_class), np.float64)
    n_pix_total = 0

    producer = (_produce_streamed(trainer, logits_fn, input_file, n,
                                  bs_events, ana_points)
                if streamed else
                _produce_host(trainer, logits_fn, input_file, n, bs_events))
    for idxs, events, out in producer:
        scores, data_b, label_b = out["scores"], out["data"], out["label"]
        # present when the device densified: the usef writeback applies
        # the device's own crop window
        origin_b = out.get("origin")
        pred = scores.argmax(-1)
        for bi, (eidx, evt) in enumerate(zip(idxs, events)):
            by_id = {p.plane_id: p for p in evt.planes}
            score_planes = []
            for pi, pid in enumerate(planes):
                row = bi * len(planes) + pi
                label_img = label_b[row]
                mask = data_b[row, ..., 0] > 0
                coords = np.argwhere(mask)
                p_mask, l_mask = pred[row][mask], label_img[mask]
                for col, val in zip(cols, (
                        np.full(len(coords), eidx, np.int32),
                        np.full(len(coords), pid, np.int32),
                        coords.astype(np.int32), scores[row][mask],
                        p_mask.astype(np.int32), l_mask.astype(np.int32))):
                    col.append(val)
                n_correct_nonzero += int((p_mask == l_mask).sum())
                n_nonzero += int(mask.sum())
                _check_labels(label_img, num_class, eidx, pid, input_file)
                conf += np.bincount(
                    (pred[row].astype(np.int64) * num_class
                     + label_img.astype(np.int64)).ravel(),
                    minlength=num_class * num_class,
                ).reshape(num_class, num_class)
                n_pix_total += label_img.size
                if fmt == "usef":
                    # back to ORIGINAL detector coords through the window
                    # the model saw: the device's origin when it densified,
                    # else the host window
                    pl = by_id[pid]
                    if origin_b is not None:
                        shifted = (pl.coords.astype(np.int64)
                                   - origin_b[row].astype(np.int64))
                        inwin = np.all((shifted >= 0)
                                       & (shifted < cfg.data.image_size),
                                       axis=1)
                    else:
                        shifted, inwin = crop_or_pad_coords(
                            pl.coords, pl.shape, cfg.data.image_size,
                            values=pl.values)
                    win = tuple(shifted[inwin].T)
                    score_planes += _score_planes(
                        pid, pl.shape, pl.coords[inwin], scores[row][win],
                        pred[row][win], num_class)
            if fmt == "usef":
                usef_events.append(ev.SparseEvent(planes=score_planes))

    metrics = metrics_from_counts({
        "conf": conf, "n_pixels": float(n_pix_total),
        "correct_nonzero": float(n_correct_nonzero),
        "n_nonzero": float(n_nonzero)})
    metrics.update(n_events=n, n_pixels=n_nonzero)
    _write_export(output_file, fmt, dims=cfg.model.dims, num_class=num_class,
                  usef_events=usef_events, npz_columns=cols)
    return metrics


def evaluate_dataset(trainer, ts, *,
                     num_batches: Optional[int] = None) -> Dict[str, float]:
    """Held-out metric evaluation of the trainer's dataset (the mIoU parity
    gate).

    ``num_batches=None`` (default, the gate mode): EXACTLY ONCE over the
    dataset. The batch count comes from the dataset's event count, the
    loader streams in order (train=False: no shuffle), and the wrapped
    tail rows of the last batch are masked out, so every held-out event
    counts once. Metrics come from dataset-global confusion sums
    (`metrics_from_counts`), with ``n_pixels``, ``n_nonzero``, ``loss``
    (masked, under ``train.loss_normalize``) and ``n_events``.

    ``num_batches=k``: k batches off the cycling loader, per-batch metric
    means of the global batch, for quick spot checks.

    Under a mesh the state is gathered (a collective under a model axis)
    and the evaluation is data-parallel over the whole world: each rank
    reads its shard (every world-th event) at the training's rows per data
    index a batch, and runs the same, host-independent number of batches;
    a shorter shard masks more rows. The counts are summed over the ranks,
    so every rank returns the same dict, with ``n_events`` the files'
    event count. The sampled mode reads each data index's batches."""
    logits_fn = build_logits_fn(trainer.cfg, trainer.gather_state(ts).model)
    loader = trainer.make_loader(train=False, world=num_batches is None)
    _say_decoder(loader)
    if num_batches is not None:
        agg: Dict[str, float] = {}
        try:
            for _ in range(num_batches):
                batch = loader.next()
                batch.pop("cursor", None)
                m = trainer.eval_step(ts, trainer.device_batch(batch),
                                      logits_fn)
                for k, v in m.items():
                    agg[k] = agg.get(k, 0.0) + float(v) / num_batches
        finally:
            _close(loader)
        return agg

    cfgd = trainer.cfg.data
    n_planes = len(cfgd.planes)
    mesh = trainer.mesh
    shard_count, rank = mesh.world, mesh.rank
    epb_local = max(1, cfgd.batch_size // n_planes // mesh.data)
    # host-independent totals (the loader shards round-robin): every rank
    # runs the same number of steps, the shorter shards mask more rows
    n_total = loader.total_events()
    n_local = n_total // shard_count + (1 if rank < n_total % shard_count
                                        else 0)
    n_max_local = -(-n_total // shard_count)
    n_batches = max(1, -(-n_max_local // epb_local))
    loader.start()
    agg_counts: Dict[str, np.ndarray] = {}
    try:
        for k in range(n_batches):
            batch = loader.next()
            batch.pop("cursor", None)
            valid_events = min(max(n_local - k * epb_local, 0), epb_local)
            batch["row_valid"] = (np.arange(epb_local * n_planes) // n_planes
                                  < valid_events).astype(np.float32)
            counts = _count_step(trainer, logits_fn,
                                 trainer.device_batch(batch))
            for key, v in reduce_counts(
                    {k2: v2.cpu() for k2, v2 in counts.items()}).items():
                agg_counts[key] = agg_counts.get(key, 0.0) + v
    finally:
        _close(loader)

    if mesh.group is not None:
        agg_counts = all_reduce_counts(agg_counts, mesh.group, trainer.device)
    out = metrics_from_counts(agg_counts)
    # model-free exactness witnesses: a double-counted or unmasked row
    # shows here even when near-tie argmax flips hide it in the metrics
    out["n_pixels"] = float(agg_counts["n_pixels"])
    out["n_nonzero"] = float(agg_counts["n_nonzero"])
    out["loss"] = loss_from_counts(agg_counts, trainer.cfg.train.loss_normalize)
    out["n_events"] = float(n_total)
    return out
