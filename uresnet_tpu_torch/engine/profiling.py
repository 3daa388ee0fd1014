"""Tracing and profiling hooks (port of uresnet_tpu/engine/profiling.py).

  * `trace(logdir)`   — ``torch.profiler`` capture of the enclosed region
                        (host and, on a card, CUDA activity), written as a
                        Chrome trace into ``logdir`` (Perfetto or
                        chrome://tracing read it);
  * `annotate(name)`  — a named region (``record_function``) that shows up
                        in the trace;
  * `device_sync(x)`  — wait for the card that holds ``x``;
  * `StepTimer`       — host wall time per window of steps, synchronizing
                        only at window edges.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, device="cuda") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``logdir/trace_<time>_<pid>.json``: host activity, and the card's
    kernels and copies when ``device`` is a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))


def annotate(name: str):
    """Named region annotation that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


def _first_tensor(x) -> Optional[torch.Tensor]:
    if torch.is_tensor(x):
        return x
    items = x.values() if isinstance(x, dict) else (
        x if isinstance(x, (list, tuple)) else ())
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def device_sync(x) -> None:
    """Wait until the card holding ``x`` (a tensor, or the first tensor of
    a dict/list/tuple tree) has finished its queued work; nothing to wait
    for on the CPU."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class StepTimer:
    """Wall-time tracker for the train loop: records per-window images/sec
    and the mean step time. Synchronizes only at window edges so the
    device pipeline stays full."""

    def __init__(self, window: int = 20):
        self.window = window
        self._count = 0
        self._t_last: Optional[float] = None
        self.images_per_sec = float("nan")
        self.step_ms = float("nan")

    def tick(self, batch_size: int, sync_obj=None) -> Optional[Dict[str, float]]:
        self._count += 1
        if self._count % self.window:
            return None
        if sync_obj is not None:
            device_sync(sync_obj)
        now = time.perf_counter()
        out = None
        if self._t_last is not None:
            dt = now - self._t_last
            self.images_per_sec = batch_size * self.window / dt
            self.step_ms = dt / self.window * 1e3
            out = {"images_per_sec": self.images_per_sec,
                   "step_ms": self.step_ms}
        self._t_last = now
        return out
