"""Tracing hooks of the port.

  * `trace(logdir)`   — ``torch.profiler`` capture of the enclosed region
                        (host and, on a card, CUDA activity), written as a
                        Chrome trace into ``logdir`` (Perfetto or
                        chrome://tracing read it); ``cli.train --profile``;
  * `annotate(name)`  — the program's one span helper: a named region
                        (``record_function``) while a profiler records,
                        and a shared null context, which costs about a
                        microsecond, while none does.

The program's spans are siblings at the phases of its two hot steps, each
named ``uresnet.<...>``: ``uresnet.stage`` (data/prefetch.py), the train
step's ``uresnet.train.{densify,forward,loss,backward,allreduce,optim,
metrics}`` (engine/trainer.py) and the analysis step's
``uresnet.ana.{densify,forward,scores}`` (engine/evaluator.py). None nests
in another; none sits in per-op model code.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

# entered by every span while no profiler records: record_function costs
# ~13 us a call even then, the check and this context ~1 us
_OFF = contextlib.nullcontext()


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
    """The span ``name`` (``uresnet.<...>``) around the enclosed region,
    recorded only while a profiler is active."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
