"""Host -> device batch staging (port of uresnet_tpu/data/loader.py
``device_prefetch``).

On a CUDA device each batch's arrays are copied into pinned host memory
and sent with ``non_blocking`` copies on a side stream, ``depth`` batches
ahead of the one being consumed, so the copies overlap the running step.
Each staged batch records an event on the side stream; before the batch
is handed out the current stream waits on that event, and its tensors are
marked as used there so their memory is not reused early. (torch's pinned
allocator keeps a pinned block until the copy that reads it is done.) On
the CPU the arrays are wrapped as tensors without a copy.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import numpy as np
import torch

from uresnet_tpu_torch.engine.profiling import annotate


def _stage(batch: Dict, device: torch.device, stream):
    """Array leaves -> tensors on ``device`` (scalars pass through), and
    the side stream's event after the copies (None on the CPU)."""
    out = {}
    ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
    with annotate("uresnet.stage"), ctx:
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.ndim > 0:
                t = torch.from_numpy(np.ascontiguousarray(v))
                if stream is not None:
                    t = t.pin_memory().to(device, non_blocking=True)
                v = t
            out[k] = v
    if stream is None:
        return out, None
    event = torch.cuda.Event()
    event.record(stream)
    return out, event


def _hand_out(batch: Dict, event, device: torch.device) -> Dict:
    if event is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for v in batch.values():
            if torch.is_tensor(v):
                v.record_stream(current)
    return batch


def device_prefetch(it: Iterator[Dict], *, device, depth: int = 2
                    ) -> Iterator[Dict]:
    """Yield the batches of ``it`` staged on ``device``, ``depth`` ahead."""
    device = torch.device(device)
    stream = (torch.cuda.Stream(device=device) if device.type == "cuda"
              else None)
    buf = []
    for b in it:
        buf.append(_stage(b, device, stream))
        if len(buf) > depth:
            yield _hand_out(*buf.pop(0), device)
    while buf:
        yield _hand_out(*buf.pop(0), device)
