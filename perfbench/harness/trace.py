"""What a traced window's ``torch.profiler`` events say, kept in memory.

The busy time is the union of the device's intervals (kernels, copies,
memsets) inside the window, the arithmetic of
``uresnet_tpu_torch/tools/step_profile.py``, rewritten here (the
idle_share.* readers set it against the same steps run untraced). The window is the harness's own ``bench.window`` span. Host spans
of the harness (``bench.stage``, ``bench.step``, ``bench.readback``) name
what the host was doing in each idle gap.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple

import numpy as np

WINDOW = "bench.window"
TOP = 10          # entries of each breakdown list
GAPS_NAMED = 400  # longest idle gaps that are attributed to a host activity


@dataclasses.dataclass
class Op:
    """A host event: name, profiler id, interval (us), operand shapes, and
    whether an event of the same name encloses it."""
    name: str
    id: int
    start: float
    end: float
    shapes: list
    nested: bool


@dataclasses.dataclass
class Trace:
    device: List[Tuple[str, float, float, int]]  # name, start, end, link
    host: List[Op]
    window: Tuple[float, float]                  # the window span (us)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        merged: List[List[float]] = []
        for _, a, b, _ in sorted(self.device, key=lambda d: d[1]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def ops(self, name: str) -> List[Op]:
        return [o for o in self.host if o.name == name]

    def kernels_of(self, ids) -> List[Tuple[str, float, float, int]]:
        """Device events that the profiler correlates with host events of
        the given profiler ids."""
        ids = set(ids)
        return [d for d in self.device if d[3] in ids]

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing."""
        per_op: Dict[str, float] = collections.defaultdict(float)
        for name, a, b, _ in self.device:
            per_op[name[:160]] += (b - a) / 1e6
        ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for ab in busy for x in ab] + [self.window[1]]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:GAPS_NAMED]
        per_gap: Dict[str, float] = collections.defaultdict(float)
        if gaps:
            starts = np.array([o.start for o in self.host])
            ends = np.array([o.end for o in self.host])
            for length, a, b in gaps:
                per_gap[self._doing((a + b) / 2, starts, ends)] += length / 1e6
        idle = sorted(per_gap.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}

    def _doing(self, t: float, starts, ends) -> str:
        """The harness span and the innermost host event around ``t``."""
        hit = np.nonzero((starts <= t) & (ends >= t))[0]
        inner = [self.host[i] for i in hit if self.host[i].name != WINDOW]
        if not inner:
            return "host between harness spans"
        spans = [o for o in inner if o.name.startswith("bench.")]
        deepest = max(inner, key=lambda o: o.start)
        span = min(spans, key=lambda o: o.start).name if spans else "host"
        return span if deepest.name == span else f"{span} > {deepest.name}"


def read(prof) -> Trace:
    """The device events and host events of a finished profile."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith("bench."):
                continue  # a host span drawn on the device's timeline
            device.append((e.name, a, b,
                           int(getattr(e, "linked_correlation_id", 0) or 0)))
        elif e.device_type == DeviceType.CPU:
            if e.name == WINDOW:
                window = (a, b)
            nested, p = False, getattr(e, "cpu_parent", None)
            while p is not None and not nested:
                nested, p = p.name == e.name, p.cpu_parent
            host.append(Op(e.name, int(e.id), a, b,
                           list(e.input_shapes or []), nested))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    return Trace(device, host, window)
