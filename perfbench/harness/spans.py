"""The device time of each phase of the program's steps, read from the
program's own ``uresnet.*`` host spans in a traced window
(harness/trace.py).

Each device interval goes to the innermost ``uresnet.*`` span that
contains, in time, the host call that launched it. The profiler's own
link from a device event to its launch is not in the trace: torch
2.11's ``FunctionEvent`` has no ``linked_correlation_id``, so every link
harness/trace.py reads is 0. A stream runs its work in the order it was
launched, so the launch calls are paired with the intervals in order,
kind by kind: kernels with ``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
``cuLaunchKernel`` and ``cuLaunchKernelEx`` calls, memsets with
``cudaMemsetAsync``, host-to-device copies with the ``cudaMemcpyAsync``
calls of ``uresnet.stage`` (its side stream), other copies with the
other ``cudaMemcpyAsync`` calls. Containment is by time alone, whatever
the thread, so the autograd engine's launches land in the span around
``torch.autograd.grad``. An interval left over when its kind has more
intervals than calls takes the span of the nearest paired interval that
ends before it starts. A phase's reading is the union of its intervals,
clipped to the window, in ms, over the window's steps; each phase span
must occur once a step.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

from harness.loops import log

PREFIX = "uresnet."
STAGE = "uresnet.stage"
PHASES = {
    "train": ("uresnet.train.densify", "uresnet.train.forward",
              "uresnet.train.loss", "uresnet.train.backward",
              "uresnet.train.optim"),
    "ana": ("uresnet.ana.densify", "uresnet.ana.forward",
            "uresnet.ana.scores"),
}
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cuLaunchKernel", "cuLaunchKernelEx")
UNHELD = "(no span)"  # the key of the device time that no span holds


@dataclasses.dataclass
class Split:
    """A traced window's device time by span, each a step's share."""
    steps: int
    device_ms: Dict[str, float]    # union of each span's (and UNHELD's)
    idle_ms: Dict[str, float]      # the card idle while the host was in it
    count: Dict[str, int]          # the span's occurrences in the window
    fallback_ms: Dict[str, float]  # device_ms of left-over intervals
    pairs: Dict[str, Tuple[int, int]]  # per kind: (intervals, launch calls)
    busy_ms: float                 # trace.busy_s

    @property
    def total_ms(self) -> float:
        """The spans' device ms and the unheld ms, added up."""
        return sum(self.device_ms.values())


def _device_kind(name: str) -> str:
    if name.startswith("Memset"):
        return "memset"
    if name.startswith("Memcpy HtoD"):
        return "staging copy"
    return "copy" if name.startswith("Memcpy") else "kernel"


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _overlap_us(a: float, b: float, merged: List[Tuple[float, float]],
                starts: List[float], before: List[float]) -> float:
    """Length of [a, b] covered by the sorted, disjoint ``merged``
    (``starts`` their starts, ``before`` the covered length before each)."""
    def covered(t):
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return 0.0
        s, e = merged[i]
        return before[i] + min(t, e) - s
    return covered(b) - covered(a)


def split(trace, steps: int) -> Split:
    """Attribute the window's device intervals to the program's spans."""
    lo, hi = trace.window
    spans = sorted((o for o in trace.host if o.name.startswith(PREFIX)
                    and lo <= o.start <= hi), key=lambda o: o.start)
    span_starts = [o.start for o in spans]

    def holder(op) -> Optional[str]:
        i = bisect.bisect_right(span_starts, op.start) - 1
        while i >= 0:  # the latest-starting span that contains the op
            if spans[i].end >= op.end:
                return spans[i].name
            i -= 1
        return None

    calls: Dict[str, list] = {}
    for o in sorted(trace.host, key=lambda o: o.start):
        kind = None
        if o.name in KERNEL_LAUNCHES:
            kind = "kernel"
        elif o.name == "cudaMemsetAsync":
            kind = "memset"
        elif o.name == "cudaMemcpyAsync":
            kind = "copy"
        if kind is not None:
            name = holder(o)
            if kind == "copy" and name == STAGE:
                kind = "staging copy"
            calls.setdefault(kind, []).append(name)
    work: Dict[str, list] = {}
    for d in sorted(trace.device, key=lambda d: d[1]):
        work.setdefault(_device_kind(d[0]), []).append(d)
    paired, left = [], []  # (start, end, span or None)
    pairs = {}
    for kind, events in work.items():
        launched = calls.get(kind, [])
        pairs[kind] = (len(events), len(launched))
        paired += [(d[1], d[2], name) for d, name in zip(events, launched)]
        left += [(d[1], d[2]) for d in events[len(launched):]]
    by_end = sorted(paired, key=lambda d: d[1])
    ends = [d[1] for d in by_end]
    intervals: Dict[str, list] = {}
    fallback: Dict[str, list] = {}
    for a, b, name in paired:
        intervals.setdefault(name or UNHELD, []).append((a, b))
    for a, b in left:
        i = bisect.bisect_right(ends, a) - 1
        name = (by_end[i][2] if i >= 0 else None) or UNHELD
        intervals.setdefault(name, []).append((a, b))
        fallback.setdefault(name, []).append((a, b))

    def ms(iv) -> float:
        clipped = [(max(a, lo), min(b, hi)) for a, b in iv]
        return _union_us([(a, b) for a, b in clipped if b > a]) / 1e3 / steps

    busy = trace.busy_intervals()
    starts = [a for a, _ in busy]
    before, acc = [], 0.0
    for a, b in busy:
        before.append(acc)
        acc += b - a
    idle: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for s in spans:
        a, b = s.start, min(s.end, hi)
        idle[s.name] = idle.get(s.name, 0.0) + (
            b - a - _overlap_us(a, b, busy, starts, before)) / 1e3 / steps
        count[s.name] = count.get(s.name, 0) + 1
    return Split(steps, {k: ms(v) for k, v in intervals.items()}, idle, count,
                 {k: ms(v) for k, v in fallback.items()}, pairs,
                 trace.busy_s * 1e3 / steps)


_last: tuple = (None, None)  # the last window split: (trace, Split)


def _split_logged(trace, steps: int) -> Split:
    """``split`` once a window, with its account on stderr."""
    global _last
    if _last[0] is trace:
        return _last[1]
    s = split(trace, steps)
    _last = (trace, s)
    gap = s.total_ms / s.busy_ms - 1 if s.busy_ms else 0.0
    log(f"spans, ms a step over {steps}: device {s.device_ms!r}; idle "
        f"while the host was in each {s.idle_ms!r}; occurrences "
        f"{s.count!r}; device intervals and launch calls by kind "
        f"{s.pairs!r}; left over, by the fallback {s.fallback_ms!r}")
    log(f"spans: held and unheld add up to {s.total_ms!r} ms against busy "
        f"{s.busy_ms!r} ms ({100 * gap:+.3f}%"
        f"{'' if abs(gap) <= 0.01 else ', more than 1% apart'})")
    return s


def phase_ms(run, kind: str, name: str) -> Optional[float]:
    """Device ms a step of the phase span ``name`` in a ``kind`` loop's
    traced window; None for the other loop, or where a phase span of the
    loop did not occur once a step."""
    if run.kind != kind:
        return None
    s = _split_logged(run.trace, run.steps)
    off = {p: s.count.get(p, 0) for p in PHASES[kind]
           if s.count.get(p, 0) != run.steps}
    if off:
        log(f"{name} not read: phase spans not once in each of {run.steps} "
            f"steps: {off!r}")
        return None
    return s.device_ms.get(name, 0.0)
