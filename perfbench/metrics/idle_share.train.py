"""Idle share of the card in the traced window's training steps, in %:
1 - busy / the seconds of as many of them run untraced just before it.
Busy is the union of the device's kernel, copy and memset intervals in
the traced window (harness/trace.py). The untraced seconds leave out the
profiler's own host cost, which stalls the host in a traced window (30
traced flagship steps took 7.7-9.3 s against 6.8-6.9 s untraced), as the
mfu.* readers do; the traced window's own idle share is the device's
busy_s and window_s."""


def read(run):
    if run.kind != "train":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.plain_s)
