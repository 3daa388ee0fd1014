"""Device ms an analysis batch spends in its BN-folded forward, in the span
``uresnet.ana.forward`` (harness/spans.py), the fused conv's kernels with
it: no host event links their ctypes launches, and each takes the span
of the linked kernel before it."""

from harness import spans


def read(run):
    return spans.phase_ms(run, "ana", "uresnet.ana.forward")
