"""Device ms an analysis batch spends in its densify, in the span
``uresnet.ana.densify`` (harness/spans.py)."""

from harness import spans


def read(run):
    return spans.phase_ms(run, "ana", "uresnet.ana.densify")
