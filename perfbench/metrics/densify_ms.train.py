"""Device ms a training step spends in its densify, in the span
``uresnet.train.densify`` (harness/spans.py): the scatter to dense, the
class-balance weights and, with ``train.packed_loss``, the packed loss
targets."""

from harness import spans


def read(run):
    return spans.phase_ms(run, "train", "uresnet.train.densify")
