"""Device ms a training step spends in Adam, in the span
``uresnet.train.optim`` (harness/spans.py): the update and the
write-back of the params and BN buffers."""

from harness import spans


def read(run):
    return spans.phase_ms(run, "train", "uresnet.train.optim")
