"""Device ms a training step spends in its forward, in the span
``uresnet.train.forward`` (harness/spans.py): the packed train forward
with train BN, and the logits' reshape."""

from harness import spans


def read(run):
    return spans.phase_ms(run, "train", "uresnet.train.forward")
