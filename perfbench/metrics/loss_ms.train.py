"""Device ms a training step spends in its loss, in the span
``uresnet.train.loss`` (harness/spans.py): the targets in the logits'
layout and the weighted softmax cross-entropy."""

from harness import spans


def read(run):
    return spans.phase_ms(run, "train", "uresnet.train.loss")
