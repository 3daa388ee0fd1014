"""Device ms a training step spends in its backward, in the span
``uresnet.train.backward`` (harness/spans.py): every kernel that
``torch.autograd.grad`` launches, from whichever thread."""

from harness import spans


def read(run):
    return spans.phase_ms(run, "train", "uresnet.train.backward")
