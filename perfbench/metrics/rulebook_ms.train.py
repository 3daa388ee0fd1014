"""Device ms a training step spends building its rulebooks, in the span
``uresnet.train.rulebook`` (harness/spans.py): the sparse U-ResNet's sites
of every level, their neighbour tables and the maps between levels
(uresnet_tpu_torch/ops/sparse.py). Nothing is read where the span does
not occur once a step (a program without it, or the dense net)."""

from harness import spans

SPAN = "uresnet.train.rulebook"


def read(run):
    if run.kind != "train":
        return None
    if spans.split(run.trace, run.steps).count.get(SPAN) != run.steps:
        return None
    return spans.phase_ms(run, "train", SPAN)
