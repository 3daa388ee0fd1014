"""Device ms an analysis batch spends after its logits, in the span
``uresnet.ana.scores`` (harness/spans.py): the softmax, the scores
gathered at the points, the crop origins and the confusion counts."""

from harness import spans


def read(run):
    return spans.phase_ms(run, "ana", "uresnet.ana.scores")
