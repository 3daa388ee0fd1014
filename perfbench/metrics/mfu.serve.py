"""The whole analysis step's share of the card's bf16 peak, in %: the
useful FLOPs of the batches that were run untraced just before the
traced window (the profiler's own cost left out) over their seconds,
over 989 TFLOP/s (harness/flops.py). The architecture counts the FLOPs
of each batch's forward (archs/<arch>.py ``batch_flops``; the dense
U-ResNet's: the canonical forward)."""

from harness import flops


def read(run):
    if run.kind != "ana" or not run.flops:
        return None
    return 100.0 * run.flops / run.plain_s / flops.PEAK_BF16_FLOPS
