"""The whole analysis step's share of the card's bf16 peak, in %: one
canonical forward's FLOPs per batch of the traced window over the
seconds of as many batches run untraced just before it (the profiler's
own cost left out), over 989 TFLOP/s (harness/flops.py)."""

from harness import flops


def read(run):
    if run.kind != "ana":
        return None
    total = flops.forward_flops(run.model, run.size, run.batch) * run.steps
    return 100.0 * total / run.plain_s / flops.PEAK_BF16_FLOPS
