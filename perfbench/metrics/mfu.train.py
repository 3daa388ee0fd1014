"""The whole training step's share of the card's bf16 peak, in %: the
canonical model's useful FLOPs (forward, input and weight gradients; no
structural zero of the packed layout) of the traced window's steps over
the seconds of as many steps run untraced just before it (the
profiler's own cost left out), over 989 TFLOP/s (harness/flops.py). A float32 head counts at
the bf16 peak."""

from harness import flops


def read(run):
    if run.kind != "train":
        return None
    total = flops.train_step_flops(run.model, run.size, run.batch) * run.steps
    return 100.0 * total / run.plain_s / flops.PEAK_BF16_FLOPS
