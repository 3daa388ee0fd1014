"""The sparse convolutions' share of their roofline in the traced training
window, in %: the useful FLOPs of the window's steps (``Traced.flops``,
archs/sparse_uresnet.py ``batch_flops``: 2 x pairs x C_in x C_out for each
conv's forward, weight gradient and, but the stem's, input gradient, the
1x1 maps and the head with them) over 989 TFLOP/s, over the device time of
the kernels named in sparse_conv_roofline.train.json (the forward and
input gradient's gather-GEMM, the weight gradient's; each in its
pipelined form and in the form for channel counts off 8).

The train trace records no operand shapes, so this is the compute side of
the roofline alone: a lower bound of the true share. Where the shallow
levels (1.6-3.4 neighbours a site, 16-32 channels) are bound by bandwidth,
it reads low. It cannot pass 100% while every counted FLOP runs in a named
kernel. Nothing is read unless the window holds as many of those kernels
as its steps launch: each of the sparse net's convs and linear maps (from
the configuration: the stem, two a residual block and a 1x1 map where it
changes channels, Down, Up, the head) once forward, once for its weight
gradient and, but the stem, once for its input gradient."""

import json
import os

from harness.flops import PEAK_BF16_FLOPS
from harness.loops import log

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "sparse_conv_roofline.train.json")) as f:
    SPEC = json.load(f)


def convs(model: dict) -> int:
    """The sparse U-ResNet's convs and linear maps."""
    L, nb = model["depth"] + 1, model["blocks_per_level"]
    # stem; encoder blocks; Down and Up; decoder blocks with the first
    # one's 1x1 map; head
    return 1 + 2 * nb * L + 2 * (L - 1) + (L - 1) * (2 * nb + 1) + 1


def read(run):
    if run.kind != "train" or run.model.get("arch") != "sparse_uresnet" \
            or not run.flops:
        return None
    want = run.steps * (3 * convs(run.model) - 1)
    kernels = [d for d in run.trace.device
               if any(k in d[0] for k in SPEC["kernels"])]
    log(f"sparse conv: {len(kernels)} kernels in {run.steps} steps, "
        f"{want} launched")
    if len(kernels) != want:
        return None
    busy = sum(b - a for _, a, b, _ in kernels) / 1e6
    return 100.0 * run.flops / PEAK_BF16_FLOPS / busy
