"""Train BN's kernels' share of their roofline in the traced training
window, in %: the least time the card could take for every call of the
four train-BN ops (its bytes over 3.35 TB/s: each operand read once, each
output written once), over the device time of the kernels named in
bn_train_roofline.train.json.

A call's bytes are reckoned here from the model's configuration, as
harness/flops.py reckons FLOPs, and not from anything the program counts:
the canonical U-ResNet's BatchNorm layers (`bn_layers`: elements, channels,
residual), each followed by its ReLU, every one once a step. A packed
layout moves its phases into the channels' row and keeps the elements.
Nothing is read unless, for each op, the window holds as many calls and
as many kernels as its steps make BatchNorm layers (a program without
these ops, or one whose steps run them another number of times, reads
nothing)."""

import json
import os

from harness.flops import PEAK_HBM_BYTES
from harness.loops import log

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "bn_train_roofline.train.json")) as f:
    SPEC = json.load(f)


def bn_layers(model: dict, size: int, batch: int):
    """(elements, channels, residual) of each BatchNorm layer of the
    canonical model, in forward order: stem, encoder blocks (the second
    conv of each adds the residual) and downsamples, the bottleneck's
    blocks, upsamples and decoder blocks."""
    dims, depth = model["dims"], model["depth"]
    f, blocks = model["base_filters"], model["blocks_per_level"]

    def at(s, c, res=False):
        return batch * s ** dims * c, c, res

    def resblocks(s, c):
        return [at(s, c), at(s, c, True)] * blocks

    layers = [at(size, f)]
    for lvl in range(depth):
        layers += resblocks(size >> lvl, f << lvl)
        layers.append(at(size >> (lvl + 1), f << (lvl + 1)))
    layers += resblocks(size >> depth, f << depth)
    for lvl in reversed(range(depth)):
        layers.append(at(size >> lvl, f << lvl))
        layers += resblocks(size >> lvl, f << lvl)
    return layers


def call_bytes(kernel: str, elements: int, C: int, residual: bool,
               itemsize: int) -> int:
    """Least bytes of one call with the ReLU on: activations of
    ``itemsize`` bytes, per-channel vectors and sums f32 (f64 for an
    8-byte activation); where a residual was added the backward reads the
    output for the ReLU's mask and writes the residual's gradient."""
    act = elements * itemsize
    v = 8 if itemsize == 8 else 4
    res = int(residual)
    if kernel == "bn_train_stats":        # x, 2 running stats -> sums,
        return act + v * (9 * C + 1)      # count, moments, running stats
    if kernel == "bn_train_apply":        # x (+ residual) -> y; 4 vectors
        return act * (2 + res) + 4 * v * C
    if kernel == "bn_train_grad_reduce":  # dout, x (+ out) -> 2 sums
        return act * (2 + res) + 6 * v * C
    if kernel == "bn_train_grad_input":   # dout, x (+ out) -> dx (+ dres)
        return act * (3 + 2 * res) + 6 * v * C + v
    raise ValueError(kernel)


def read(run):
    if run.kind != "train":
        return None
    layers = bn_layers(run.model, run.size, run.batch)
    want = len(layers) * run.steps
    least = busy = 0.0
    for op, kernel in SPEC["ops"].items():
        calls = [o for o in run.trace.ops(op) if not o.nested]
        kernels = [d for d in run.trace.device if kernel in d[0]]
        log(f"{op}: {len(calls)} calls, {len(kernels)} kernels in "
            f"{run.steps} steps of {len(layers)} BatchNorm layers")
        if not len(calls) == len(kernels) == want:
            return None
        name = op.split("::")[1]
        least += run.steps * sum(call_bytes(name, n, C, res, run.itemsize)
                                 for n, C, res in layers) / PEAK_HBM_BYTES
        busy += sum(b - a for _, a, b, _ in kernels) / 1e6
    return 100.0 * least / busy
