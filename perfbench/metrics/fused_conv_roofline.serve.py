"""The fused 3x3 conv's share of its roofline in the traced analysis
window, in %: for each call of the op, the least time the card could take
(the larger of its FLOPs over 989 TFLOP/s and its bytes over 3.35 TB/s,
reckoned from the call's operand shapes as the profiler recorded them),
summed, over the device time of the kernels the profiler correlates with
the op's calls. Where it correlates none, the kernels are those named in
fused_conv_roofline.serve.json. Nothing is read unless the kernels, the
calls and the op's launch counter agree in number."""

import json
import os

from harness import flops
from harness.loops import log

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fused_conv_roofline.serve.json")) as f:
    SPEC = json.load(f)


def read(run):
    if run.kind != "ana":
        return None
    events = run.trace.ops(SPEC["op"])
    calls = [o for o in events if not o.nested]
    kernels = run.trace.kernels_of(o.id for o in events)
    how = "correlated with the op"
    if len(kernels) != len(calls):
        kernels = [d for d in run.trace.device
                   if any(k in d[0] for k in SPEC["kernels"])]
        how = "by kernel name"
    log(f"fused conv: {len(calls)} calls, {len(kernels)} kernels ({how}), "
        f"launch counter +{run.launches}, "
        f"{len(kernels) / run.steps!r} kernels per batch")
    if not calls or not len(kernels) == len(calls) == run.launches:
        return None
    least = sum(flops.least_seconds(*flops.fused_conv_call(o.shapes,
                                                           run.itemsize))
                for o in calls)
    busy = sum(b - a for _, a, b, _ in kernels) / 1e6
    return 100.0 * least / busy
