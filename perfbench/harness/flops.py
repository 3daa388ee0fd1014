"""Operations, bytes and the card's peaks: the arithmetic of the shares.

``uresnet_forward_macs`` is a frozen copy of the function of that name in
``uresnet_tpu_torch/tools/bench.py`` (itself the pure-Python accounting of
``benchmarks/flops.py``): the canonical model's multiply-adds, with no
structural zero of the packed layout counted. The fused conv's operations
and bytes are counted from the shapes of its call: each operand read once,
the output written once.
"""

from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def conv_macs(s_out, k, cin, cout, dims):
    return (s_out ** dims) * (k ** dims) * cin * cout


def uresnet_forward_macs(*, size, batch, dims, depth, base, blocks=2,
                         num_class=3, in_ch=1, final_kernel=3):
    """Canonical forward MACs per batch; transposed convs counted
    input-centric (every input pixel k^dims taps)."""
    total = conv_macs(size, 3, in_ch, base, dims)                    # stem
    for lvl in range(depth):
        s = size >> lvl
        f = base << lvl
        total += blocks * 2 * conv_macs(s, 3, f, f, dims)            # enc
        total += conv_macs(s >> 1, 3, f, 2 * f, dims)                # down
    sb = size >> depth
    fb = base << depth
    total += blocks * 2 * conv_macs(sb, 3, fb, fb, dims)             # mid
    for lvl in reversed(range(depth)):
        s = size >> lvl
        f = base << lvl
        total += conv_macs(s >> 1, 3, 2 * f, f, dims)                # up
        total += conv_macs(s, 3, 2 * f, f, dims)          # dec block 0
        total += conv_macs(s, 3, f, f, dims)
        total += conv_macs(s, 1, 2 * f, f, dims)          # its 1x1 proj
        total += (blocks - 1) * 2 * conv_macs(s, 3, f, f, dims)      # dec 1..
    total += conv_macs(size, final_kernel, base, num_class, dims)    # head
    return total * batch


def forward_flops(model: dict, size: int, batch: int) -> int:
    return 2 * uresnet_forward_macs(
        size=size, batch=batch, dims=model["dims"], depth=model["depth"],
        base=model["base_filters"], blocks=model["blocks_per_level"],
        num_class=model["num_class"], in_ch=model["in_channels"],
        final_kernel=model["final_kernel"])


def train_step_flops(model: dict, size: int, batch: int) -> int:
    """Forward, input gradient and weight gradient: 3 forwards; 4 when
    activations are recomputed (``remat``)."""
    return (4 if model.get("remat") else 3) * forward_flops(model, size, batch)


def fused_conv_call(shapes: Sequence[Sequence[int]], itemsize: int):
    """(FLOPs, bytes) of one call of the fused 3x3 conv from its operand
    shapes as the profiler records them: x (B, H, W, C), w (3, 3, C, Co),
    scale (Co,), bias (Co,), residual (B, H, W, Co) or absent. x, w, the
    residual and y are ``itemsize`` wide, scale and bias float32."""
    (B, H, W, C), (_, _, _, Co) = shapes[0], shapes[1]
    flops = 2 * B * H * W * 9 * C * Co
    has_res = len(shapes) > 4 and len(shapes[4]) == 4
    elems = B * H * W * C + 9 * C * Co + B * H * W * Co * (2 if has_res else 1)
    return flops, itemsize * elems + 4 * 2 * Co


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
