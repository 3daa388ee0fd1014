"""The 3xTF32 split of the f32 tensor-core kernel (csrc/conv2d_f32tc.cu),
emulated in plain torch on the CPU.

TF32 keeps 11 significant bits. The kernel splits each f32 operand a into
hi = tf32(a) (round to nearest, ties away from zero, as cvt.rna.tf32.f32)
and lo = tf32(a - hi), and sums lo*hi + hi*lo + hi*hi in f32. These tests
pin that this keeps f32 accuracy against float64 at the flagship's K = 9*C
(C = 16, 128, 512) and that one TF32 product does not, with the tolerance
chip_smoke.py holds the kernel to on the card (``F64_REL``); that the
result equals the JAX package's fused conv (Pallas, interpret mode); and
why the kernel adds each chunk's partial sum into its running sum itself:
the tensor cores' f32 accumulator truncates, and 3*K/8 truncating updates
at C = 512 break the tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from uresnet_tpu.ops.pallas.conv2d import fused_conv3x3_bn_relu_v2 as pallas_v2

F64_REL = chip_smoke.F64_REL


def tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (11 significant bits), round to nearest with ties away
    from zero, as an f32 tensor whose low 13 mantissa bits are zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(t: torch.Tensor):
    hi = tf32(t)
    return hi, tf32(t - hi)


def operands(C, Co=16, size=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, size, size, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Co)) * np.sqrt(2.0 / (9 * C))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def conv(x, w):
    """3x3 SAME conv, NHWC x (3,3,C,Co) -> NHWC, in x's dtype."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def rel(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's spacing at 1
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, 1 + ulp / 4,
                      -(1 + ulp / 2), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, 1.0, 1.0, -(1 + ulp), 3.0, 0.0])
    assert torch.equal(tf32(x), want)


def test_split_is_exact_and_small():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                         .astype(np.float32) * 100)
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    # x - hi is exact in f32, and lo holds it to TF32's 11 bits
    assert torch.equal((x - hi).double(), x.double() - hi.double())
    assert ((lo.abs() <= x.abs() * 2.0 ** -11)).all()
    assert ((hi.double() + lo.double() - x.double()).abs()
            <= x.double().abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("C", [16, 128, 512])
def test_3xtf32_keeps_f32_accuracy(C):
    """At K = 9*C the split's three products stay within F64_REL of the
    float64 conv (as true f32 does), one TF32 product does not, and the
    split's result is the JAX package's fused conv within F64_REL."""
    x, w = operands(C)
    want = conv(x.double(), w.double())
    xh, xl = split(x)
    wh, wl = split(w)
    three = conv(xl, wh) + conv(xh, wl) + conv(xh, wh)
    errs = {"f32": rel(conv(x, w), want), "3xtf32": rel(three, want),
            "1xtf32": rel(conv(xh, wh), want)}
    assert errs["f32"] <= F64_REL and errs["3xtf32"] <= F64_REL, errs
    assert errs["1xtf32"] > 10 * F64_REL, errs
    Co = w.shape[3]
    jax_y = pallas_v2(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                      jnp.ones(Co, jnp.float32), jnp.zeros(Co, jnp.float32),
                      None, relu=False, block_h=x.shape[1], interpret=True)
    assert rel(three, torch.from_numpy(np.array(jax_y)).double()) <= F64_REL


def _truncate_f32(d: torch.Tensor) -> torch.Tensor:
    """float64 -> f32 rounded toward zero, as the tensor cores' adder."""
    f = d.float()
    over = f.double().abs() > d.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _mma_sum(x, w, flush_per_chunk):
    """The kernel's K loop, emulated: 8-channel chunks x 9 taps, three
    m16n8k8 products per step (lo*hi, hi*lo, hi*hi) whose 8 exact TF32
    products are added into an f32 accumulator rounded toward zero. With
    ``flush_per_chunk`` the MMAs sum each chunk from zero and the chunk is
    added into the running sum in f32 round-to-nearest."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    xh, xl = split(xp)
    wh, wl = split(w)
    total = torch.zeros(B, H, W, w.shape[3], dtype=torch.float32)
    part = torch.zeros_like(total)
    for c0 in range(0, C, 8):
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            for a, b in ((xl, wh), (xh, wl), (xh, wh)):
                win = a[:, ky:ky + H, kx:kx + W, c0:c0 + 8].double()
                prod = win @ b[ky, kx, c0:c0 + 8].double()  # exact
                part = _truncate_f32(part.double() + prod)
        if flush_per_chunk:
            total, part = total + part, torch.zeros_like(part)
    return total + part


def test_truncating_accumulator_needs_the_chunk_flush():
    """At C = 512 (K = 4608, 1728 MMA updates) a truncating f32 accumulator
    drifts past F64_REL; summing each chunk's 27 updates from zero and
    adding it with round-to-nearest, as the kernel does, stays within it."""
    x, w = operands(512, Co=8, size=8, seed=2)
    want = conv(x.double(), w.double())
    flushed = rel(_mma_sum(x, w, flush_per_chunk=True), want)
    drifted = rel(_mma_sum(x, w, flush_per_chunk=False), want)
    assert flushed <= F64_REL < drifted, (flushed, drifted)
