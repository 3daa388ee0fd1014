"""Space-to-depth packing (port of uresnet_tpu/ops/pack.py): an exact
relayout of the high-resolution, low-channel levels, 2D and 3D.

Packing r x r (x r) spatial phases into channels (512^2 x C -> 256^2 x 4C
in 2D; 192^3 x C -> 96^3 x 8C in 3D) is the JAX package's TPU layout: it
fills the MXU's 128 lanes. The packed kernels are a linear relabelling of
the canonical weights, so parameters and checkpoints keep the canonical
layout and the packed forward equals the canonical one.

Math (r = 2 per spatial dim, odd k, SAME), per dim:
    Y[2i+p] = sum_dy X[2i+p+dy-k//2] W[dy]
    row 2i+p+dy-k//2 = 2(i+a)+p'  =>  dy = 2a + p' - p + k//2
so a stride-1 k-odd conv becomes a packed k conv over (2^dims)C channels
(out-of-range dy are structural zeros); a stride-2 k=3 conv (SAME, pad_lo
0) becomes a packed k=2 conv with (0,1) padding emitting UNPACKED output;
a k=3 s=2 transposed conv becomes a packed k=2 conv with (1,0) padding
emitting PACKED output.

Weight packing is a product with a static 0/1 table (`_pack`): the
per-dim tables ``T[A, p', p, dy]`` of `_dim_tables`, combined over the
dims, times the kernel. Each packed slot selects one canonical weight or
0, so the forward is an exact relabelling and the backward an f32 sum of
the packed slots' gradients into the canonical weight. Both run in f32
with TF32 off for their own matmul, as JAX runs these einsums at
``Precision.HIGHEST`` (a TF32 backward would round every partial).

No kernel is hand-written here: the relayouts are one contiguous copy
each and the packed convs run through ops/conv.py ``conv_general``, so
they keep its f32 weight gradient, the raised head's operand rounding and
true f32 exactly as the canonical convs have them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from uresnet_tpu_torch.ops.conv import conv_general

R = 2  # pack factor per spatial dim

_DIM_T: Dict[Tuple, np.ndarray] = {}
_TABLES: Dict[Tuple, torch.Tensor] = {}


def space_to_depth(x: torch.Tensor, r: int = R, dims: int = 2) -> torch.Tensor:
    """(B, *S, C) -> (B, *S/r, r^dims * C); channel order phase-major
    (p_0, ..., p_{dims-1}, c). One contiguous copy (the JAX package picks
    between two bit-identical forms by TPU lane fill; this is its
    transpose form)."""
    B, S, C = x.shape[0], x.shape[1:1 + dims], x.shape[-1]
    shape = (B,)
    for s in S:
        shape += (s // r, r)
    x = x.reshape(shape + (C,))
    # (B, s0/r, r, s1/r, r, ..., C) -> (B, s0/r, s1/r, ..., r, r, ..., C)
    perm = ((0,) + tuple(1 + 2 * d for d in range(dims))
            + tuple(2 + 2 * d for d in range(dims)) + (1 + 2 * dims,))
    return x.permute(perm).reshape(
        (B,) + tuple(s // r for s in S) + (r ** dims * C,))


def depth_to_space(x: torch.Tensor, r: int = R, dims: int = 2) -> torch.Tensor:
    """Inverse of `space_to_depth`."""
    B, Sp = x.shape[0], x.shape[1:1 + dims]
    C = x.shape[-1] // r ** dims
    x = x.reshape((B,) + tuple(Sp) + (r,) * dims + (C,))
    perm = [0]
    for d in range(dims):
        perm += [1 + d, 1 + dims + d]
    perm.append(1 + 2 * dims)
    return x.permute(perm).reshape((B,) + tuple(s * r for s in Sp) + (C,))


def s2d_h(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W, 2C), channel index p*C + c: the extra
    H phase of 2D block runs whose packed channels still underfill the
    TPU's lanes."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W, C).permute(0, 1, 3, 2, 4).reshape(
        B, H // 2, W, 2 * C)


def d2s_h(x: torch.Tensor) -> torch.Tensor:
    B, Hp, W, C2 = x.shape
    return x.reshape(B, Hp, W, 2, C2 // 2).permute(0, 1, 3, 2, 4).reshape(
        B, Hp * 2, W, C2 // 2)


def _dim_tables(kind: str, k: int):
    """Per-dim (kp, pi, po, dy[kp, pi, po], valid) tables."""
    if kind == "same":
        kp, pi, po = k, R, R
        A = np.arange(kp)[:, None, None]
        pp = np.arange(pi)[None, :, None]
        p = np.arange(po)[None, None, :]
        dy = 2 * (A - kp // 2) + pp - p + k // 2
    elif kind == "down":
        kp, pi, po = 2, R, 1
        A = np.arange(kp)[:, None, None]
        pp = np.arange(pi)[None, :, None]
        dy = np.broadcast_to(2 * A + pp, (kp, pi, po)).copy()
    elif kind == "up":
        kp, pi, po = 2, 1, R
        # y[2t+p]: p=0 reads x[t-1] w[0] (tap A=0) and x[t] w[2] (A=1);
        # p=1 reads x[t] w[1] (A=1). Input padding (1,0).
        dy = np.full((kp, pi, po), -1)
        for (a, pv), d in {(0, 0): 0, (1, 0): 2, (1, 1): 1}.items():
            dy[a, 0, pv] = d
    elif kind == "down_h":
        # H-pack both sides of the packed-down H kernel (k=2, pad (0,1),
        # stride 1): ydh[v] = (yd[2v], yd[2v+1]) reads xh[v+a] phase u via
        # down-tap dy = 2a + u - p
        kp, pi, po = 2, R, R
        A = np.arange(kp)[:, None, None]
        pp = np.arange(pi)[None, :, None]
        p = np.arange(po)[None, None, :]
        dy = 2 * A + pp - p
    elif kind == "up_h":
        # H-pack the output of the packed-up H kernel (k=2, pad (1,0)):
        # yuh[v] = (yu[2v], yu[2v+1]) reads the unpacked coarse input
        # x[2v + A - 1], A in 0..2 — a k=3 stride-2 pad (1,0) conv on the
        # coarse grid; up-tap dy = A - p
        kp, pi, po = 3, 1, R
        A = np.arange(kp)[:, None, None]
        p = np.arange(po)[None, None, :]
        dy = np.broadcast_to(A - p, (kp, pi, po)).copy()
    else:
        raise ValueError(kind)
    valid = (dy >= 0) & (dy < k)
    return kp, pi, po, np.clip(dy, 0, k - 1), valid


def _dim_T(kind: str, k: int) -> np.ndarray:
    """The 0/1 table T[A, p', p, dy] of one dim: packed tap A, input phase
    p', output phase p read canonical tap dy."""
    key = (kind, k)
    if key not in _DIM_T:
        kp, pi, po, dy, valid = _dim_tables(kind, k)
        T = np.zeros((kp, pi, po, k), np.float32)
        for A in range(kp):
            for u in range(pi):
                for p in range(po):
                    if valid[A, u, p]:
                        T[A, u, p, dy[A, u, p]] = 1.0
        _DIM_T[key] = T
    return _DIM_T[key]


def _dim_shape(kind: Optional[str], k: int) -> Tuple[int, int, int]:
    """(kp, pi, po) of a dim; None keeps the dim: (k, 1, 1)."""
    return _dim_T(kind, k).shape[:3] if kind else (k, 1, 1)


def _table(kinds: Tuple[Optional[str], ...], ks: Tuple[int, ...],
           device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The per-dim tables of ``kinds`` (None: the dim is kept, an identity
    over its taps) multiplied out: M[(A..), (p'..), (p..), (dy..)] as a
    (prod kp * prod pi * prod po, prod k) matrix on ``device``, made once."""
    key = (kinds, ks, device, dtype)
    if key not in _TABLES:
        M = np.ones((1, 1, 1, 1), np.float32)
        for kd, k in zip(kinds, ks):  # dims major to minor in each index
            T = _dim_T(kd, k) if kd else np.eye(k, dtype=np.float32)[:, None, None]
            M = np.einsum("aupd,bvqe->abuvpqde", M, T).reshape(
                M.shape[0] * T.shape[0], M.shape[1] * T.shape[1],
                M.shape[2] * T.shape[2], M.shape[3] * T.shape[3])
        _TABLES[key] = torch.from_numpy(M.reshape(-1, M.shape[3])).to(
            device=device, dtype=dtype)
    return _TABLES[key]


@contextlib.contextmanager
def _matmul_true_f32():
    """TF32 off for the enclosed matmuls only, then the flag put back."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _Pack(torch.autograd.Function):
    """``M @ w`` over the taps, f32 with TF32 off forward and backward."""

    @staticmethod
    def forward(ctx, w2, M):
        ctx.save_for_backward(M)
        with _matmul_true_f32():
            return M @ w2

    @staticmethod
    def backward(ctx, g):
        M, = ctx.saved_tensors
        with _matmul_true_f32():
            return M.t() @ g, None


def _pack(w: torch.Tensor, kinds: Tuple[Optional[str], ...]) -> torch.Tensor:
    """(*k, Ci, Co) -> (*kp, pi^n * Ci, po^n * Co), channel order
    phase-major (phases of the packed dims, then the channel)."""
    n = len(kinds)
    ks, (ci, co) = tuple(w.shape[:n]), w.shape[n:]
    shapes = [_dim_shape(kd, k) for kd, k in zip(kinds, ks)]
    kp = tuple(s[0] for s in shapes)
    pi = int(np.prod([s[1] for s in shapes]))
    po = int(np.prod([s[2] for s in shapes]))
    out = _Pack.apply(w.reshape(-1, ci * co),
                      _table(kinds, ks, w.device, w.dtype))
    out = out.reshape(int(np.prod(kp)), pi, po, ci, co).permute(0, 1, 3, 2, 4)
    return out.reshape(kp + (pi * ci, po * co))


def pack_weight_conv(w: torch.Tensor, dims: int = 2) -> torch.Tensor:
    """(k..k, Ci, Co), k odd, stride-1 SAME -> packed (k..k, P*Ci, P*Co)."""
    return _pack(w, ("same",) * dims)


def pack_weight_down(w: torch.Tensor, dims: int = 2) -> torch.Tensor:
    """k=3 stride-2 SAME (pad_lo 0) -> packed (2..2, P*Ci, Co); output
    UNPACKED on the packed grid. Use padding (0,1) per dim."""
    return _pack(w, ("down",) * dims)


def pack_weight_up(w: torch.Tensor, dims: int = 2) -> torch.Tensor:
    """k=3 s=2 SAME transposed conv -> packed (2..2, Ci, P*Co); input
    UNPACKED (half-res), output PACKED. Use padding (1,0) per dim."""
    return _pack(w, ("up",) * dims)


def pack_weight_concat(ws: Sequence[torch.Tensor], dims: int = 2) -> torch.Tensor:
    """Packed stride-1 kernel for an input that is a CONCAT of packed
    tensors: each input-channel slice packed on its own, then concatenated
    (the phase-major layout is per tensor)."""
    return torch.cat([pack_weight_conv(w, dims) for w in ws], dim=-2)


def pack_weight_conv_h(w: torch.Tensor) -> torch.Tensor:
    """H-only factor-2 pack of a stride-1 SAME odd-k 2D kernel:
    (k,k,Ci,Co) -> (k,k,2Ci,2Co). Composes with `pack_weight_conv`."""
    return _pack(w, ("same", None))


def pack_weight_down_h(wp: torch.Tensor) -> torch.Tensor:
    """H-pack a packed-down 2D kernel (from `pack_weight_down`): consumes
    H-PACKED input, emits the H-PACKED down output. (2,2,P*Ci,Co) ->
    (2,2,2*P*Ci,2*Co); padding (0,1), stride 1; `d2s_h` gives the
    canonical (S/2)^2 down output."""
    return _pack(wp, ("down_h", None))


def pack_weight_up_h(wu: torch.Tensor) -> torch.Tensor:
    """H-pack a packed-up 2D kernel's OUTPUT (from `pack_weight_up`):
    consumes the UNPACKED coarse input, emits H-PACKED packed output.
    (2,2,Ci,P*Co) -> (3,2,Ci,2*P*Co); H stride 2, padding ((1,0),(1,0))."""
    return _pack(wu, ("up_h", None))


def conv_packed(xp: torch.Tensor, wp: torch.Tensor, *, padding="SAME",
                stride=1, compute_dtype: torch.dtype,
                precision: Optional[torch.dtype] = None) -> torch.Tensor:
    """A packed conv through ops/conv.py ``conv_general``: ``padding``
    'SAME' or explicit (lo, hi) pads (one pair, or a pair per axis);
    ``stride`` an int or one per axis."""
    return conv_general(xp, wp, stride=stride, compute_dtype=compute_dtype,
                        precision=precision,
                        padding=None if padding == "SAME" else padding)
