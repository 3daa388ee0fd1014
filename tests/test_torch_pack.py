"""The port's space-to-depth ops (uresnet_tpu_torch/ops/pack.py) vs the JAX
package's uresnet_tpu/ops/pack.py on the CPU, case for case of
tests/test_pack.py.

The relayouts are bit-equal to both of the JAX package's forms. Every
packed conv (stride 1, down, up, 2D and 3D, the concat, the H pack, down_h
and up_h) is held in f32 against the JAX ``conv_packed`` on the same packed
weights and against the port's canonical conv, within 1e-5 of the max. The
weight packing is exact forward (a relabelling) and equals ``jax.vjp``
backward within 1e-6; it runs with TF32 off, and the packed conv keeps
ops/conv.py's f32 weight gradient in bf16.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from uresnet_tpu.ops import pack as jpack
from uresnet_tpu_torch.ops import conv as tconv
from uresnet_tpu_torch.ops import pack

T = torch.from_numpy
HI = lax.Precision.HIGHEST
OPS_TOL = 1e-5


def _w(rng, shape, scale=.2):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=OPS_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _canon(x, w, stride=1, transpose=False):
    """The port's canonical f32 SAME conv (transposed at stride 2)."""
    f = tconv.conv_transpose if transpose else tconv.conv
    kw = {} if transpose else {"stride": stride}
    return f(T(x), {"w": T(w)}, dims=x.ndim - 2, compute_dtype=torch.float32,
             **kw).numpy()


def _jconv(xp, wp, **kw):
    return np.asarray(jpack.conv_packed(jnp.asarray(xp), jnp.asarray(wp),
                                        compute_dtype=jnp.float32,
                                        precision=HI, **kw))


def _pconv(xp, wp, **kw):
    return pack.conv_packed(torch.as_tensor(xp), torch.as_tensor(wp),
                            compute_dtype=torch.float32, **kw)


# -- relayouts ---------------------------------------------------------------


@pytest.mark.parametrize("dims,C", [(2, 3), (2, 64), (2, 128), (3, 3),
                                    (3, 64), (3, 128)])
def test_s2d_d2s_bit_equal_to_jax(dims, C):
    """Both JAX forms (reshape and transpose, forced) and the port's one
    form give the same bits, and the round trip is the identity."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2,) + (8,) * dims + (C,)).astype(np.float32)
    got = pack.space_to_depth(T(x), dims=dims)
    assert got.is_contiguous()
    assert tuple(got.shape) == (2,) + (4,) * dims + (2 ** dims * C,)
    for path in ("reshape", "transpose"):
        want = jpack.space_to_depth(jnp.asarray(x), dims=dims, _force_path=path)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = jpack.depth_to_space(want, dims=dims, _force_path=path)
        np.testing.assert_array_equal(
            pack.depth_to_space(got, dims=dims).numpy(), np.asarray(back))
    np.testing.assert_array_equal(pack.depth_to_space(got, dims=dims).numpy(), x)


def test_s2d_phase_layout(rng):
    """Channel ((p*2)+q)*C + c holds pixel (2i+p, 2j+q)."""
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    xp = pack.space_to_depth(T(x))
    np.testing.assert_array_equal(xp[0, 0, 0, 3:6].numpy(), x[0, 0, 1])
    np.testing.assert_array_equal(xp[1, 2, 3, 6:9].numpy(), x[1, 5, 6])


def test_s2d_h_bit_equal_to_jax(rng):
    x = rng.standard_normal((2, 8, 6, 12)).astype(np.float32)
    got = pack.s2d_h(T(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpack.s2d_h(jnp.asarray(x))))
    np.testing.assert_array_equal(pack.d2s_h(got).numpy(), x)


# -- packed convs --------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
def test_packed_conv_matches(rng, k):
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    w = _w(rng, (k, k, 3, 5))
    wp = pack.pack_weight_conv(T(w))
    np.testing.assert_array_equal(wp.numpy(),
                                  np.asarray(jpack.pack_weight_conv(jnp.asarray(w))))
    xp = pack.space_to_depth(T(x))
    got = pack.depth_to_space(_pconv(xp, wp)).numpy()
    _close(got, jpack.depth_to_space(jnp.asarray(_jconv(xp.numpy(), wp.numpy(),
                                                        padding="SAME"))))
    _close(got, _canon(x, w))


def test_packed_down_matches(rng):
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    w = _w(rng, (3, 3, 3, 6))
    wp = pack.pack_weight_down(T(w))
    xp = pack.space_to_depth(T(x))
    got = _pconv(xp, wp, padding=(0, 1)).numpy()
    _close(got, _jconv(xp.numpy(), wp.numpy(), padding=((0, 1), (0, 1))))
    _close(got, _canon(x, w, stride=2))


def test_packed_up_matches(rng):
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    w = _w(rng, (3, 3, 6, 4))
    wp = pack.pack_weight_up(T(w))
    np.testing.assert_array_equal(wp.numpy(),
                                  np.asarray(jpack.pack_weight_up(jnp.asarray(w))))
    got = pack.depth_to_space(_pconv(T(x), wp, padding=(1, 0))).numpy()
    assert got.shape == (2, 16, 16, 4)
    _close(got, jpack.depth_to_space(jnp.asarray(
        _jconv(x, wp.numpy(), padding=((1, 0), (1, 0))))))
    _close(got, _canon(x, w, transpose=True))


def test_packed_conv3d_matches(rng):
    x = rng.standard_normal((1, 8, 8, 8, 3)).astype(np.float32)
    w = _w(rng, (3, 3, 3, 3, 4))
    wp = pack.pack_weight_conv(T(w), dims=3)
    xp = pack.space_to_depth(T(x), dims=3)
    got = pack.depth_to_space(_pconv(xp, wp), dims=3).numpy()
    _close(got, jpack.depth_to_space(jnp.asarray(
        _jconv(xp.numpy(), wp.numpy(), padding="SAME", dims=3)), dims=3))
    _close(got, _canon(x, w))


def test_packed_down3d_matches(rng):
    x = rng.standard_normal((1, 8, 8, 8, 2)).astype(np.float32)
    w = _w(rng, (3, 3, 3, 2, 4))
    wp = pack.pack_weight_down(T(w), dims=3)
    xp = pack.space_to_depth(T(x), dims=3)
    got = _pconv(xp, wp, padding=(0, 1)).numpy()
    _close(got, _jconv(xp.numpy(), wp.numpy(), padding=(0, 1), dims=3))
    _close(got, _canon(x, w, stride=2))


def test_packed_up3d_matches(rng):
    x = rng.standard_normal((1, 4, 4, 4, 4)).astype(np.float32)
    w = _w(rng, (3, 3, 3, 4, 2))
    wp = pack.pack_weight_up(T(w), dims=3)
    got = pack.depth_to_space(_pconv(T(x), wp, padding=(1, 0)), dims=3).numpy()
    _close(got, jpack.depth_to_space(jnp.asarray(
        _jconv(x, wp.numpy(), padding=(1, 0), dims=3)), dims=3))
    _close(got, _canon(x, w, transpose=True))


def test_s2d_h_pack_matches(rng):
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    w = _w(rng, (3, 3, 3, 5))
    wp = pack.pack_weight_conv_h(T(w))
    np.testing.assert_array_equal(
        wp.numpy(), np.asarray(jpack.pack_weight_conv_h(jnp.asarray(w))))
    xh = pack.s2d_h(T(x))
    got = pack.d2s_h(_pconv(xh, wp)).numpy()
    _close(got, jpack.d2s_h(jnp.asarray(_jconv(xh.numpy(), wp.numpy(),
                                               padding="SAME"))))
    _close(got, _canon(x, w))


def test_packed_concat_matches(rng):
    x1 = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    x2 = rng.standard_normal((2, 16, 16, 5)).astype(np.float32)
    w = _w(rng, (3, 3, 8, 4))
    xp = torch.cat([pack.space_to_depth(T(x1)), pack.space_to_depth(T(x2))], -1)
    wp = pack.pack_weight_concat([T(w[:, :, :3]), T(w[:, :, 3:])])
    np.testing.assert_array_equal(wp.numpy(), np.asarray(jpack.pack_weight_concat(
        [jnp.asarray(w[:, :, :3]), jnp.asarray(w[:, :, 3:])])))
    got = pack.depth_to_space(_pconv(xp, wp)).numpy()
    _close(got, jpack.depth_to_space(jnp.asarray(_jconv(xp.numpy(), wp.numpy(),
                                                        padding="SAME"))))
    _close(got, _canon(np.concatenate([x1, x2], -1), w))


def test_packed_down_h_matches(rng):
    """H-pack-resident down conv: H-packed packed input, the H-packed
    stride-2 down output (k=2, pad (0,1) on both grids)."""
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    w = _w(rng, (3, 3, 3, 5))
    wdh = pack.pack_weight_down_h(pack.pack_weight_down(T(w)))
    assert tuple(wdh.shape) == (2, 2, 24, 10)
    xh = pack.s2d_h(pack.space_to_depth(T(x)))
    got = pack.d2s_h(_pconv(xh, wdh, padding=(0, 1))).numpy()
    _close(got, jpack.d2s_h(jnp.asarray(_jconv(xh.numpy(), wdh.numpy(),
                                               padding=(0, 1)))))
    _close(got, _canon(x, w, stride=2))


def test_packed_up_h_matches(rng):
    """H-pack-resident up conv: the unpacked coarse input, the H-packed
    packed transposed-conv output (k=3, H stride 2, pad (1,0))."""
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    w = _w(rng, (3, 3, 6, 4))
    wuh = pack.pack_weight_up_h(pack.pack_weight_up(T(w)))
    assert tuple(wuh.shape) == (3, 2, 6, 32)
    goth = _pconv(T(x), wuh, padding=((1, 0), (1, 0)), stride=(2, 1))
    assert tuple(goth.shape) == (2, 4, 8, 32)
    _close(goth.numpy(), _jconv(x, wuh.numpy(), padding=((1, 0), (1, 0)),
                                stride=(2, 1)))
    _close(pack.depth_to_space(pack.d2s_h(goth)).numpy(),
           _canon(x, w, transpose=True))


# -- the weight packing ----------------------------------------------------------


def _pack_cases(dims):
    cases = [
        ("conv", lambda w: pack.pack_weight_conv(w, dims),
         lambda w: jpack.pack_weight_conv(w, dims)),
        ("down", lambda w: pack.pack_weight_down(w, dims),
         lambda w: jpack.pack_weight_down(w, dims)),
        ("up", lambda w: pack.pack_weight_up(w, dims),
         lambda w: jpack.pack_weight_up(w, dims)),
    ]
    if dims == 2:
        cases += [
            ("conv_h", lambda w: pack.pack_weight_conv_h(pack.pack_weight_conv(w)),
             lambda w: jpack.pack_weight_conv_h(jpack.pack_weight_conv(w))),
            ("down_h", lambda w: pack.pack_weight_down_h(pack.pack_weight_down(w)),
             lambda w: jpack.pack_weight_down_h(jpack.pack_weight_down(w))),
            ("up_h", lambda w: pack.pack_weight_up_h(pack.pack_weight_up(w)),
             lambda w: jpack.pack_weight_up_h(jpack.pack_weight_up(w))),
        ]
    return cases


@pytest.mark.parametrize("dims", [2, 3])
def test_einsum_pack_exact_forward_and_backward(dims):
    """The packing of tests/test_pack.py's exactness case: forward a
    bit-exact relabelling (the float64 einsum of the JAX tables), backward
    the float64 sum of the packed slots' gradients within 1e-6."""
    k, ci, co = 3, 5, 7
    rng = np.random.default_rng(11)
    w = rng.standard_normal((k,) * dims + (ci, co)).astype(np.float32)
    Tb = jpack._dim_T("same", k).astype(np.float64)
    np.testing.assert_array_equal(pack._dim_T("same", k), jpack._dim_T("same", k))
    if dims == 2:
        ex = np.einsum("aupd,bvqe,deio->abuvipqo", Tb, Tb, w.astype(np.float64))
    else:
        ex = np.einsum("aupd,bvqe,cwrf,defio->abcuvwipqro", Tb, Tb, Tb,
                       w.astype(np.float64))
    P = 2 ** dims
    ex = ex.reshape((k,) * dims + (P * ci, P * co))
    wt = T(w).requires_grad_()
    got = pack.pack_weight_conv(wt, dims)
    np.testing.assert_array_equal(got.detach().numpy().astype(np.float64), ex)
    ct = rng.standard_normal(ex.shape).astype(np.float32)
    got.backward(T(ct))
    if dims == 2:
        dex = np.einsum("aupd,bvqe,abuvipqo->deio", Tb, Tb, ct.astype(
            np.float64).reshape((k, k, 2, 2, ci, 2, 2, co)))
    else:
        dex = np.einsum("aupd,bvqe,cwrf,abcuvwipqro->defio", Tb, Tb, Tb,
                        ct.astype(np.float64).reshape(
                            (k, k, k, 2, 2, 2, ci, 2, 2, 2, co)))
    np.testing.assert_allclose(wt.grad.numpy(), dex, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dims", [2, 3])
def test_pack_forward_and_backward_equal_jax(dims):
    """Every packing (and the H packs) against the JAX package's, forward
    bit-equal and backward against ``jax.vjp`` within 1e-6 of the max."""
    rng = np.random.default_rng(5)
    for name, port_fn, jax_fn in _pack_cases(dims):
        w = rng.standard_normal((3,) * dims + (4, 6)).astype(np.float32)
        want, vjp = jax.vjp(jax_fn, jnp.asarray(w))
        wt = T(w).requires_grad_()
        got = port_fn(wt)
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want),
                                      err_msg=name)
        ct = rng.standard_normal(got.shape).astype(np.float32)
        got.backward(T(ct))
        dw = np.asarray(vjp(jnp.asarray(ct))[0])
        _close(wt.grad.numpy(), dw, tol=1e-6)


@pytest.mark.parametrize("dims", [2, 3])
def test_pack_matmuls_run_true_f32_fwd_and_bwd(monkeypatch, dims):
    """Every packing runs its forward and backward matmul with TF32 off
    whatever the process's flag says, and puts the flag back (the JAX
    package's HIGHEST on these einsums): the packing's backward sums the
    packed slots' f32 weight gradients, which TF32 would round."""
    seen = []
    real = pack._matmul_true_f32

    @contextlib.contextmanager
    def recording():
        with real():
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            yield

    monkeypatch.setattr(pack, "_matmul_true_f32", recording)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    for name, port_fn, _ in _pack_cases(dims):
        seen.clear()
        w = torch.zeros((3,) * dims + (4, 8), requires_grad=True)
        port_fn(w).sum().backward()
        n = 4 if name in ("conv_h", "down_h", "up_h") else 2
        assert seen == [False] * n, (name, seen)
        assert torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("dims", [2, 3])
def test_packed_bf16_conv_keeps_the_f32_weight_gradient(dims):
    """A bf16 packed conv's weight gradient reaches the canonical f32 kernel
    in f32 (ops/conv.py ``_ConvF32WGrad`` on the packed kernel, then the f32
    packing backward): equal to the canonical bf16 conv's f32 weight
    gradient within f32 summation order (1e-5 of the max), where a
    bf16-rounded gradient would be off by ~4e-3."""
    rng = np.random.default_rng(9)
    S = (16,) * dims if dims == 2 else (8,) * dims
    x = T(rng.standard_normal((2,) + S + (4,)).astype(np.float32)).bfloat16()
    w = rng.standard_normal((3,) * dims + (4, 8)).astype(np.float32) * .2
    g = T(rng.standard_normal((2,) + S + (8,)).astype(np.float32)).bfloat16()
    wc = T(w).requires_grad_()
    tconv.conv(x, {"w": wc}, dims=dims, compute_dtype=torch.bfloat16).backward(g)
    wp = T(w).requires_grad_()
    y = pack.conv_packed(pack.space_to_depth(x, dims=dims),
                         pack.pack_weight_conv(wp, dims),
                         compute_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    y.backward(pack.space_to_depth(g, dims=dims))
    assert wp.grad.dtype == torch.float32
    _close(wp.grad.numpy(), wc.grad.numpy())


def test_frozen_weight_packs_without_gradient():
    """A frozen leaf (requires_grad False) packs to a kernel that carries
    no gradient, so the packed conv takes no weight gradient for it."""
    w = torch.zeros(3, 3, 4, 8)
    assert not pack.pack_weight_conv(w).requires_grad
    assert not pack.pack_weight_up_h(pack.pack_weight_up(w)).requires_grad
