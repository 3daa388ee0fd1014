"""Port ops vs the JAX package on the CPU: conv / conv_transpose / eval and
train BN (and train BN's analytic backward vs autograd in float64, its
kernels' launch geometry and operand checks), conv gradients (f32, and
the bf16 path's f32 weight gradient), the fused conv's plain version vs both Pallas kernels (interpret mode), the
kernel eligibility rule, the wrapper's input checks, and the kernel build.

Inputs are made with numpy from a seed and handed to both packages; f32
throughout, so the tolerances measure the algorithm, not rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uresnet_tpu.ops.conv import conv as jax_conv
from uresnet_tpu.ops.conv import conv_transpose as jax_conv_transpose
from uresnet_tpu.ops.norm import batch_norm as jax_batch_norm
from uresnet_tpu.ops.pallas.conv2d import fused_conv3x3_bn_relu as pallas_v1
from uresnet_tpu.ops.pallas.conv2d import fused_conv3x3_bn_relu_v2 as pallas_v2
from uresnet_tpu_torch.models.fold import fused_eligible
from uresnet_tpu_torch.ops import conv as tconv
from uresnet_tpu_torch.ops import norm as tnorm
from uresnet_tpu_torch.ops.cuda import bn_train as tbn
from uresnet_tpu_torch.ops.cuda import build
from uresnet_tpu_torch.ops.cuda import conv2d as tfused
from uresnet_tpu_torch.utils.dtypes import canonical_dtype

T = torch.from_numpy


def _params(rng, k, cin, cout, bias):
    p = {"w": rng.standard_normal((k, k, cin, cout)).astype(np.float32) * .3}
    if bias:
        p["b"] = rng.standard_normal(cout).astype(np.float32)
    return p


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_matches_jax(rng, stride, size, bias):
    x = rng.standard_normal((2, size, size + 1, 5)).astype(np.float32)
    p = _params(rng, 3, 5, 6, bias)
    want = jax_conv(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                    stride=stride, compute_dtype=jnp.float32)
    got = tconv.conv(T(x), {k: T(v) for k, v in p.items()}, stride=stride,
                     compute_dtype=torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_head_precision_rounds_operands(rng):
    """A head raised to f32 over a bf16 model: operands rounded to bf16,
    products summed into an unrounded f32 output; same-dtype heads: None."""
    assert tconv.head_precision(torch.float32, torch.float32) is None
    prec = tconv.head_precision(torch.float32, torch.bfloat16)
    assert prec is torch.bfloat16
    x = T(rng.standard_normal((1, 6, 6, 16)).astype(np.float32))
    p = {k: T(v) for k, v in _params(rng, 3, 16, 3, True).items()}
    got = tconv.conv(x, p, compute_dtype=torch.float32, precision=prec)
    rounded = {"w": p["w"].bfloat16().float(), "b": p["b"]}
    want = tconv.conv(x.bfloat16().float(), rounded,
                      compute_dtype=torch.float32)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, tconv.conv(x, p, compute_dtype=torch.float32))
    # the weight is rounded as an operand: its gradient is the f32 gradient
    # of the rounded conv, not rounded to bf16 on the way back
    w = p["w"].clone().requires_grad_()
    tconv.conv(x, {"w": w, "b": p["b"]}, compute_dtype=torch.float32,
               precision=prec).sum().backward()
    wr = rounded["w"].clone().requires_grad_()
    tconv.conv(x.bfloat16().float(), {"w": wr, "b": p["b"]},
               compute_dtype=torch.float32).sum().backward()
    torch.testing.assert_close(w.grad, wr.grad, rtol=0, atol=0)


@pytest.mark.parametrize("size", [4, 5])
def test_conv_transpose_matches_jax(rng, size):
    x = rng.standard_normal((2, size, size + 2, 6)).astype(np.float32)
    p = _params(rng, 3, 6, 4, True)
    want = jax_conv_transpose(jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in p.items()},
                              compute_dtype=jnp.float32)
    got = tconv.conv_transpose(T(x), {k: T(v) for k, v in p.items()},
                               compute_dtype=torch.float32)
    assert got.shape == want.shape == (2, 2 * size, 2 * size + 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_batch_norm_eval_matches_jax(rng):
    x = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    p = {"scale": rng.uniform(.5, 2, 7).astype(np.float32),
         "bias": rng.standard_normal(7).astype(np.float32)}
    s = {"mean": rng.standard_normal(7).astype(np.float32),
         "var": rng.uniform(.2, 3, 7).astype(np.float32)}
    want, _ = jax_batch_norm(jnp.asarray(x), p, s, train=False, eps=1e-3)
    got = tnorm.batch_norm(T(x), {k: T(v) for k, v in p.items()},
                           {k: T(v) for k, v in s.items()}, eps=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_batch_norm_train_matches_jax(rng):
    """y and the new running stats at f32, 1e-5; the stats are new tensors,
    detached, and the given state is not written."""
    x = (rng.standard_normal((3, 5, 6, 7)) * 2 + 1).astype(np.float32)
    p = {"scale": rng.uniform(.5, 2, 7).astype(np.float32),
         "bias": rng.standard_normal(7).astype(np.float32)}
    s = {"mean": rng.standard_normal(7).astype(np.float32),
         "var": rng.uniform(.2, 3, 7).astype(np.float32)}
    want, want_s = jax_batch_norm(jnp.asarray(x), p, s, train=True,
                                  momentum=0.99, eps=1e-3)
    ts = {k: T(v.copy()) for k, v in s.items()}
    xt = T(x).requires_grad_()
    got, got_s = tnorm.batch_norm_train(xt, {k: T(v) for k, v in p.items()},
                                        ts, momentum=0.99, eps=1e-3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(want_s[k]),
                                   rtol=1e-5, atol=1e-5)
        assert not got_s[k].requires_grad and got_s[k] is not ts[k]
        np.testing.assert_array_equal(ts[k].numpy(), s[k])
    # gradients flow through the batch statistics: sum(y) is constant in x
    # for each channel (y is normalized), so dL/dx of sum(y) vanishes
    got.sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), 0, atol=1e-4)


def _bn_unfused(x, scale, bias, residual, relu, phases, eps):
    """Train BN as autograd runs it unfused: the statistics of the packed
    view (mean, square().mean), the affine, + residual, ReLU."""
    C = x.shape[-1] // phases
    xs = x.reshape(x.shape[:-1] + (phases, C))
    dims = tuple(range(xs.dim() - 1))
    mean = xs.mean(dims)
    var = xs.square().mean(dims) - mean.square()
    g = torch.rsqrt(var + eps) * scale
    y = (xs * g + (bias - mean * g)).reshape(x.shape)
    if residual is not None:
        y = y + residual
    return (torch.relu(y) if relu else y), mean.detach(), var.detach()


@pytest.mark.parametrize("phases", [1, 4, 8])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_batch_norm_train_analytic_backward_matches_autograd(rng, relu,
                                                            residual, phases):
    """float64, no group: batch_norm_train (the plain versions of its four
    kernels, the analytic input gradient in one pass) equals autograd of
    the unfused formula in y and in the gradients of x, scale, bias and
    the residual; the running stats equal the unfused form's; the plain
    versions count no launch."""
    C, eps, momentum = 3, 1e-3, 0.99
    x = rng.standard_normal((2, 5, 4, phases * C)) * 2 + 0.5
    r = rng.standard_normal(x.shape) if residual else None
    p = {"scale": rng.uniform(.5, 2, C), "bias": rng.standard_normal(C)}
    s = {"mean": rng.standard_normal(C), "var": rng.uniform(.2, 3, C)}
    dy = T(rng.standard_normal(x.shape))
    before = [getattr(tbn, f"launches_bn_train_{k}")
              for k in ("stats", "apply", "grad_reduce", "grad_input")]
    runs = []
    for fused in (True, False):
        leaves = [T(x).requires_grad_(), T(p["scale"]).requires_grad_(),
                  T(p["bias"]).requires_grad_()]
        if residual:
            leaves.append(T(r).requires_grad_())
        res = leaves[3] if residual else None
        if fused:
            y, new = tnorm.batch_norm_train(
                leaves[0], {"scale": leaves[1], "bias": leaves[2]},
                {k: T(v) for k, v in s.items()}, momentum=momentum, eps=eps,
                phases=phases, relu=relu, residual=res)
        else:
            y, mean, var = _bn_unfused(*leaves[:3], res, relu, phases, eps)
            new = {"mean": T(s["mean"]) * momentum + mean * (1 - momentum),
                   "var": T(s["var"]) * momentum + var * (1 - momentum)}
        grads = torch.autograd.grad((y * dy).sum(), leaves)
        runs.append((y.detach(), new, grads))
    (y, new, grads), (y0, new0, grads0) = runs
    assert y.dtype == torch.float64 and y.shape == x.shape
    torch.testing.assert_close(y, y0, rtol=1e-12, atol=1e-12)
    for k in ("mean", "var"):
        torch.testing.assert_close(new[k], new0[k], rtol=1e-12, atol=1e-12)
        assert not new[k].requires_grad
    for name, g, g0 in zip(("x", "scale", "bias", "residual"), grads, grads0):
        torch.testing.assert_close(g, g0, rtol=1e-10, atol=1e-10, msg=name)
    assert before == [getattr(tbn, f"launches_bn_train_{k}")
                      for k in ("stats", "apply", "grad_reduce", "grad_input")]


@pytest.mark.parametrize("rows, W, C, itemsize, aligned, want", [
    # 2D level 0: (32, 128, 256, 128) bf16, 8 phases of 16 channels
    (32 * 128 * 256, 128, 16, 2, True, ((8, 16, 528, 1), (8, 16, 528, 1))),
    # the deepest 2D level: (32, 16, 16, 512) bf16
    (32 * 16 * 16, 512, 512, 2, True, ((8, 64, 32, 1), (8, 64, 528, 1))),
    # f32 rows of 3 channels, and an operand off 16 bytes: one element
    (37, 3, 3, 4, True, ((1, 3, 1, 1), (1, 3, 1, 1))),
    (37, 128, 16, 2, False, ((1, 128, 19, 1), (1, 128, 19, 1))),
    # rows wider than a block: two column tiles
    (1000, 4096, 2048, 2, True, ((8, 256, 4, 2), (8, 256, 264, 2))),
])
def test_bn_train_geometry(rows, W, C, itemsize, aligned, want):
    """The launch geometry from the activation alone (132 SMs): 16-byte
    vectors where W and the pointers allow, a block's tile of whole rows,
    a reduction's partial sums within 32 Ki values."""
    got = tuple(tbn.geometry(rows, W, C, itemsize, aligned, 132, reduce)
                for reduce in (True, False))
    assert got == want
    for vec, tx, gx, gy in got:
        assert tx * (tbn.THREADS // tx) <= tbn.THREADS
        assert vec * tx * gy >= W and W % vec == 0
    vec, tx, gx, gy = got[0]
    assert gx * 2 * (C if gy == 1 else W) <= 32768


def test_bn_train_rejects_operands_the_kernels_do_not_take():
    x = torch.zeros(4, 8)
    v = torch.zeros(4)
    tbn._check(x, 4, (torch.zeros(4, 8),), [(v, 4)])
    for args, err in [((torch.zeros(4, 8, dtype=torch.int32), 4), TypeError),
                      ((torch.zeros(4, 8, 1), 4), ValueError),
                      ((x, 3), ValueError),
                      ((x, 4, (torch.zeros(4, 8).t(),)), ValueError),
                      ((x, 4, (torch.zeros(4, 8, dtype=torch.float64),)),
                       ValueError),
                      ((x, 4, (), [(v.double(), 4)]), ValueError),
                      ((x, 4, (), [(v, 8)]), ValueError)]:
        with pytest.raises(err):
            tbn._check(*args)


def test_bn_train_ops_pass_opcheck(rng):
    """The four ops' registrations (schema, fake kernels, no aliasing)
    hold on the CPU."""
    C, rows, W = 4, 6, 8
    x = T(rng.standard_normal((rows, W)).astype(np.float32))
    d = T(rng.standard_normal((rows, W)).astype(np.float32))
    vec = [T(rng.uniform(.5, 2, C).astype(np.float32)) for _ in range(4)]
    sums = T(rng.standard_normal(2 * C).astype(np.float32))
    count = torch.tensor([12.0])
    for op, args in [
            (torch.ops.uresnet_tpu_torch.bn_train_stats,
             (x, C, 1e-3, vec[0], vec[1], 0.99)),
            (torch.ops.uresnet_tpu_torch.bn_train_apply,
             (x, d, *vec, True)),
            (torch.ops.uresnet_tpu_torch.bn_train_grad_reduce,
             (d, x, x, *vec, True)),
            (torch.ops.uresnet_tpu_torch.bn_train_grad_input,
             (d, x, None, *vec, sums, count, True, True)),
            (torch.ops.uresnet_tpu_torch.bn_train_grad_input,
             (d, x, None, *vec, sums, count, False, False))]:
        torch.library.opcheck(op, args, test_utils=(
            "test_schema", "test_faketensor"))


def _conv_case(rng, kind, stride, size):
    x = rng.standard_normal((2, size, size + 1, 5)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 5, 6)) * .3).astype(np.float32)
    out = ((size * stride, (size + 1) * stride) if kind == "convt"
           else (-(-size // stride), -(-(size + 1) // stride)))
    g = rng.standard_normal((2,) + out + (6,)).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("kind,stride", [("conv", 1), ("conv", 2),
                                         ("convt", 2)])
def test_conv_general_grads_match_jax(rng, kind, stride):
    """dx and dw of the f32 conv vs jax.vjp of conv_general, f32, 1e-5."""
    from uresnet_tpu.ops.conv import conv_general as jax_conv_general

    x, w, g = _conv_case(rng, kind, stride, 8)
    y, vjp = jax.vjp(lambda xx, ww: jax_conv_general(
        xx, ww, strides=stride, padding="SAME", dims=2,
        compute_dtype=jnp.float32, kind=kind), jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    xt, wt = T(x).requires_grad_(), T(w).requires_grad_()
    got = tconv.conv_general(xt, wt, stride=stride, compute_dtype=torch.float32,
                             kind=kind)
    assert got.shape == y.shape
    got.backward(T(g))
    for a, b in ((got.detach(), y), (xt.grad, want_dx), (wt.grad, want_dw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("kind,stride", [("conv", 1), ("conv", 2),
                                         ("convt", 2)])
def test_conv_general_bf16_f32_weight_grad(rng, kind, stride):
    """bf16 compute: forward and dx exactly as stock bf16 autograd; dw an
    f32 tensor within 1e-5 (relative to its max) of the float64 product of
    the bf16 operands — bf16 rounding would be ~4e-3."""
    x, w, g = _conv_case(rng, kind, stride, 16)
    xt, wt = T(x).requires_grad_(), T(w).requires_grad_()
    gb = T(g).bfloat16()
    got = tconv.conv_general(xt, wt, stride=stride,
                             compute_dtype=torch.bfloat16, kind=kind)
    assert got.dtype == torch.bfloat16
    got.backward(gb)
    assert wt.grad.dtype == torch.float32

    # stock autograd on the same bf16 operands
    xs, ws = T(x).requires_grad_(), T(w).requires_grad_()
    xb, wb = xs.bfloat16(), ws.bfloat16()
    if kind == "conv":
        (h0, h1), (w0, w1) = (tconv._same_pads(16, 3, stride),
                              tconv._same_pads(17, 3, stride))
        xn = torch.nn.functional.pad(xb.permute(0, 3, 1, 2), (w0, w1, h0, h1))
        ref = torch.nn.functional.conv2d(
            xn, wb.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)
    else:
        ref = torch.nn.functional.conv_transpose2d(
            xb.permute(0, 3, 1, 2), wb.flip(0, 1).permute(2, 3, 0, 1),
            stride=2)[:, :, :16 * 2, :17 * 2].permute(0, 2, 3, 1)
    ref.backward(gb)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(xt.grad, xs.grad, rtol=0, atol=0)

    # dw in float64 from the same bf16-valued operands
    x64 = T(x).bfloat16().double().requires_grad_(False)
    w64 = T(w).bfloat16().double().requires_grad_()
    y64 = tconv.conv_general(x64, w64, stride=stride,
                             compute_dtype=torch.float64, kind=kind)
    y64.backward(gb.double())
    err = (wt.grad.double() - w64.grad).abs().max() / w64.grad.abs().max()
    assert err <= 1e-5, float(err)
    bf16_err = (ws.grad.double() - w64.grad).abs().max() / w64.grad.abs().max()
    assert bf16_err > 1e-4  # stock autograd rounds dw to bf16


@pytest.mark.parametrize("residual", [True, False])
def test_fused_v1_matches_pallas_v1(rng, residual):
    """The v1 binding vs the v1 Pallas kernel in interpret mode:
    test_pallas_conv.py's residual case (block_h 4), and without residual."""
    x = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, 8)) * .2).astype(np.float32)
    res = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
    one, zero = np.ones(8, np.float32), np.zeros(8, np.float32)
    r = res if residual else None
    want = pallas_v1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(one),
                     jnp.asarray(zero), None if r is None else jnp.asarray(r),
                     block_h=4, interpret=True)
    before = tfused.launches_v1
    got = tfused.fused_conv3x3_bn_relu(T(x), T(w), T(one), T(zero),
                                       None if r is None else T(r))
    assert tfused.launches_v1 == before  # CPU tensors run the plain version
    assert tfused.fused_conv3x3_bn_relu_reference is \
        tfused.fused_conv3x3_bn_relu_v2_reference
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_fused_plain_matches_pallas(rng, relu, residual):
    """The cases of tests/test_pallas_conv.py, against the Pallas kernel in
    interpret mode."""
    x = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    w = rng.standard_normal((3, 3, 8, 8)).astype(np.float32) * .2
    scale = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    res = (rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
           if residual else None)
    want = pallas_v2(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                     jnp.asarray(bias),
                     None if res is None else jnp.asarray(res),
                     relu=relu, block_h=8, interpret=True)
    before = tfused.launches
    got = tfused.fused_conv3x3_bn_relu_v2(
        T(x), T(w), T(scale), T(bias), None if res is None else T(res),
        relu=relu)
    assert tfused.launches == before  # CPU tensors run the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape,stride,transpose,dims,ok", [
    ((3, 3, 16, 16), 1, False, 2, True),
    ((3, 3, 512, 256), 1, False, 2, True),
    ((3, 3, 1, 16), 1, False, 2, False),     # stem: C = 1
    ((3, 3, 16, 3), 1, False, 2, False),     # head: Co = 3
    ((3, 3, 16, 32), 2, False, 2, False),    # down: stride 2
    ((3, 3, 32, 16), 2, True, 2, False),     # up: transpose
    ((1, 1, 32, 16), 1, False, 2, False),    # proj: 1x1
    ((3, 3, 24, 16), 1, False, 2, False),    # C not a multiple of 16
    ((3, 3, 3, 16, 16), 1, False, 3, False),  # 3D
])
def test_fused_eligible(shape, stride, transpose, dims, ok):
    assert fused_eligible(shape, dims=dims, stride=stride,
                          transpose=transpose) is ok


def test_fused_wrapper_rejects_bad_operands():
    x = torch.zeros(1, 4, 4, 16)
    w = torch.zeros(3, 3, 16, 16)
    one = torch.ones(16)
    with pytest.raises(ValueError, match="w must be"):
        tfused.fused_conv3x3_bn_relu_v2(x, torch.zeros(3, 3, 8, 16), one, one)
    with pytest.raises(TypeError, match="dtype"):
        tfused.fused_conv3x3_bn_relu_v2(x, w.bfloat16(), one, one)
    with pytest.raises(ValueError, match="scale"):
        tfused.fused_conv3x3_bn_relu_v2(x, w, one.double(), one)
    with pytest.raises(ValueError, match="residual"):
        tfused.fused_conv3x3_bn_relu_v2(x, w, one, one, torch.zeros(1, 4, 4, 8))
    # a tensor that is neither on the CPU nor on a card is refused, not
    # computed with the plain version
    with pytest.raises(ValueError, match="device"):
        tfused.fused_conv3x3_bn_relu_v2(x.to("meta"), w.to("meta"),
                                        one.to("meta"), one.to("meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "build").exists()


def test_build_hash_covers_headers(monkeypatch, tmp_path):
    """The library's name hashes the headers as well as the sources, so a
    changed csrc/*.cuh rebuilds instead of loading a stale library."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include "p.cuh"\n')
    (tmp_path / "p.cuh").write_text("// 1\n")
    first = build.library_path()
    assert build.library_path() == first
    (tmp_path / "p.cuh").write_text("// 2\n")
    assert build.library_path() != first


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """One nvcc per source (-c), all running at once, then one -shared
    link; the objects are removed, the compile logs and each command's
    wall seconds kept."""
    csrc, calls = tmp_path / "csrc", tmp_path / "calls.txt"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text("// kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'args="$*"; last=""\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; last="$1"; shift; done\n'
        'case "$args" in *" -c "*)\n'
        f'  echo "start $last" >> {calls}; sleep 0.5; echo "end $last" >> {calls}\n'
        '  echo "ptxas info: built $out" ;;\n'
        f'*) echo "$args" >> {calls} ;;\n'
        'esac\n'
        'touch "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    lib = build.build()
    srcs = [str(csrc / "a.cu"), str(csrc / "b.cu")]
    lines = calls.read_text().splitlines()
    # both compiles started before either ended
    assert sorted(lines[:2]) == [f"start {s}" for s in srcs]
    assert sorted(lines[2:4]) == [f"end {s}" for s in srcs]
    assert lines[4].startswith("-shared -o ") and len(lines) == 5
    assert lib.exists() and lib == build.library_path()
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        [lib.name, lib.name + ".log"])
    log = lib.with_suffix(".so.log").read_text()
    assert log.count("ptxas info") == 2
    assert [ln.split(":")[0] for ln in log.splitlines() if ln.startswith("nvcc ")] \
        == ["nvcc a.cu", "nvcc b.cu", "nvcc link"]
    assert build.build() == lib and len(calls.read_text().splitlines()) == 5


def test_build_failure_raises_and_leaves_nothing(monkeypatch, tmp_path):
    """A failed compile raises with nvcc's output and leaves no object,
    library or log behind."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text("// kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; last="$1"; shift; done\n'
        'touch "$out"\n'
        'case "$last" in *b.cu) echo "b.cu(1): error: broken"; exit 2 ;; esac\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    with pytest.raises(RuntimeError, match=r"nvcc failed \(2\)[\s\S]*error: broken"):
        build.build()
    assert list((tmp_path / "build").iterdir()) == []


def test_canonical_dtype():
    assert canonical_dtype("bfloat16") is torch.bfloat16
    assert canonical_dtype("float32") is torch.float32
    with pytest.raises(ValueError, match="unknown dtype"):
        canonical_dtype("float64")


@pytest.mark.parametrize("dtype,C,Co,kernel", [
    (torch.bfloat16, 16, 16, "tensor_core"),      # 512^2 level
    (torch.bfloat16, 512, 256, "tensor_core"),    # 32^2 level
    (torch.bfloat16, 32, 48, "tensor_core"),      # Co not a power of two
    (torch.float32, 64, 64, "f32_tensor_core"),   # f32: 3xTF32 tensor cores
    (torch.bfloat16, 24, 40, "tensor_core"),      # C not a multiple of 16: channel tails
    (torch.bfloat16, 16, 8, "tensor_core"),       # Co not a multiple of 16: channel tails
    (torch.float32, 16, 16, "f32_tensor_core"),   # the f32 forward's 512^2 level
    (torch.float32, 512, 512, "f32_tensor_core"),  # ... and its 16^2 level
    (torch.float32, 8, 8, "f32_tensor_core"),     # the TF32 MMA's depth
    (torch.float32, 24, 40, "f32_tensor_core"),   # multiples of 8, not of 16
    (torch.float32, 20, 36, "f32_tensor_core"),   # f32, C and Co ragged: channel tails
    (torch.float32, 12, 16, "f32_tensor_core"),   # f32, C not a multiple of 8
    (torch.float32, 16, 4, "f32_tensor_core"),    # f32, Co not a multiple of 8
    (torch.float16, 16, 16, "f16_tensor_core"),   # f16: the f16 MMA
    (torch.float16, 512, 256, "f16_tensor_core"),
    (torch.float16, 1, 16, "f16_tensor_core"),    # f16 stem width: rows of 2 bytes
    (torch.float16, 24, 40, "f16_tensor_core"),   # f16 channel tails
    (torch.float16, 16, 8, "f16_tensor_core"),
])
def test_kernel_choice_by_dtype_and_shape(dtype, C, Co, kernel):
    """Which kernel a CUDA call runs depends on the dtype alone: every C
    and Co goes to the dtype's tensor-core kernel."""
    assert tfused.kernel_for(dtype, C, Co) == kernel
    assert hasattr(tfused, f"launches_{kernel}")


def test_cpu_calls_count_no_kernel(rng):
    """CPU tensors run the plain version and leave every launch count
    alone, bf16, f16 and f32 alike."""
    def counts():
        return (tfused.launches, tfused.launches_v1, tfused.launches_tensor_core,
                tfused.launches_f16_tensor_core, tfused.launches_f32_tensor_core)

    before = counts()
    # operands a CUDA call sends to each of the three kernels, aligned and
    # with channel tails
    for dtype, C in ((torch.bfloat16, 16), (torch.float16, 16),
                     (torch.float32, 16), (torch.float32, 12),
                     (torch.float16, 3)):
        x = T(rng.standard_normal((1, 6, 5, C)).astype(np.float32)).to(dtype)
        w = T(rng.standard_normal((3, 3, C, 32)).astype(np.float32)).to(dtype)
        s, b = torch.ones(32), torch.zeros(32)
        y = tfused.fused_conv3x3_bn_relu_v2(x, w, s, b)
        y1 = tfused.fused_conv3x3_bn_relu(x, w, s, b)
        assert y.dtype == dtype and torch.equal(y, y1)
    assert counts() == before
