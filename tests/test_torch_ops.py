"""Port ops vs the JAX package on the CPU: conv / conv_transpose / eval BN,
the fused conv's plain version vs the Pallas kernel (interpret mode), the
kernel eligibility rule, the wrapper's input checks, and the kernel build.

Inputs are made with numpy from a seed and handed to both packages; f32
throughout, so the tolerances measure the algorithm, not rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uresnet_tpu.ops.conv import conv as jax_conv
from uresnet_tpu.ops.conv import conv_transpose as jax_conv_transpose
from uresnet_tpu.ops.norm import batch_norm as jax_batch_norm
from uresnet_tpu.ops.pallas.conv2d import fused_conv3x3_bn_relu_v2 as pallas_v2
from uresnet_tpu_torch.models.fold import fused_eligible
from uresnet_tpu_torch.ops import conv as tconv
from uresnet_tpu_torch.ops import norm as tnorm
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


def test_canonical_dtype():
    assert canonical_dtype("bfloat16") is torch.bfloat16
    assert canonical_dtype("float32") is torch.float32
    with pytest.raises(ValueError, match="unknown dtype"):
        canonical_dtype("float64")
