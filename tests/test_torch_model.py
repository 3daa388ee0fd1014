"""Port model vs the JAX package on the CPU: the UResNet eval forward, the
BN fold and the folded forward (both kernel backends), and the kernel
dispatch count at the flagship widths.

JAX-initialised params, with BN running stats warmed by one JAX train-mode
forward so folding is non-trivial, are carried across by
``load_jax_params``; f32 throughout, at the tolerance of tests/test_fold.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from uresnet_tpu.config import ModelConfig
from uresnet_tpu.models.fold import fold_batchnorm as jax_fold
from uresnet_tpu.models.fold import uresnet_apply_folded as jax_apply_folded
from uresnet_tpu.models.uresnet import uresnet_apply, uresnet_init
from uresnet_tpu_torch.models import fold
from uresnet_tpu_torch.models.convert import jax_params, load_jax_params, trees
from uresnet_tpu_torch.models.uresnet import UResNet
from uresnet_tpu_torch.ops.cuda import conv2d as tfused

CFG = ModelConfig(depth=2, base_filters=16, num_class=3,
                  compute_dtype="float32")


@pytest.fixture(scope="module")
def pair():
    """(JAX params, warmed JAX state, port model loaded with both, input)."""
    rng = np.random.default_rng(5)
    params, state = uresnet_init(jax.random.PRNGKey(3), CFG)
    x_warm = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    _, state = uresnet_apply(params, state, x_warm, cfg=CFG, train=True)
    params, state = jax.device_get((params, state))
    model = UResNet(CFG, generator=torch.Generator().manual_seed(0))
    load_jax_params(model, params, state)
    x = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    return params, state, model, x


def test_eval_forward_matches_jax(pair):
    params, state, model, x = pair
    want, _ = uresnet_apply(params, state, x, cfg=CFG, train=False)
    with torch.no_grad():
        got, got_state = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # eval mode hands back the running stats themselves
    assert got_state["stem"]["bn"]["mean"] is model.stem.bn.mean


def test_jax_params_roundtrip(pair):
    params, state, model, _ = pair
    p2, s2 = jax_params(model)
    flat = jax.tree_util.tree_leaves_with_path
    assert ([k for k, _ in flat(p2)], [k for k, _ in flat(s2)]) == \
        ([k for k, _ in flat(params)], [k for k, _ in flat(state)])
    for a, b in zip(jax.tree.leaves((p2, s2)), jax.tree.leaves((params, state))):
        np.testing.assert_array_equal(a, b)


def test_load_jax_params_rejects_mismatch(pair):
    params, state, model, _ = pair
    bad = dict(params)
    del bad["head"]
    with pytest.raises(KeyError, match="head"):
        load_jax_params(model, bad, state)
    bad = dict(params, head={"w": np.zeros((3, 3, 16, 4), np.float32),
                             "b": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, bad, state)


def test_fold_matches_jax(pair):
    params, state, model, _ = pair
    want = jax.device_get(jax_fold(params, state, CFG))
    with torch.no_grad():
        got = fold.fold_batchnorm(*trees(model), CFG)
    got_leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got))
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [k for k, _ in got_leaves] == [k for k, _ in want_leaves]
    for (_, a), (_, b) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_folded_forward_matches_jax(pair, backend):
    params, state, model, x = pair
    want = jax_apply_folded(jax_fold(params, state, CFG), x, cfg=CFG)
    cfg = dataclasses.replace(CFG, kernel_backend=backend)
    with torch.no_grad():
        got = fold.uresnet_apply_folded(
            fold.fold_batchnorm(*trees(model), cfg), torch.from_numpy(x),
            cfg=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("backend,calls", [("auto", 44), ("pallas", 44),
                                           ("xla", 0)])
def test_flagship_dispatch_count(monkeypatch, backend, calls):
    """At the flagship widths (base 16, depth 5, 2 blocks per level) every
    residual-block conv is eligible: 2 convs x 2 blocks x 11 stages = 44
    fused calls per forward; none under the 'xla' backend."""
    cfg = ModelConfig(base_filters=16, depth=5, blocks_per_level=2,
                      num_class=3, compute_dtype="float32",
                      kernel_backend=backend)
    model = UResNet(cfg, generator=torch.Generator().manual_seed(1))
    seen = []
    real = fold.fused_conv3x3_bn_relu_v2

    def counting(x, w, *a, **kw):
        seen.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w, *a, **kw)

    monkeypatch.setattr(fold, "fused_conv3x3_bn_relu_v2", counting)
    launches = tfused.launches
    with torch.no_grad():
        out = fold.uresnet_apply_folded(fold.fold_batchnorm(*trees(model), cfg),
                                        torch.rand(1, 32, 32, 1), cfg=cfg)
    assert out.shape == (1, 32, 32, 3)
    assert len(seen) == calls
    assert tfused.launches == launches  # CPU: no kernel launches
    if calls:
        assert {w[2:] for _, w in seen} == (
            {(16 * 2 ** l, 16 * 2 ** l) for l in range(6)}
            | {(32 * 2 ** l, 16 * 2 ** l) for l in range(5)})


def test_kernel_backend_validated(pair):
    _, _, model, x = pair
    cfg = dataclasses.replace(CFG, kernel_backend="cuda")
    with pytest.raises(ValueError, match="kernel_backend"):
        fold.uresnet_apply_folded(fold.fold_batchnorm(*trees(model), cfg),
                                  torch.from_numpy(x), cfg=cfg)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_kernel_operands_made_once(pair, compute_dtype):
    """The serving function's ready-made kernel operands are in the form the
    kernel takes and give the same forward as operands made per call."""
    _, _, model, x = pair
    cfg = dataclasses.replace(CFG, compute_dtype=compute_dtype)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        folded = fold.fold_batchnorm(*trees(model), cfg)
        ready = fold.kernel_operands(folded, cfg)
        unit = ready["enc0_b0"]["cb2"]
        assert unit["w"].dtype == getattr(torch, compute_dtype)
        assert unit["w"].is_contiguous() and unit["b"].dtype == torch.float32
        assert unit["scale"].dtype == torch.float32 and bool((unit["scale"] == 1).all())
        assert ready["stem"] is folded["stem"]  # C = 1: not eligible
        assert fold.kernel_operands(
            folded, dataclasses.replace(cfg, kernel_backend="xla")) is folded
        want = fold.uresnet_apply_folded(folded, xt, cfg=cfg)
        got = fold.uresnet_apply_folded(ready, xt, cfg=cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
