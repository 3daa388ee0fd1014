"""Checkpoints shared by both packages: a JAX train-state checkpoint served
by the port, a bf16-kernel release artifact, and the port's save read back
by the JAX loader."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uresnet_tpu.config import ModelConfig
from uresnet_tpu.engine.checkpoint import load_checkpoint
from uresnet_tpu.engine.checkpoint import save_checkpoint as jax_save
from uresnet_tpu.engine.optim import adam_init
from uresnet_tpu.engine.trainer import TrainState
from uresnet_tpu.models.uresnet import uresnet_apply, uresnet_init
from uresnet_tpu_torch.engine import checkpoint as tckpt
from uresnet_tpu_torch.models.convert import jax_params, load_jax_params
from uresnet_tpu_torch.models.uresnet import UResNet

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from make_release_ckpt import strip  # noqa: E402

CFG = ModelConfig(depth=2, base_filters=4, num_class=3,
                  compute_dtype="float32")


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX training checkpoint (params, warmed BN stats, Adam, PRNG key)."""
    tmp = tmp_path_factory.mktemp("ck")
    params, state = uresnet_init(jax.random.PRNGKey(4), CFG)
    x = np.random.default_rng(2).uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    _, state = uresnet_apply(params, state, x, cfg=CFG, train=True)
    ts = TrainState(params=params, model_state=state, opt=adam_init(params),
                    key=jax.random.PRNGKey(9))
    tree = {"train_state": jax.device_get(ts),
            "meta": {"step": np.int64(42), "data_cursor": np.int64(8)}}
    path = jax_save(str(tmp / "ckpt"), 42, tree)
    return path, jax.device_get(ts), x, tmp


def _port_model(path):
    params, state, step = tckpt.load_serving_state(path)
    model = UResNet(CFG, generator=torch.Generator().manual_seed(0))
    load_jax_params(model, params, state)
    return model, step


def test_jax_checkpoint_served_by_port(jax_ckpt):
    path, ts, x, _ = jax_ckpt
    assert tckpt.latest_checkpoint(os.path.dirname(path)) == path
    assert tckpt.checkpoint_step(path) == 42
    model, step = _port_model(path)
    assert step == 42
    want, _ = uresnet_apply(ts.params, ts.model_state, x, cfg=CFG, train=False)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_release_bf16_manifest(jax_ckpt):
    """Kernels stored as uint16 bf16 bit patterns (tools/make_release_ckpt.py)
    load as the bf16-rounded f32 kernels, exactly as the JAX loader does."""
    path, ts, _, tmp = jax_ckpt
    rel = str(tmp / "release.npz")
    strip(path, rel, kernels_dtype="bfloat16")
    with np.load(rel) as z:
        assert "__kernels_bf16__" in z.files
    model, step = _port_model(rel)
    assert step == 42
    template = {"train_state": ts,
                "meta": {"step": np.int64(0), "data_cursor": np.int64(0)}}
    want = load_checkpoint(rel, template, partial=True)["train_state"]
    got_p, got_s = jax_params(model)
    for a, b in zip(jax.tree.leaves((got_p, got_s)),
                    jax.tree.leaves((want.params, want.model_state))):
        np.testing.assert_array_equal(a, b)
    w = ts.params["enc0_b0"]["cb1"]["conv"]["w"]
    bf = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got_p["enc0_b0"]["cb1"]["conv"]["w"], bf)
    assert not np.array_equal(bf, w)  # the rounding really happened


def test_port_save_read_by_jax(jax_ckpt, tmp_path):
    _, ts, _, _ = jax_ckpt
    model = UResNet(CFG, generator=torch.Generator().manual_seed(6))
    params, state = jax_params(model)
    last = tckpt.MAX_TO_KEEP + 1
    for step in range(1, last + 1):
        path = tckpt.save_checkpoint(str(tmp_path), step,
                                     tckpt.train_state_tree(params, state, step))
    assert tckpt.latest_checkpoint(str(tmp_path)) == path
    assert sorted(os.listdir(tmp_path)) == ["LATEST"] + [
        f"step_{s:08d}.npz" for s in range(2, last + 1)]
    template = {"train_state": ts,
                "meta": {"step": np.int64(0), "data_cursor": np.int64(0)}}
    got = load_checkpoint(path, template, partial=True)
    assert int(got["meta"]["step"]) == last
    for a, b in zip(jax.tree.leaves((got["train_state"].params,
                                     got["train_state"].model_state)),
                    jax.tree.leaves((params, state))):
        np.testing.assert_array_equal(a, b)
    # optimizer and PRNG leaves are not written: the template fills them
    np.testing.assert_array_equal(got["train_state"].key, ts.key)
