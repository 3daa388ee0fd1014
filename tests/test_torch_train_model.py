"""The port's train-mode forward and backward vs the JAX package on the CPU:
logits, new BN state and every per-leaf gradient of the weighted loss
against ``uresnet_apply`` under ``jax.grad``, and the three remat modes.

f32, depth 2, base 4, 32x32, batch 2: the JAX-initialised params are
carried across with ``load_jax_params``; tolerance 1e-4 (relative to each
leaf's largest gradient for the gradients).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from uresnet_tpu.config import ModelConfig
from uresnet_tpu.engine.losses import weighted_softmax_xent as jax_xent
from uresnet_tpu.models.uresnet import uresnet_apply, uresnet_init
from uresnet_tpu_torch.engine.losses import weighted_softmax_xent
from uresnet_tpu_torch.models.convert import flatten_tree, load_jax_params
from uresnet_tpu_torch.models.uresnet import UResNet

CFG = ModelConfig(depth=2, base_filters=4, num_class=3, compute_dtype="float32")
TOL = 1e-4


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    params, state = uresnet_init(jax.random.PRNGKey(7), CFG)
    # a dense input: on a mostly empty image some channels' batch variance
    # is a small difference of large moments (E[x^2] - E[x]^2), and f32
    # sums taken in another order differ there by more than the tolerance
    x = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    label = rng.integers(0, 3, (2, 32, 32)).astype(np.int32)
    weight = rng.uniform(0.2, 3, (2, 32, 32)).astype(np.float32)

    def loss_fn(p):
        logits, new_state = uresnet_apply(p, state, x, cfg=CFG, train=True)
        return jax_xent(logits, label, weight), (logits, new_state)

    (loss, (logits, new_state)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    want = jax.device_get({"loss": loss, "logits": logits, "state": new_state,
                           "grads": grads})
    return jax.device_get((params, state)), (x, label, weight), want


def _port_step(case, remat):
    (params, state), (x, label, weight), _ = case
    model = UResNet(dataclasses.replace(CFG, remat=remat),
                    generator=torch.Generator().manual_seed(0))
    load_jax_params(model, params, state)
    logits, new_state = model(torch.from_numpy(x), train=True)
    loss = weighted_softmax_xent(logits, torch.from_numpy(label),
                                 torch.from_numpy(weight))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return model, loss, logits, new_state, grads


def test_train_forward_and_grads_match_jax(case):
    _, _, want = case
    model, loss, logits, new_state, grads = _port_step(case, False)
    assert abs(loss.item() - float(want["loss"])) <= TOL * abs(float(want["loss"]))
    np.testing.assert_allclose(logits.detach().numpy(), want["logits"],
                               rtol=TOL, atol=TOL)
    got_s, want_s = flatten_tree(new_state), flatten_tree(want["state"])
    assert got_s.keys() == want_s.keys()
    for k in want_s:
        np.testing.assert_allclose(got_s[k].numpy(), want_s[k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    want_g = flatten_tree(want["grads"])
    assert grads.keys() == want_g.keys()
    for k, g in want_g.items():
        scale = max(np.abs(g).max(), 1e-12)
        np.testing.assert_allclose(grads[k].numpy() / scale, g / scale,
                                   rtol=0, atol=TOL, err_msg=k)
    # the forward wrote no buffer: the running stats are still the loaded ones
    (_, state), _, _ = case
    np.testing.assert_array_equal(model.stem.bn.mean.numpy(),
                                  state["stem"]["bn"]["mean"])


@pytest.mark.parametrize("remat", ["level", "block"])
def test_remat_identical(case, remat):
    """Checkpointing reruns the forward in the backward: grads and the new
    BN state are bit-identical to no remat, and the momentum step is taken
    once (the buffers are not written)."""
    model0, _, _, state0, grads0 = _port_step(case, False)
    model, _, _, state, grads = _port_step(case, remat)
    for k in grads0:
        torch.testing.assert_close(grads[k], grads0[k], rtol=0, atol=0)
    s0, s = flatten_tree(state0), flatten_tree(state)
    for k in s0:
        torch.testing.assert_close(s[k], s0[k], rtol=0, atol=0)
    for (k, b), (_, b0) in zip(model.named_buffers(), model0.named_buffers()):
        torch.testing.assert_close(b, b0, rtol=0, atol=0)
