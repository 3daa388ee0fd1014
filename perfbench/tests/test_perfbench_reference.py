"""The plain reference against the program on the CPU at a small size,
in float32: densify, the eval, train and BN-folded forwards, and the
harness's comparison of whole training and analysis runs."""

import time

import numpy as np
import pytest
import torch

import small
from harness import events, loops, reference, weights
from uresnet_tpu_torch.data.device_pipeline import (crop_origin,
                                                    densify_on_device)
from uresnet_tpu_torch.engine.export import build_logits_fn

CELLS = ["train_2d_512", "train_3d_192", "serve_2d_512", "serve_3d_192"]


@pytest.mark.parametrize("mode", ["class_balance", "ones"])
@pytest.mark.parametrize("shape,size", [((48, 40), 32), ((20, 20, 20), 16)])
def test_densify_equals_the_programs(mode, shape, size):
    batch = events.make_pool(5, batches=1, batch_size=3, shape=shape,
                             max_points=600)[0]
    batch["npoints"][2] = 0  # an empty row: the image centre
    ref = reference.densify(batch, size=size, scale=0.01, clip=10.0,
                            weight_mode=mode, num_class=3)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = densify_on_device(t, image_size=size, num_class=3, weight_mode=mode)
    for k in ("data", "label", "weight"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    np.testing.assert_array_equal(crop_origin(t, image_size=size).numpy(),
                                  ref["origin"])


@pytest.mark.parametrize("name", ["serve_2d_512", "serve_3d_192"])
def test_forwards_equal_the_programs(name):
    cell = small.cell(name, compute_dtype="float32")
    m = cell.model
    pool = loops._pool(cell, 3)
    view = loops._view(cell, pool[0], "ones")
    x = view["data"]
    leaves = weights.make(cell, 3, "cpu", serve=True)
    cell.arch.calibrate(cell.config, leaves, view, device="cpu")
    params, stats = weights.split(cell, leaves)
    prog = loops.Program(cell, leaves, "cpu")
    xt = torch.from_numpy(x)
    with torch.no_grad(), reference.true_f32():
        want = reference.forward(params, stats, xt, m, mode="eval")
        train = reference.forward(params, stats, xt, m, mode="train")
        got, _ = prog.state.model(xt, train=False)
        got_train, _ = prog.state.model(xt, train=True)
    folded = build_logits_fn(prog.cfg, prog.state.model)(xt)
    scale = want.abs().max()
    for g, w in ((got, want), (folded, want), (got_train, train)):
        assert float((g - w).abs().max()) <= 1e-5 * float(scale)


@pytest.mark.parametrize("name", CELLS)
def test_whole_runs_agree_in_float32(name):
    """The harness's numbers for the program in float32 agree with the
    reference to float32 round-off. One training step: later Adam steps
    turn the round-off of near-zero gradients into sign flips. The 3D
    volume is nearly empty, and its BN-bias gradients are sums of terms
    that cancel: their order alone moves them by up to ~2%, and elements
    of Adam's first step whose gradient is near its eps move with them."""
    cell = small.cell(name, compute_dtype="float32")
    cell.mix["check_steps"] = 1
    if cell.model["dims"] == 3:
        cell.config["model"]["head_dtype"] = ""
    res = loops.run(cell, 2 ** 31 + 17, 0.2, False, "cpu", time.perf_counter())
    n = res["numbers"]
    if cell.mix["loop"] == "train":
        flat = cell.model["dims"] == 2
        assert max(res["detail"]["loss_gaps"]) < 1e-5
        assert res["detail"]["logit_rel_err"] < 1e-5
        assert n["logit_err"] < 1e-3  # of bf16's rounding's
        assert n["grad_gap"] < (1e-4 if flat else 0.03)
        assert n["change_gap"] < (1e-4 if flat else 0.01)
    else:
        assert n["logit_gap"] < 1e-5 and n["exact_mismatch"] == 0
