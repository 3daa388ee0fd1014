"""The train-BN roofline reader (metrics/bn_train_roofline.train.py) on a
hand-made trace: the BatchNorm layers it reckons from the configuration
are those the port's train step runs, the least bytes of each call, the
share of the kernels' device time, and nothing read where calls, kernels
and the configuration's layers disagree."""

import pytest
import torch

from harness import loops, spec, trace

OPS = {"bn_train_stats": 10.0, "bn_train_apply": 20.0,
       "bn_train_grad_reduce": 30.0, "bn_train_grad_input": 40.0}  # us
MODEL = {"dims": 2, "depth": 1, "base_filters": 4, "blocks_per_level": 1}
SIZE, BATCH, STEPS = 8, 2, 2


def _layers(*args):
    """bn_layers of the reader's module."""
    read = spec.metric_reader("bn_train_roofline.train")
    return read.__globals__["bn_layers"](*args)


def _run(calls=None, kernels=None, kind="train"):
    """A window of STEPS steps of MODEL's 9 BatchNorm layers: ``calls``
    and ``kernels`` of each op (default 9 * STEPS)."""
    n = 9 * STEPS
    calls = n if calls is None else calls
    kernels = n if kernels is None else kernels
    host, device, i = [], [], 0
    for name, us in OPS.items():
        for _ in range(calls):
            i += 1
            host.append(trace.Op(f"uresnet_tpu_torch::{name}", i, 100 * i,
                                 100 * i + 5, [], False))
        for k in range(kernels):
            device.append((f"void {name}_kernel<bf16, 8>", 1000 * k,
                           1000 * k + us, 0))
    t = trace.Trace(device=device, host=host, window=(0, 10000))
    return loops.Traced(kind, t, 1e-3, STEPS, BATCH, SIZE, MODEL, 2, 0)


@pytest.mark.parametrize("cell, n", [("train_2d_512", 55),
                                     ("train_3d_192", 45)])
def test_the_training_cells_have_their_layers(cell, n):
    c = spec.cell(cell)
    assert len(_layers(c.config["model"], c.config["data"]["image_size"],
                       c.config["data"]["batch_size"])) == n


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("dims", [2, 3])
def test_layers_are_the_train_steps_batch_norm_calls(monkeypatch, dims,
                                                     pack):
    """Each train BN call of the port's forward, canonical and packed:
    elements, channels and residual, as the configuration reckons them."""
    from uresnet_tpu_torch.config import ModelConfig
    from uresnet_tpu_torch.models import blocks
    from uresnet_tpu_torch.models.uresnet import UResNet

    cfg = ModelConfig(dims=dims, depth=2, base_filters=4, blocks_per_level=2,
                      compute_dtype="float32", pack=pack, pack_threshold=4)
    model = UResNet(cfg, generator=torch.Generator().manual_seed(0))
    seen, inner = [], blocks.batch_norm_train

    def hook(x, params, state, **kw):
        seen.append((x.numel(), params["scale"].shape[0],
                     kw.get("residual") is not None))
        assert kw.get("relu")
        return inner(x, params, state, **kw)

    monkeypatch.setattr(blocks, "batch_norm_train", hook)
    S, B = 16, 2
    model(torch.rand((B,) + (S,) * dims + (1,)), train=True)
    assert sorted(seen) == sorted(_layers(
        {"dims": dims, "depth": 2, "base_filters": 4,
         "blocks_per_level": 2}, S, B))


def test_reads_the_least_bytes_over_the_kernels_time():
    read = spec.metric_reader("bn_train_roofline.train")
    # stem 8^2x4, enc0's block (the second conv + residual), down 4^2x8,
    # mid's block, up 8^2x4, dec0's block
    layers = [(2 * 64 * 4, 4, False),
              (2 * 64 * 4, 4, False), (2 * 64 * 4, 4, True),
              (2 * 16 * 8, 8, False),
              (2 * 16 * 8, 8, False), (2 * 16 * 8, 8, True),
              (2 * 64 * 4, 4, False),
              (2 * 64 * 4, 4, False), (2 * 64 * 4, 4, True)]
    assert _layers(MODEL, SIZE, BATCH) == layers

    def least(n, C, res):
        act = 2 * n
        return (act + 4 * (9 * C + 1)
                + act * (2 + res) + 16 * C
                + act * (2 + res) + 24 * C
                + act * (3 + 2 * res) + 24 * C + 4)

    want = (STEPS * sum(least(*l) for l in layers) / 3.35e12
            / (9 * STEPS * sum(OPS.values()) / 1e6) * 100)
    assert read(_run()) == pytest.approx(want, rel=1e-12)


def test_reads_nothing_where_calls_kernels_and_layers_disagree():
    read = spec.metric_reader("bn_train_roofline.train")
    assert read(_run(kernels=9 * STEPS - 1)) is None
    assert read(_run(calls=9 * STEPS + 1, kernels=9 * STEPS + 1)) is None
    assert read(_run(calls=0, kernels=0)) is None
    assert read(_run(kind="ana")) is None
