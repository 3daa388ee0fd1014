"""float16 compute in the port vs the JAX package on the CPU.

The JAX package's Pallas conv is dtype-generic, so a
``model.compute_dtype: float16`` config serves there; the port's fused conv
op takes float16 too (ops/cuda/conv2d.py, the f16 tensor-core kernel on the
card, the plain version here). A tiny f16 config (depth 2, base 16, 32^2)
with JAX-initialised weights, carried across by ``load_jax_params``, goes
through the port's serving function (fused backend and cuDNN composition),
the JAX serving function, ``evaluate_dataset`` and a ``.uxm`` round trip.

Tolerances: whole f16 forwards round at different places over ~20 convs,
so they are compared as the card's whole bf16 forwards are (chip_smoke.py):
max softmax difference 0.05, argmax agreement 98% of pixels. The fused
conv's plain version against the Pallas kernel in f16: one f16 ulp of the
output (2^-10 relative; both round the same f32 sum once) plus 1e-3 of the
max for f32 summation-order differences near zero.
"""

import json

import jax
import numpy as np
import pytest
import torch

from test_export import trained_ish_tree
from uresnet_tpu.config import Config, DataConfig, ModelConfig
from uresnet_tpu.engine import export as jexport
from uresnet_tpu.ops.pallas.conv2d import fused_conv3x3_bn_relu_v2 as pallas_v2
from uresnet_tpu_torch.config import load_config
from uresnet_tpu_torch.data.events import read_events
from uresnet_tpu_torch.data.pipeline import densify_batch
from uresnet_tpu_torch.data.synthetic import generate_file
from uresnet_tpu_torch.engine import evaluator as tevl
from uresnet_tpu_torch.engine import export as texport
from uresnet_tpu_torch.engine.metrics import (metrics_from_counts,
                                              reduce_counts,
                                              segmentation_counts)
from uresnet_tpu_torch.engine.trainer import Trainer
from uresnet_tpu_torch.models.convert import load_jax_params
from uresnet_tpu_torch.models.uresnet import UResNet
from uresnet_tpu_torch.ops.cuda import conv2d as tfused

MAX_SOFTMAX_DIFF, MIN_AGREE = 0.05, 0.98
F16_REL, F16_SLACK = 2.0 ** -10, 1e-3
S, N_EVENTS = 32, 4


def f16_cfg(tmp_path, backend="auto", files=()):
    """The JAX config and its port twin (loaded from the same JSON)."""
    cfg = Config(model=ModelConfig(depth=2, base_filters=16, num_class=3,
                                   compute_dtype="float16",
                                   kernel_backend=backend),
                 data=DataConfig(image_size=S, batch_size=N_EVENTS,
                                 planes=(0,), input_files=tuple(files),
                                 synthetic=False, random_access=False,
                                 num_threads=1))
    path = tmp_path / f"cfg_{backend}.json"
    path.write_text(json.dumps(cfg.to_dict()))
    return cfg, load_config(str(path))


@pytest.fixture(scope="module")
def tree():
    cfg = Config(model=ModelConfig(depth=2, base_filters=16, num_class=3,
                                   compute_dtype="float16"))
    return trained_ish_tree(cfg, seed=7)


def port_model(pcfg, tree):
    model = UResNet(pcfg.model, generator=torch.Generator().manual_seed(0))
    load_jax_params(model, *tree)
    return model


def inputs(n=2, seed=3):
    x = np.random.default_rng(seed).random((n, S, S, 1)).astype(np.float32)
    return x * (x > 0.7)  # sparse, as events are


def agreement(got, want):
    """(max softmax difference, argmax agreement), printed, then held."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = float(np.abs(got - want).max())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"max softmax diff {d:.3e} (limit {MAX_SOFTMAX_DIFF}), argmax "
          f"agreement {agree:.5f} (min {MIN_AGREE})")
    assert d <= MAX_SOFTMAX_DIFF and agree >= MIN_AGREE
    return d, agree


def test_f16_serving_matches_xla_and_jax(tmp_path, tree):
    """The f16 folded forward under kernel_backend 'auto' (through the
    fused conv op) serves, and equals the 'xla' composition and the JAX
    package's build_serving_fn on the same weights."""
    jcfg, pcfg = f16_cfg(tmp_path)
    _, pcfg_xla = f16_cfg(tmp_path, backend="xla")
    model = port_model(pcfg, tree)
    x = inputs()
    before = tfused.launches
    got = texport.build_serving_fn(pcfg, model)(torch.from_numpy(x))
    assert tfused.launches == before  # CPU tensors run the plain version
    assert got.dtype == torch.float32 and got.shape == (2, S, S, 3)
    assert torch.isfinite(got).all()
    xla = texport.build_serving_fn(pcfg_xla, model)(torch.from_numpy(x))
    agreement(got.numpy(), xla.numpy())
    params, state = tree
    want = jexport.build_serving_fn(jcfg, params, state)(x)
    agreement(got.numpy(), jax.device_get(want))


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("C", [8, 16])
def test_f16_plain_matches_pallas(rng, C, relu, residual):
    """The plain version in f16 against the Pallas kernel in interpret mode
    in f16, at test_fused_plain_matches_pallas's shapes (C = 8) and at
    C = 16."""
    x = rng.standard_normal((2, 16, 8, C)).astype(np.float16)
    w = (rng.standard_normal((3, 3, C, C)) * .2).astype(np.float16)
    scale = rng.uniform(0.5, 2.0, C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    res = (rng.standard_normal((2, 16, 8, C)).astype(np.float16)
           if residual else None)
    want = pallas_v2(x, w, scale, bias, res, relu=relu, block_h=8,
                     interpret=True)
    want = np.asarray(want)
    assert want.dtype == np.float16
    T = torch.from_numpy
    got = tfused.fused_conv3x3_bn_relu_v2(
        T(x), T(w), T(scale), T(bias), None if res is None else T(res),
        relu=relu)
    assert got.dtype == torch.float16
    got, want = got.float().numpy(), want.astype(np.float32)
    err = np.abs(got - want)
    limit = F16_REL * np.abs(want) + F16_SLACK * np.abs(want).max()
    print(f"max abs err {err.max():.3e}, max |want| {np.abs(want).max():.3e}")
    assert (err <= limit).all()


def test_f16_evaluate_dataset_is_the_serving_forward(tmp_path, tree):
    """An f16 evaluate_dataset (the --metrics-only pass) counts the
    argmax of build_serving_fn's scores on the same dense events."""
    path = generate_file(str(tmp_path / "ev.usef"), N_EVENTS, seed=11,
                         shape=(S, S), planes=(0,))
    _, pcfg = f16_cfg(tmp_path, files=(path,))
    tr = Trainer(pcfg, device="cpu")
    ts = tr.init_state()
    load_jax_params(ts.model, *tree)
    got = tevl.evaluate_dataset(tr, ts)

    d = pcfg.data
    dense = densify_batch(read_events(path), image_size=S, planes=d.planes,
                          normalize_scale=d.normalize_scale,
                          normalize_clip=d.normalize_clip,
                          weight_mode=d.weight_mode,
                          num_class=pcfg.model.num_class)
    data = torch.from_numpy(dense["data"])
    scores = texport.build_serving_fn(pcfg, ts.model)(data)
    # log is monotonic: the same argmax, ties included, as the logits'
    counts = segmentation_counts(torch.log(scores),
                                 torch.from_numpy(dense["label"]), data,
                                 num_class=pcfg.model.num_class)
    want = metrics_from_counts(reduce_counts(counts))
    assert got["n_events"] == N_EVENTS
    assert got["n_pixels"] == N_EVENTS * S * S
    for k in ("acc_all", "acc_nonzero", "miou"):
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


def test_f16_uxm_roundtrip(tmp_path, tree):
    """An f16 .uxm (the fused conv op in its graph) loads and serves
    build_serving_fn's scores."""
    _, pcfg = f16_cfg(tmp_path)
    model = port_model(pcfg, tree)
    payload, meta = texport.export_serving(pcfg, model, batch_size=2)
    path = str(tmp_path / "f16.uxm")
    texport.save_serving(path, payload, meta)
    fn, meta2 = texport.load_serving(path, device="cpu")
    assert meta2["model"]["compute_dtype"] == "float16"
    x = inputs()
    got = fn(x)
    want = texport.build_serving_fn(pcfg, model)(torch.from_numpy(x))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
