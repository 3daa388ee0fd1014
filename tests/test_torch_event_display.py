"""The port's event display (uresnet_tpu_torch/tools/event_display.py) and
the ``Trainer.forward`` it runs, against the JAX package on the CPU.

Checkpoints come from 2 iterations of the JAX ``cli.train`` at
tests/test_cli.py's tiny 2D and 3D configs in f32. The port's tool writes
the PNG (matplotlib), and its prediction on the same event equals the JAX
tool's: scores within 1e-5 of the max, labels equal to JAX's argmax
wherever JAX's top two scores differ by more than 1e-5. ``Trainer.forward``
is held to JAX's ``Trainer.forward`` on seeded, BN-warmed weights in 2D and
3D, packed and canonical, within 1e-5 of the max.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from uresnet_tpu.cli.train import main as jax_train_main
from uresnet_tpu.config import Config, DataConfig, ModelConfig, ParallelConfig
from uresnet_tpu.config import load_config as jax_load_config
from uresnet_tpu.data import events as jax_events
from uresnet_tpu.data.pipeline import densify_batch as jax_densify_batch
from uresnet_tpu.data.synthetic import generate_file
from uresnet_tpu.engine.trainer import Trainer as JaxTrainer
from uresnet_tpu.models.uresnet import uresnet_apply
from uresnet_tpu.parallel.mesh import make_mesh
from uresnet_tpu_torch import config as tconfig
from uresnet_tpu_torch.engine.trainer import Trainer
from uresnet_tpu_torch.models.convert import load_jax_params
from uresnet_tpu_torch.tools import event_display

TOL = 1e-5

# tests/test_cli.py's event-display configs: (events file shape, event, cfg)
CASES = {
    "2d": ((128, 128), 1,
           "model: {depth: 2, base_filters: 4, compute_dtype: float32}\n"),
    "3d": ((64, 64, 64), 0,
           "model: {dims: 3, depth: 2, base_filters: 4,"
           " compute_dtype: float32}\n"),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def trained(request, tmp_path_factory):
    """(config path, events file, event index, overrides) of a JAX run of
    2 iterations with a checkpoint at step 2."""
    name = request.param
    shape, event, model = CASES[name]
    tmp = tmp_path_factory.mktemp(f"display_{name}")
    path = generate_file(str(tmp / "d.usef"), 2, seed=5 if name == "2d" else 6,
                         shape=shape, planes=(0,))
    cfg = str(tmp / "cfg.yaml")
    with open(cfg, "w") as f:
        f.write(model +
                "data: {image_size: 32, batch_size: 1, planes: [0]}\n"
                "parallel: {data: 1}\n"
                f"train: {{checkpoint_dir: {tmp}/ck, iterations: 2,\n"
                f"  summary_iter: 2, checkpoint_iter: 2, val_iter: 0,\n"
                f"  log_dir: {tmp}/lg}}\n")
    overrides = [f"data.input_files={path}", "data.synthetic=false"]
    assert jax_train_main([cfg, *overrides]) == 0
    return name, cfg, path, event, overrides


def test_event_display_writes_png(trained, tmp_path):
    pytest.importorskip("matplotlib")
    name, cfg, path, event, overrides = trained
    out = str(tmp_path / f"disp_{name}.png")
    rc = event_display.main([cfg, *overrides, "--input", path,
                             "--event", str(event), "--out", out,
                             "--device", "cpu"])
    assert not rc
    assert os.path.exists(out) and os.path.getsize(out) > 1000


def test_event_display_prediction_matches_jax(trained):
    """The port's restore-densify-forward of one event against the JAX
    tool's lines (tools/event_display.py: restore, densify_batch with
    weight_mode 'ones', Trainer.forward, argmax)."""
    name, cfg_path, path, event, overrides = trained
    cfg = tconfig.load_config(cfg_path, overrides)
    data, label, pred, scores, step = event_display.predict(
        cfg, path, event, 0, device="cpu")

    jcfg = jax_load_config(cfg_path, overrides)
    jt = JaxTrainer(jcfg, mesh=make_mesh(1))
    jts, jstep, _ = jt.restore(None)
    batch = jax_densify_batch(jax_events.read_events(path, [event]),
                              image_size=jcfg.data.image_size, planes=(0,),
                              normalize_scale=jcfg.data.normalize_scale,
                              normalize_clip=jcfg.data.normalize_clip,
                              weight_mode="ones",
                              num_class=jcfg.model.num_class)
    want = np.asarray(jt.forward(jts, batch["data"]))[0]

    assert step == jstep == 2
    np.testing.assert_array_equal(data, batch["data"][0, ..., 0])
    np.testing.assert_array_equal(label, batch["label"][0])
    assert scores.dtype == np.float32 and scores.shape == want.shape
    assert (data > 0).any()
    np.testing.assert_allclose(scores, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > TOL
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(pred[decided], want.argmax(-1)[decided])


@pytest.mark.parametrize("pack", [False, True], ids=["canonical", "packed"])
@pytest.mark.parametrize("dims", [2, 3])
def test_trainer_forward_matches_jax(dims, pack):
    """Trainer.forward (the unfolded eval forward + softmax) against the
    JAX Trainer.forward on the same weights and BN state."""
    size = 16
    jcfg = Config(model=ModelConfig(dims=dims, depth=2, base_filters=4,
                                    compute_dtype="float32", pack=pack,
                                    pack_extra_h=pack),
                  data=DataConfig(image_size=size, batch_size=2, planes=(0,)),
                  parallel=ParallelConfig(data=1))
    rng = np.random.default_rng(11 + dims)
    shape = (2,) + (size,) * dims + (1,)
    jt = JaxTrainer(jcfg, mesh=make_mesh(1))
    jts = jt.init_state()
    params = jax.device_get(jts.params)
    # one JAX train forward moves the BN running stats off their init
    _, state = jax.jit(lambda p, s, x: uresnet_apply(
        p, s, x, cfg=dataclasses.replace(jcfg.model, pack=False),
        train=True))(params, jts.model_state,
                     rng.uniform(0, 1, shape).astype(np.float32))
    state = jax.device_get(state)
    jts = jts._replace(model_state=state)
    x = (rng.uniform(0, 1, shape) * (rng.uniform(0, 1, shape) > 0.5)
         ).astype(np.float32)
    want = np.asarray(jt.forward(jts, x))

    tcfg = tconfig.Config(
        model=tconfig.ModelConfig(**dataclasses.asdict(jcfg.model)),
        data=tconfig.DataConfig(image_size=size, batch_size=2, planes=(0,)),
        parallel=tconfig.ParallelConfig(data=1))
    tr = Trainer(tcfg, device="cpu")
    ts = tr.init_state()
    load_jax_params(ts.model, params, state)
    got = tr.forward(ts, x)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())
    # a tensor input gives the same scores
    torch.testing.assert_close(tr.forward(ts, torch.from_numpy(x)), got,
                               rtol=0, atol=0)
