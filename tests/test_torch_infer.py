"""The whole serving slice on the CPU: the port's CLI in its default mode
(checkpoint restore -> BN fold -> streamed sparse export through the folded
forward with the kernel dispatch -> npz export and dataset metrics) vs the
JAX package's ``run_inference`` on its host-densify dense path, from one
JAX checkpoint and one event file. The other modes are held against the
JAX package in tests/test_torch_ana.py."""

import ast
import json

import numpy as np
import pytest

from uresnet_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from uresnet_tpu.data.synthetic import generate_file
from uresnet_tpu.engine.evaluator import run_inference
from uresnet_tpu.engine.trainer import Trainer
from uresnet_tpu.models.uresnet import uresnet_apply
from uresnet_tpu.parallel.mesh import make_mesh
from uresnet_tpu_torch.cli import infer


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tinf")
    path = generate_file(str(tmp / "ana.usef"), 5, seed=21, shape=(64, 64),
                         planes=(0, 1))
    cfg = Config(
        model=ModelConfig(depth=2, base_filters=16, num_class=3,
                          compute_dtype="float32"),
        data=DataConfig(image_size=64, batch_size=4, planes=(0, 1),
                        input_files=(path,), synthetic=False,
                        random_access=False),
        train=TrainConfig(checkpoint_dir=str(tmp / "ckpt"),
                          log_dir=str(tmp / "log")),
    )
    trainer = Trainer(cfg, mesh=make_mesh(1))
    ts = trainer.init_state()
    # non-trivial BN running stats, so the fold matters
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    _, state = uresnet_apply(ts.params, ts.model_state, x, cfg=cfg.model,
                             train=True)
    ts = ts._replace(model_state=state)
    ckpt = trainer.save(ts, 3)
    want_stats = run_inference(trainer, ts, path, str(tmp / "jax.npz"),
                               streamed=False, export="dense")
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    return cfg_path, ckpt, path, want_stats, tmp


def test_cli_matches_jax_run_inference(setup, capsys):
    cfg_path, ckpt, path, want_stats, tmp = setup
    out = str(tmp / "port.npz")
    assert infer.main([str(cfg_path), "--checkpoint", ckpt, "--input", path,
                       "--output", out, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "restored step 3"
    stats = ast.literal_eval(lines[-1].split(": ", 1)[1])
    got, want = np.load(out), np.load(str(tmp / "jax.npz"))
    assert set(got.files) == set(want.files)
    for k in ("event_id", "plane_id", "coords", "label"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    top2 = np.sort(want["scores"], axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got["pred"][clear], want["pred"][clear])
    np.testing.assert_array_equal(got["pred"], got["scores"].argmax(1))
    assert stats.keys() == want_stats.keys()
    for k, v in want_stats.items():
        assert stats[k] == pytest.approx(v, abs=1e-6), k
    assert stats["n_events"] == 5


def test_cli_without_checkpoint(setup, tmp_path):
    cfg_path, _, path, _, _ = setup
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        infer.main([str(cfg_path), f"train.checkpoint_dir={tmp_path}",
                    "--input", path, "--device", "cpu"])
