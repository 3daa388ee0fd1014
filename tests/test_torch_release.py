"""The port's release checkpoints and eval curves
(uresnet_tpu_torch/tools/make_release_ckpt.py, tools/eval_curve.py)
against the JAX tools; the cases of tests/test_release_ckpt.py.

A tiny bf16 model trained a few steps by the port's Trainer on the CPU
gives the full checkpoints. The port's release artifact of one is
bit-equal to the JAX tool's (the bf16 cast rounds to nearest even in both);
it evaluates exactly as the full checkpoint; a full resume from it raises;
the bf16 cast needs --force; keep-dtype is exact for f32 models. The
port's eval curve over two f32 checkpoints prints, per checkpoint, the
metrics the JAX tool prints.
"""

import ast
import json

import numpy as np
import pytest
import torch

from tools.eval_curve import main as jax_curve_main
from tools.make_release_ckpt import strip as jax_strip
from uresnet_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from uresnet_tpu.data.synthetic import generate_file
from uresnet_tpu_torch.config import load_config
from uresnet_tpu_torch.engine.checkpoint import latest_checkpoint
from uresnet_tpu_torch.engine.evaluator import evaluate_dataset
from uresnet_tpu_torch.engine.trainer import Trainer
from uresnet_tpu_torch.tools import eval_curve
from uresnet_tpu_torch.tools.make_release_ckpt import main as release_main
from uresnet_tpu_torch.tools.make_release_ckpt import strip


def _write(cfg, path):
    path.write_text(json.dumps(cfg.to_dict()))
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny bf16 model trained 4 steps by the port (checkpoints at steps
    2 and 4), its config file and a held-out file."""
    tmp = tmp_path_factory.mktemp("rel")
    eval_path = generate_file(str(tmp / "ev.usef"), 4, seed=9,
                              shape=(64, 64), planes=(0,))
    cfg = Config(
        model=ModelConfig(depth=2, base_filters=4, num_class=3,
                          compute_dtype="bfloat16", pack=True),
        data=DataConfig(image_size=64, batch_size=2, planes=(0,),
                        synthetic=True, synthetic_events=8, num_threads=1),
        train=TrainConfig(seed=3, checkpoint_dir=str(tmp / "ck"),
                          log_dir=str(tmp / "log"), iterations=4,
                          summary_iter=2, checkpoint_iter=2, val_iter=0),
    )
    cfg_path = _write(cfg, tmp / "cfg.json")
    Trainer(load_config(cfg_path), device="cpu").fit(log=False)
    full = latest_checkpoint(cfg.train.checkpoint_dir)
    assert full.endswith("step_00000004.npz")
    return cfg, cfg_path, full, eval_path, tmp


def _eval_trainer(cfg_path, eval_path, load_file=None):
    over = [f"data.input_files={eval_path}", "data.synthetic=false",
            "data.random_access=false"]
    if load_file:
        over += [f"train.load_file={load_file}", "train.load_params_only=true"]
    return Trainer(load_config(cfg_path, over), device="cpu")


def test_release_artifact_equals_jax_tools(trained):
    """The same full checkpoint stripped by both tools: the same leaves,
    bit for bit (uint16 bf16 patterns included)."""
    _, _, full, _, tmp = trained
    for kd in ("bfloat16", "keep"):
        ours, theirs = str(tmp / f"port_{kd}.npz"), str(tmp / f"jax_{kd}.npz")
        keys = strip(full, ours, kernels_dtype=kd)[0]
        assert keys == jax_strip(full, theirs, kernels_dtype=kd)[0]
        with np.load(ours) as a, np.load(theirs) as b:
            assert set(a.files) == set(b.files)
            for k in b.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert ("__kernels_bf16__" in keys) == (kd == "bfloat16")


def test_release_artifact_eval_is_bit_exact(trained):
    """bf16-kernel release artifact == full checkpoint: identical integer
    confusion counts and metrics."""
    _, cfg_path, full, eval_path, tmp = trained
    out = str(tmp / "release.npz")
    keys, in_b, out_b, sha = strip(full, out, kernels_dtype="bfloat16")
    assert out_b < in_b
    assert all(k in ("meta/step", "__kernels_bf16__")
               or k.startswith("train_state/") for k in keys)
    assert len(sha) == 64
    tr_full = _eval_trainer(cfg_path, eval_path)
    ts_full, step, _ = tr_full.restore(full)
    assert step == 4
    tr_rel = _eval_trainer(cfg_path, eval_path, load_file=out)
    ts_rel, step_rel, _ = tr_rel.restore()
    assert step_rel == 0
    assert evaluate_dataset(tr_full, ts_full) == evaluate_dataset(tr_rel, ts_rel)


def test_release_artifact_refuses_full_resume(trained):
    _, cfg_path, full, eval_path, tmp = trained
    out = str(tmp / "release2.npz")
    strip(full, out, kernels_dtype="keep")
    with pytest.raises(KeyError, match="missing leaf"):
        _eval_trainer(cfg_path, eval_path).restore(out)


def test_release_cli_gates_bf16_cast(trained, capsys):
    _, _, full, _, tmp = trained
    out = str(tmp / "release3.npz")
    assert release_main([full, out, "--kernels-dtype", "bfloat16"]) == 2
    assert release_main([full, out, "--kernels-dtype", "bfloat16",
                         "--force"]) == 0
    assert "sha256=" in capsys.readouterr().out


def test_release_keep_dtype_exact_for_f32_models(tmp_path):
    cfg = Config(
        model=ModelConfig(depth=2, base_filters=4, num_class=3,
                          compute_dtype="float32"),
        data=DataConfig(image_size=32, batch_size=2, planes=(0,),
                        synthetic=True, synthetic_events=4, num_threads=1),
        train=TrainConfig(seed=1, checkpoint_dir=str(tmp_path / "ck"),
                          log_dir=str(tmp_path / "log"), iterations=2,
                          summary_iter=2, checkpoint_iter=2, val_iter=0),
    )
    cfg_path = _write(cfg, tmp_path / "cfg.json")
    ts, _ = Trainer(load_config(cfg_path), device="cpu").fit(log=False)
    out = str(tmp_path / "rel.npz")
    strip(latest_checkpoint(cfg.train.checkpoint_dir), out, kernels_dtype="keep")
    ts2, _, _ = Trainer(load_config(cfg_path, [
        f"train.load_file={out}", "train.load_params_only=true"]),
        device="cpu").restore()
    for (k, a), (k2, b) in zip(ts.model.state_dict().items(),
                               ts2.model.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _curve(main, argv, capsys):
    assert main(argv) == 0
    return [(line.split()[1], ast.literal_eval(line.split("metrics: ", 1)[1]))
            for line in capsys.readouterr().out.splitlines()
            if line.startswith("ckpt ")]


def test_eval_curve_matches_jax_tool(tmp_path, capsys):
    """One line per checkpoint, in order (a missing one skipped), with the
    JAX tool's exactly-once metrics of the same checkpoints: f32, where the
    two packages' forwards agree (counts equal, the printed 5-decimal means
    within one unit of the last decimal)."""
    eval_path = generate_file(str(tmp_path / "ev.usef"), 4, seed=9,
                              shape=(64, 64), planes=(0,))
    cfg = Config(
        model=ModelConfig(depth=2, base_filters=4, num_class=3,
                          compute_dtype="float32"),
        data=DataConfig(image_size=64, batch_size=2, planes=(0,),
                        synthetic=True, synthetic_events=8, num_threads=1),
        train=TrainConfig(seed=3, checkpoint_dir=str(tmp_path / "ck"),
                          log_dir=str(tmp_path / "log"), iterations=4,
                          summary_iter=2, checkpoint_iter=2, val_iter=0),
    )
    cfg_path = _write(cfg, tmp_path / "cfg.json")
    Trainer(load_config(cfg_path), device="cpu").fit(log=False)
    cks = [str(tmp_path / "ck" / f"step_0000000{s}.npz") for s in (2, 4)]
    cks.append(str(tmp_path / "missing.npz"))
    common = [cfg_path, *cks, "--input", eval_path,
              "--override", "parallel.data=1"]
    ours = _curve(eval_curve.main, common + ["--device", "cpu"], capsys)
    theirs = _curve(jax_curve_main, common + ["--platform", "cpu"], capsys)
    assert [c for c, _ in ours] == [c for c, _ in theirs] == cks[:2]
    for (_, m), (_, jm) in zip(ours, theirs):
        assert m.keys() == jm.keys()
        assert m["n_events"] == jm["n_events"] == 4
        assert m["n_pixels"] == jm["n_pixels"] == 4 * 64 * 64
        for k in m:
            assert abs(m[k] - jm[k]) <= 1e-5, (k, m[k], jm[k])
