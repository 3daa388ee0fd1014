"""The port's Trainer and ``cli.train`` vs the JAX package's on the CPU.

Three train steps of each package from the same (converted) initial state
on the same sparse batches agree in params, BN state and Adam moments at
1e-4 (f32, depth 2, base 4, 16x16, batch 4, class-balance weights, Adam at
config 2's lr 1e-3 with a cosine schedule and warmup). Checkpoints
interchange both ways; the port's own resume is exact, augmentation
stream included; the CLI trains and resumes end to end.

The parity run is kept where f32 answers the question. Its batches are
dense point clouds in the sparse format, at 16x16: on mostly empty or
larger images some BN channels' variance is a small difference of large
moments, where XLA's CPU f32 reductions drift from a float64 reference by
up to 11% per gradient leaf (the port's by 2.3e-5), and Adam's
g/sqrt(g^2) turns that noise at a near-zero gradient element into a step
of size lr (the JAX package's DP test skips params after Adam for this
reason). Params and BN state are compared at 1e-4 of max(|leaf|, 1), the
moments at 1e-4 of their largest element over all leaves.
"""

import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from uresnet_tpu.config import (Config, DataConfig, ModelConfig, OptimConfig,
                                ParallelConfig, TrainConfig)
from uresnet_tpu.engine.trainer import Trainer as JaxTrainer
from uresnet_tpu.parallel.mesh import make_mesh
from uresnet_tpu_torch.cli import train as cli_train
from uresnet_tpu_torch.engine import checkpoint as tckpt
from uresnet_tpu_torch.engine.trainer import Trainer
from uresnet_tpu_torch.models.convert import (flatten_tree, jax_train_state,
                                              load_jax_train_state)

TOL = 1e-4


def tiny_cfg(tmp, **data_kw) -> Config:
    return Config(
        model=ModelConfig(depth=2, base_filters=4, num_class=3,
                          compute_dtype="float32"),
        data=DataConfig(image_size=32, batch_size=4, planes=(0,),
                        synthetic=True, synthetic_events=16, seed=5,
                        num_threads=1, random_access=False, transfer="sparse",
                        max_points=1024, backend="python",
                        weight_mode="class_balance", **data_kw),
        optim=OptimConfig(lr=1e-3, schedule="cosine", decay_steps=10,
                          warmup_steps=1),
        train=TrainConfig(iterations=4, summary_iter=2, checkpoint_iter=0,
                          val_iter=0, seed=11,
                          checkpoint_dir=str(tmp / "ckpt"),
                          log_dir=str(tmp / "log")),
        parallel=ParallelConfig(data=1))


def _dense_cloud_batch(rng, rows, shape=(20, 18), n=216, max_points=256):
    """A sparse batch whose points cover 60% of a (20, 18) image."""
    coords = np.zeros((rows, max_points, 2), np.int16)
    pix = np.stack(np.meshgrid(*map(np.arange, shape), indexing="ij"),
                   -1).reshape(-1, 2)
    for r in range(rows):
        coords[r, :n] = pix[rng.permutation(len(pix))[:n]]
    values = np.zeros((rows, max_points), np.float32)
    values[:, :n] = rng.uniform(1, 500, (rows, n))
    labels = np.zeros((rows, max_points), np.uint8)
    labels[:, :n] = rng.integers(0, 3, (rows, n))
    return {"coords": coords, "values": values, "labels": labels,
            "npoints": np.full(rows, n, np.int32),
            "shape": np.tile(np.int32(shape), (rows, 1))}


def _leaves(tree_fields):
    """{path: array} of a JAX TrainState's params, state and Adam state."""
    f = tree_fields._asdict() if hasattr(tree_fields, "_asdict") else tree_fields
    opt = f["opt"]._asdict() if hasattr(f["opt"], "_asdict") else f["opt"]
    out = {f"params.{k}": v for k, v in flatten_tree(f["params"]).items()}
    out.update({f"state.{k}": v for k, v in flatten_tree(f["model_state"]).items()})
    for kind in ("mu", "nu"):
        out.update({f"{kind}.{k}": v for k, v in flatten_tree(opt[kind]).items()})
    out["step"] = opt["step"]
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX Trainer: initial state, 3 sparse batches, state after 3 steps."""
    tmp = tmp_path_factory.mktemp("jax")
    cfg = tiny_cfg(tmp)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                            image_size=16))
    tr = JaxTrainer(cfg, mesh=make_mesh(1))
    ts = tr.init_state()
    ts0 = jax.device_get(ts)
    batches = [_dense_cloud_batch(np.random.default_rng(i), 4)
               for i in range(3)]
    for b in batches:
        ts, _ = tr.train_step(ts, tr._device_batch(b))
    return cfg, tr, ts0, batches, jax.device_get(ts)


def _port_from(cfg, ts0):
    tr = Trainer(cfg, device="cpu")
    ts = tr.init_state()
    opt, key = load_jax_train_state(ts.model, ts0)
    return tr, dataclasses.replace(ts, opt=opt, key=key)


def test_three_trainer_steps_match_jax(jax_run):
    cfg, _, ts0, batches, want = jax_run
    tr, ts = _port_from(cfg, ts0)
    for b in batches:
        ts, m = tr.train_step(ts, tr.device_batch(b))
        assert math.isfinite(float(m["loss"]))
    got = _leaves(jax_train_state(ts.model, ts.opt, ts.key))
    want = _leaves(want)
    assert got.keys() == want.keys() and int(got["step"]) == 3
    moment_max = {kind: max(np.abs(v).max() for k, v in want.items()
                            if k.startswith(kind)) for kind in ("mu", "nu")}
    for k, v in want.items():
        kind = k.split(".")[0]
        scale = moment_max.get(kind, max(np.abs(v).max(), 1.0))
        np.testing.assert_allclose(got[k] / scale, v / scale, rtol=0, atol=TOL,
                                   err_msg=k)


def test_checkpoints_interchange(jax_run, tmp_path):
    """A port checkpoint restored by the JAX Trainer, and the reverse: every
    leaf equal, under the JAX package's key names."""
    cfg, jtr, ts0, batches, want = jax_run
    tr, ts = _port_from(cfg, ts0)
    ts, _ = tr.train_step(ts, tr.device_batch(batches[0]))
    port_dir = tmp_path / "port"
    tr.cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(port_dir)))
    path = tr.save(ts, 1, data_cursor=4)
    with np.load(path) as z:
        keys = set(z.files)
    assert {"train_state/opt/step", "train_state/key", "meta/step",
            "meta/data_cursor", "train_state/opt/mu/stem/conv/w",
            "train_state/opt/nu/head/b", "train_state/params/head/w",
            "train_state/model_state/stem/bn/var"} <= keys
    jts, step, cursor = jtr.restore(path)
    assert (step, cursor) == (1, 4)
    got, mine = _leaves(jax.device_get(jts)), _leaves(
        jax_train_state(ts.model, ts.opt, ts.key))
    assert got.keys() == mine.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], mine[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(jts.key), ts.key)

    jax_dir = tmp_path / "jax"
    jtr.cfg = dataclasses.replace(jtr.cfg, train=dataclasses.replace(
        jtr.cfg.train, checkpoint_dir=str(jax_dir)))
    jpath = jtr.save(jax.device_put(want), 3, data_cursor=12)
    ts2, step, cursor = tr.restore(jpath)
    assert (step, cursor) == (3, 12)
    got = _leaves(jax_train_state(ts2.model, ts2.opt, ts2.key))
    for k, v in _leaves(want).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_params_only_restore(jax_run, tmp_path):
    """train.load_params_only on a file without optimizer leaves: params and
    BN stats load, Adam and the key start fresh at step 0."""
    cfg, _, ts0, _, _ = jax_run
    src, ts = _port_from(cfg, ts0)
    f = jax_train_state(ts.model, ts.opt, ts.key)
    path = tckpt.save_checkpoint(str(tmp_path / "rel"), 9, tckpt.train_state_tree(
        f["params"], f["model_state"], 9))
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, load_file=path, load_params_only=True))
    with pytest.raises(KeyError, match="missing leaf"):
        Trainer(cfg, device="cpu").restore(path)  # a full restore needs opt
    ts2, step, cursor = Trainer(cfg2, device="cpu").restore()
    assert (step, cursor, ts2.opt.step) == (0, 0, 0)
    assert all(not v.any() for v in ts2.opt.mu.values())
    for (k, a), (_, b) in zip(ts2.model.state_dict().items(),
                              ts.model.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def _final_leaves(cfg):
    path = tckpt.latest_checkpoint(cfg.train.checkpoint_dir)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_resume_is_exact(tmp_path):
    """K+M steps == K steps, save, --resume, M steps: every checkpoint leaf
    equal, with flips/rot90 drawn from the key (augment on)."""
    a = tiny_cfg(tmp_path / "a", augment=True)
    Trainer(a, device="cpu").fit(iterations=5, log=False)
    b = tiny_cfg(tmp_path / "b", augment=True)
    Trainer(b, device="cpu").fit(iterations=3, log=False)
    _, last = Trainer(b, device="cpu").fit(iterations=2, resume=True, log=False)
    got, want = _final_leaves(b), _final_leaves(a)
    assert got.keys() == want.keys()
    assert int(got["meta/step"]) == 5 and list(got["train_state/key"]) == [11, 5]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_freeze_prunes_and_keeps(jax_run):
    """Frozen params take no gradient and stay bit for bit, with their
    moments; the rest train."""
    cfg, _, _, batches, _ = jax_run
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, freeze=("^stem/", "bn/scale$"), weight_decay=1e-2))
    tr = Trainer(cfg, device="cpu")
    ts = tr.init_state()
    before = {k: v.clone() for k, v in ts.model.named_parameters()}
    frozen = {k for k, p in ts.model.named_parameters() if not p.requires_grad}
    assert "stem.conv.w" in frozen and "enc0_b0.cb1.bn.scale" in frozen
    assert "head.w" not in frozen
    for b in batches[:2]:
        ts, _ = tr.train_step(ts, tr.device_batch(b))
    for k, p in ts.model.named_parameters():
        if k in frozen:
            torch.testing.assert_close(p.detach(), before[k], rtol=0, atol=0)
            assert not ts.opt.mu[k].any() and not ts.opt.nu[k].any()
        else:
            assert not torch.equal(p.detach(), before[k]), k


@pytest.mark.parametrize("fields,error,match", [
    pytest.param({"parallel.data": 2}, ValueError, "needs 2 devices, have 1",
                 id="parallel.data-2"),
    pytest.param({"parallel.spatial": 2}, ValueError,
                 "needs 2 devices, have 1", id="parallel.spatial-2"),
    pytest.param({"parallel.model": 2}, ValueError, "needs 2 devices, have 1",
                 id="parallel.model-2"),
    pytest.param({"parallel.spatial": 2, "parallel.model": 2}, ValueError,
                 "cannot be combined", id="parallel.spatial-2-model-2"),
    pytest.param({"parallel.model": 2, "model.pack": True}, ValueError,
                 "requires the canonical layout", id="parallel.model-2-pack")])
def test_refuses_unported(tmp_path, fields, error, match):
    """A mesh whose product differs from the world size (1 in a process
    with no group) is the JAX mesh's error: a run never goes quietly on
    fewer devices. Spatial x model meshes and tensor parallelism with the
    packed layout are refused as the JAX trainer refuses them, before any
    mesh is made."""
    cfg = tiny_cfg(tmp_path)
    for field, value in fields.items():
        section, name = field.split(".")
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
            getattr(cfg, section), **{name: value})})
    with pytest.raises(error, match=match):
        Trainer(cfg, device="cpu")


def test_cli_train_end_to_end(tmp_path, capsys, monkeypatch):
    """The tiny CPU run of the verify notes: falling loss, checkpoints,
    LATEST, a resume that continues the step count; --distributed without
    the torchrun environment exits 2 (--profile:
    tests/test_torch_profiling.py; a torchrun launch:
    tests/test_torch_distributed.py)."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({
        "model": {"depth": 2, "base_filters": 4, "compute_dtype": "float32"},
        "data": {"image_size": 64, "batch_size": 4, "planes": [0],
                 "synthetic": True, "synthetic_events": 32, "num_threads": 2},
        "train": {"iterations": 12, "summary_iter": 4, "checkpoint_iter": 6,
                  "val_iter": 0, "checkpoint_dir": str(tmp_path / "ckpt"),
                  "log_dir": str(tmp_path / "log")}}))
    assert cli_train.main([str(cfg), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and "final:" in out
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "LATEST", "step_00000006.npz", "step_00000012.npz"]
    rows = [json.loads(line) for line in
            (tmp_path / "log" / "train_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [4, 8, 12]
    assert all(math.isfinite(r["loss"]) for r in rows)
    assert cli_train.main([str(cfg), "--device", "cpu", "--resume",
                           "--iterations", "4", "train.summary_iter=2"]) == 0
    assert tckpt.checkpoint_step(tckpt.latest_checkpoint(
        str(tmp_path / "ckpt"))) == 16
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as e:
        cli_train.main([str(cfg), "--distributed"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "needs the torchrun environment" in err and "RANK" in err


def test_sigterm_checkpoints_and_resumes(tmp_path):
    """SIGTERM during fit finishes the step, writes a checkpoint (the only
    one: checkpoint_iter is 0) and exits 0; --resume continues from it."""
    import signal
    import subprocess
    import sys
    import time

    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({
        "model": {"depth": 2, "base_filters": 4, "compute_dtype": "float32"},
        "data": {"image_size": 32, "batch_size": 2, "planes": [0],
                 "synthetic": True, "synthetic_events": 8, "num_threads": 1},
        "train": {"checkpoint_dir": str(tmp_path / "ck"),
                  "log_dir": str(tmp_path / "lg"), "summary_iter": 1,
                  "checkpoint_iter": 0, "val_iter": 0,
                  "iterations": 100000}}))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "uresnet_tpu_torch.cli.train", str(cfg),
         "--device", "cpu"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=root)
    log = tmp_path / "lg" / "train_metrics.jsonl"
    try:
        deadline = time.time() + 120
        while not (log.exists() and len(log.read_text().splitlines()) >= 2):
            assert proc.poll() is None, proc.stdout.read()
            assert time.time() < deadline, "no training progress in 120 s"
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    assert "SIGTERM: checkpoint saved at step" in out, out
    saved = tckpt.checkpoint_step(tckpt.latest_checkpoint(str(tmp_path / "ck")))
    assert cli_train.main([str(cfg), "--device", "cpu", "--resume",
                           "--iterations", "2"]) == 0
    assert tckpt.checkpoint_step(tckpt.latest_checkpoint(
        str(tmp_path / "ck"))) == saved + 2
