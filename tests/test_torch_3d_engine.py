"""The port's 3D data plane, training engine and analysis surface vs the
JAX package's on the CPU (BASELINE config 4's family, cut to depth 2,
base 4, volumes of 12^3-64^3).

Inputs are made with numpy from a seed (synthetic 3D events, dense point
clouds); weights are the JAX package's, carried across through its
checkpoint. Densify, counts and exports are compared bit for bit; f32
params, states and scores within 1e-4 (scores 1e-5), metrics within 1e-6,
as the 2D tests of the same surfaces.
"""

import dataclasses
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uresnet_tpu.config import (Config, DataConfig, ModelConfig, OptimConfig,
                                ParallelConfig, TrainConfig)
from uresnet_tpu.data import device_pipeline as jdp
from uresnet_tpu.data import loader as jloader
from uresnet_tpu.data.pipeline import densify_batch, sparse_batch
from uresnet_tpu.data.synthetic import generate_event, generate_file
from uresnet_tpu.engine import evaluator as jev
from uresnet_tpu.engine import losses as jlosses
from uresnet_tpu.engine import metrics as jmetrics
from uresnet_tpu.engine.augment import augment_batch as jax_augment
from uresnet_tpu.engine.trainer import Trainer as JaxTrainer
from uresnet_tpu.models.uresnet import uresnet_apply
from uresnet_tpu.parallel.mesh import make_mesh
from uresnet_tpu_torch import config as tconfig
from uresnet_tpu_torch.cli import infer
from uresnet_tpu_torch.cli import train as cli_train
from uresnet_tpu_torch.config import load_config
from uresnet_tpu_torch.data import device_pipeline as dp
from uresnet_tpu_torch.data import loader as tloader
from uresnet_tpu_torch.engine import checkpoint as tckpt
from uresnet_tpu_torch.engine import evaluator as tevl
from uresnet_tpu_torch.engine import losses, metrics
from uresnet_tpu_torch.engine.augment import augment_batch
from uresnet_tpu_torch.engine.checkpoint import load_serving_state
from uresnet_tpu_torch.engine.trainer import Trainer
from uresnet_tpu_torch.models.convert import (flatten_tree, jax_params,
                                              jax_train_state,
                                              load_jax_params,
                                              load_jax_train_state)
from uresnet_tpu_torch.ops.cuda import conv2d as tfused

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from make_release_ckpt import strip  # noqa: E402

T = torch.from_numpy
TOL = 1e-4


def _events(n=3, shape=(48, 48, 48), seed=11):
    rng = np.random.default_rng(seed)
    return [generate_event(rng, shape=shape, planes=(0,)) for _ in range(n)]


# -- densify, augmentation, counts ------------------------------------------------


def _jax_decisions(key, batch, dims=3):
    """The per-image flip decisions JAX's augment_batch draws from ``key``
    (split into dims + 1 keys, a (B,) bernoulli per axis), as the port's
    (dims + 1, B) decisions; 3D draws no rot90."""
    kf = jax.random.split(key, dims + 1)
    rows = [np.asarray(jax.random.bernoulli(kf[ax], shape=(batch,)))
            for ax in range(dims)]
    return T(np.stack(rows + [np.zeros(batch, bool)]))


def test_densify_inline_flips_match_jax():
    """The 3D densify (tests/test_device_pipeline.py's 3D case): plain, it
    equals numpy's densify_batch bit for bit; with the flips of a JAX key
    inside the scatter, it equals the JAX in-scatter densify and JAX
    ``augment_batch(dims=3)`` of the plain volumes bit for bit."""
    events = _events()
    sp = sparse_batch(events, planes=(0,), max_points=4096, ndims=3)
    assert sp["coords"].dtype == np.int16 and sp["coords"].shape == (3, 4096, 3)
    tsp = {k: T(v) for k, v in sp.items()}
    S = 32
    want = densify_batch(events, planes=(0,), image_size=S,
                         weight_mode="class_balance", num_class=3)
    plain = dp.densify_on_device(tsp, image_size=S)
    for k in want:
        np.testing.assert_array_equal(plain[k].numpy(), want[k], err_msg=k)
    jplain = jdp.densify_on_device(sp, image_size=S)
    seen = set()
    for seed in (0, 1, 2, 5):
        key = jax.random.PRNGKey(seed)
        d = _jax_decisions(key, 3)
        seen.add(tuple(d[:3].flatten().tolist()))
        got = dp.densify_on_device(tsp, image_size=S, decisions=d)
        wj = jax.device_get(jdp.densify_on_device(sp, image_size=S,
                                                  augment_key=key))
        wa = jax.device_get(jax_augment(key, dict(jplain), dims=3))
        dense = augment_batch(plain, dims=3, decisions=d)
        for k in ("data", "label", "weight"):
            for w in (wj, wa):
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(w[k]),
                                              err_msg=k)
            torch.testing.assert_close(dense[k], got[k], rtol=0, atol=0)
    assert len(seen) == 4  # the seeds flip different axes


def test_crop_origin_and_scores_at_points_match_jax():
    sp = sparse_batch(_events(4, shape=(64, 40, 48), seed=3), planes=(0,),
                      max_points=4096, ndims=3)
    tsp = {k: T(v) for k, v in sp.items()}
    np.testing.assert_array_equal(
        dp.crop_origin(tsp, image_size=32).numpy(),
        np.asarray(jdp.crop_origin(sp, image_size=32)))
    scores = np.random.default_rng(5).standard_normal(
        (4, 32, 32, 32, 3)).astype(np.float32)
    got = dp.scores_at_points(tsp, T(scores), image_size=32)
    want = jdp.scores_at_points({k: jnp.asarray(v) for k, v in sp.items()},
                                jnp.asarray(scores), image_size=32)
    assert got.shape == (4, 4096, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_losses_and_counts_match_jax(rng):
    """The weighted cross-entropy in both modes (1e-6) and the confusion
    counts (exact) on 5-D tensors, a padded row masked."""
    logits = (rng.standard_normal((3, 6, 5, 4, 3)) * 3).astype(np.float32)
    labels = rng.integers(0, 3, (3, 6, 5, 4)).astype(np.int32)
    weights = rng.uniform(0.1, 2, (3, 6, 5, 4)).astype(np.float32)
    data = (rng.uniform(0, 1, (3, 6, 5, 4, 1)) > 0.6).astype(np.float32)
    for normalize in ("mean", "weight_sum"):
        got = losses.weighted_softmax_xent(T(logits), T(labels), T(weights),
                                           normalize=normalize)
        want = jlosses.weighted_softmax_xent(logits, labels, weights,
                                             normalize=normalize)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    valid = np.array([1, 0, 1], np.float32)
    got = metrics.segmentation_counts(T(logits), T(labels), T(data),
                                      num_class=3, row_valid=T(valid))
    want = jmetrics.segmentation_counts(logits, labels, data, num_class=3,
                                        row_valid=valid)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    got_m = metrics.segmentation_metrics(T(logits), T(labels), T(data),
                                         num_class=3)
    want_m = jmetrics.segmentation_metrics(logits, labels, data, num_class=3)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-6)


def test_host_loader_3d_matches_jax(tmp_path):
    """``sparse_batch(ndims=3)`` through the host loader at config 4's
    max_points (24576): int16 (B, 24576, 3) coords, batches equal to the
    JAX loader's."""
    path = generate_file(str(tmp_path / "v.usef"), 5, seed=4,
                         shape=(64, 64, 64), planes=(0,))
    kw = dict(image_size=32, batch_size=2, planes=(0,), input_files=(path,),
              synthetic=False, random_access=True, seed=13, num_threads=2,
              backend="python", transfer="sparse", max_points=24576,
              weight_mode="class_balance")
    a = tloader.make_batch_loader(tconfig.DataConfig(**kw), train=True, ndims=3)
    b = jloader.make_batch_loader(DataConfig(**kw), train=True, ndims=3)
    a.start()
    b.start()
    try:
        for _ in range(2):
            ga, gb = a.next(), b.next()
            assert ga["coords"].dtype == np.int16
            assert ga["coords"].shape == (2, 24576, 3)
            assert ga.keys() == gb.keys()
            for k in ga:
                np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)
    finally:
        a.stop()
        b.stop()


# -- the trainer ---------------------------------------------------------------------


def _cfg(tmp, **model_kw) -> Config:
    """Config 4's training settings (3D, f32 head, class-balance weights,
    Adam at lr 2e-4 with the cosine schedule, warmup and global-norm clip
    1.0), cut to depth 2, base 4, 12^3, batch 2, in f32."""
    return Config(
        model=ModelConfig(dims=3, depth=2, base_filters=4, num_class=3,
                          compute_dtype="float32", head_dtype="float32",
                          **model_kw),
        data=DataConfig(image_size=12, batch_size=2, planes=(0,),
                        synthetic=True, synthetic_events=8, seed=5,
                        num_threads=1, random_access=False, transfer="sparse",
                        max_points=1792, backend="python",
                        weight_mode="class_balance"),
        optim=OptimConfig(lr=2e-4, schedule="cosine", decay_steps=10,
                          warmup_steps=2, grad_clip_norm=1.0),
        train=TrainConfig(iterations=4, summary_iter=2, checkpoint_iter=0,
                          val_iter=0, seed=11,
                          checkpoint_dir=str(tmp / "ckpt"),
                          log_dir=str(tmp / "log")),
        parallel=ParallelConfig(data=1))


def _cloud_batch(rng, rows, shape=(12, 12, 12), n=1728, max_points=1792):
    """A sparse 3D batch with a point at every voxel of a 12^3 volume, so
    that every BN channel's variance is well above f32 noise (see
    tests/test_torch_train_engine.py). At 60% occupancy, as the 2D test
    uses, 6 of the 864 first-moment elements of one deep leaf
    (dec0_b0.cb1.conv.w) differed from the JAX package's by 1.4e-4 of the
    largest moment after 3 steps: the same f32 drift of XLA's CPU BN
    reductions on partly empty inputs."""
    pix = np.stack(np.meshgrid(*map(np.arange, shape), indexing="ij"),
                   -1).reshape(-1, 3)
    coords = np.zeros((rows, max_points, 3), np.int16)
    for r in range(rows):
        coords[r, :n] = pix[rng.permutation(len(pix))[:n]]
    values = np.zeros((rows, max_points), np.float32)
    values[:, :n] = rng.uniform(1, 500, (rows, n))
    labels = np.zeros((rows, max_points), np.uint8)
    labels[:, :n] = rng.integers(0, 3, (rows, n))
    return {"coords": coords, "values": values, "labels": labels,
            "npoints": np.full(rows, n, np.int32),
            "shape": np.tile(np.int32(shape), (rows, 1))}


def _leaves(fields):
    f = fields._asdict() if hasattr(fields, "_asdict") else fields
    opt = f["opt"]._asdict() if hasattr(f["opt"], "_asdict") else f["opt"]
    out = {f"params.{k}": v for k, v in flatten_tree(f["params"]).items()}
    out.update({f"state.{k}": v for k, v in flatten_tree(f["model_state"]).items()})
    for kind in ("mu", "nu"):
        out.update({f"{kind}.{k}": v for k, v in flatten_tree(opt[kind]).items()})
    out["step"] = opt["step"]
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer (pack=False): initial state, 3 sparse batches, the
    state after 3 steps."""
    tmp = tmp_path_factory.mktemp("jax3d")
    cfg = _cfg(tmp)
    tr = JaxTrainer(cfg, mesh=make_mesh(1))
    ts = tr.init_state()
    ts0 = jax.device_get(ts)
    batches = [_cloud_batch(np.random.default_rng(i), 2) for i in range(3)]
    for b in batches:
        ts, _ = tr.train_step(ts, tr._device_batch(b))
    return cfg, tr, ts0, batches, jax.device_get(ts)


def _port_from(cfg, ts0):
    tr = Trainer(cfg, device="cpu")
    ts = tr.init_state()
    opt, key = load_jax_train_state(ts.model, ts0)
    return tr, dataclasses.replace(ts, opt=opt, key=key)


def test_three_trainer_steps_match_jax(jax_run):
    """Params and BN state at 1e-4 of max(|leaf|, 1), Adam moments at 1e-4
    of their largest element; the train forward's logits are f32."""
    cfg, _, ts0, batches, want = jax_run
    tr, ts = _port_from(cfg, ts0)
    for b in batches:
        ts, m = tr.train_step(ts, tr.device_batch(b))
        assert math.isfinite(float(m["loss"]))
    got = _leaves(jax_train_state(ts.model, ts.opt, ts.key))
    want = _leaves(want)
    assert got.keys() == want.keys() and int(got["step"]) == 3
    assert got["params.head.w"].shape == (3, 3, 3, 4, 3)
    moment_max = {kind: max(np.abs(v).max() for k, v in want.items()
                            if k.startswith(kind)) for kind in ("mu", "nu")}
    for k, v in want.items():
        kind = k.split(".")[0]
        scale = moment_max.get(kind, max(np.abs(v).max(), 1.0))
        np.testing.assert_allclose(got[k] / scale, v / scale, rtol=0, atol=TOL,
                                   err_msg=k)


def test_bf16_train_step_f32_head(jax_run):
    """At config 4's dtypes (bf16, head_dtype float32) a train step gives f32
    logits that bf16 cannot hold, an f32 head-weight gradient, and a finite
    loss within 1e-2 of the JAX package's (bf16 convs sum in other orders)."""
    cfg, jtr, ts0, batches, _ = jax_run
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))
    tr, ts = _port_from(cfg, ts0)
    batch = tr._prepare(tr.device_batch(batches[0]))
    logits, _ = ts.model(batch["data"], train=True)
    assert logits.dtype == torch.float32
    assert not torch.equal(logits, logits.bfloat16().float())
    logits.sum().backward()
    assert ts.model.head.w.grad.dtype == torch.float32
    jcfg = dataclasses.replace(jtr.cfg, model=cfg.model)
    jtr_bf16 = JaxTrainer(jcfg, mesh=make_mesh(1))
    _, jm = jtr_bf16.train_step(jax.device_put(ts0),
                                jtr_bf16._device_batch(batches[0]))
    _, m = tr.train_step(_port_from(cfg, ts0)[1], tr.device_batch(batches[0]))
    assert math.isfinite(float(m["loss"]))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-2 * abs(float(jm["loss"]))


def test_checkpoints_interchange(jax_run, tmp_path):
    """5-D trees both ways: a port checkpoint restored by the JAX Trainer
    and a JAX one by the port, every leaf equal under the JAX key names."""
    cfg, jtr, ts0, batches, want = jax_run
    tr, ts = _port_from(cfg, ts0)
    ts, _ = tr.train_step(ts, tr.device_batch(batches[0]))
    tr.cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(tmp_path / "port")))
    path = tr.save(ts, 1, data_cursor=2)
    with np.load(path) as z:
        assert z["train_state/params/enc0_b0/cb1/conv/w"].shape == (3, 3, 3, 4, 4)
        assert z["train_state/opt/mu/head/w"].shape == (3, 3, 3, 4, 3)
    jts, step, cursor = jtr.restore(path)
    assert (step, cursor) == (1, 2)
    got, mine = _leaves(jax.device_get(jts)), _leaves(
        jax_train_state(ts.model, ts.opt, ts.key))
    assert got.keys() == mine.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], mine[k], err_msg=k)

    jtr.cfg = dataclasses.replace(jtr.cfg, train=dataclasses.replace(
        jtr.cfg.train, checkpoint_dir=str(tmp_path / "jax")))
    jpath = jtr.save(jax.device_put(want), 3, data_cursor=6)
    ts2, step, cursor = tr.restore(jpath)
    assert (step, cursor) == (3, 6)
    got = _leaves(jax_train_state(ts2.model, ts2.opt, ts2.key))
    for k, v in _leaves(want).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_release_bf16_manifest_5d(jax_run, tmp_path):
    """A release artifact of a 3D model (tools/make_release_ckpt.py): its
    5-D kernels, stored as bf16 bit patterns, load as the bf16-rounded
    kernels."""
    cfg, jtr, _, _, want = jax_run
    jtr.cfg = dataclasses.replace(jtr.cfg, train=dataclasses.replace(
        jtr.cfg.train, checkpoint_dir=str(tmp_path / "jax")))
    path = jtr.save(jax.device_put(want), 3)
    rel = str(tmp_path / "release.npz")
    strip(path, rel, kernels_dtype="bfloat16")
    with np.load(rel) as z:
        listed = {str(k) for k in z["__kernels_bf16__"]}
    assert "train_state/params/dec0_b0/proj/w" in listed
    params, state, _ = load_serving_state(rel)
    tr = Trainer(cfg, device="cpu")
    ts = tr.init_state()
    load_jax_params(ts.model, params, state)
    got = jax_params(ts.model)[0]["enc1_b1"]["cb2"]["conv"]["w"]
    w = want.params["enc1_b1"]["cb2"]["conv"]["w"]
    assert got.shape == (3, 3, 3, 8, 8)
    bf = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got, bf)
    assert not np.array_equal(bf, w)


def test_cli_train_3d_end_to_end(tmp_path, capsys):
    """A tiny 3D run through cli.train on the CPU: synthetic volumes, the
    3-axis flips, checkpoints of 5-D kernels, a resume that continues."""
    cfg = tmp_path / "tiny3d.json"
    cfg.write_text(json.dumps({
        "model": {"dims": 3, "depth": 2, "base_filters": 4,
                  "compute_dtype": "bfloat16", "head_dtype": "float32",
                  "pack": True},
        "data": {"image_size": 16, "batch_size": 2, "planes": [0],
                 "synthetic": True, "synthetic_events": 8, "num_threads": 2,
                 "max_points": 4096, "augment": True},
        "optim": {"lr": 2e-4, "schedule": "cosine", "warmup_steps": 2,
                  "grad_clip_norm": 1.0},
        "train": {"iterations": 4, "summary_iter": 2, "checkpoint_iter": 2,
                  "val_iter": 4, "val_exact": True,
                  "checkpoint_dir": str(tmp_path / "ckpt"),
                  "log_dir": str(tmp_path / "log")}}))
    assert cli_train.main([str(cfg), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and "final:" in out
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "LATEST", "step_00000002.npz", "step_00000004.npz"]
    rows = [json.loads(line) for line in
            (tmp_path / "log" / "train_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [2, 4]
    assert all(math.isfinite(r["loss"]) for r in rows)
    val = json.loads((tmp_path / "log" / "val_metrics.jsonl").read_text())
    assert val["n_pixels"] == val["n_events"] * 16 ** 3
    with np.load(tmp_path / "ckpt" / "step_00000004.npz") as z:
        assert z["train_state/params/stem/conv/w"].shape == (3, 3, 3, 1, 4)
    assert cli_train.main([str(cfg), "--device", "cpu", "--resume",
                           "--iterations", "2"]) == 0
    assert "step_00000006.npz" in os.listdir(tmp_path / "ckpt")


# -- analysis ------------------------------------------------------------------------

N_EVENTS = 4
METRIC_TOL = 1e-6


@pytest.fixture(scope="module")
def A(tmp_path_factory):
    """A JAX checkpoint of a 3D model (f32, warmed BN stats, a decisive
    background as in tests/test_torch_ana.py) and 64^3 event files."""
    tmp = tmp_path_factory.mktemp("ana3d")
    main = generate_file(str(tmp / "v3.usef"), N_EVENTS, seed=11,
                         shape=(64, 64, 64), planes=(0,))
    tiled = generate_file(str(tmp / "t3.usef"), 3, seed=7,
                          shape=(64, 64, 64), planes=(0,))
    cfg = Config(
        model=ModelConfig(dims=3, depth=2, base_filters=4, num_class=3,
                          compute_dtype="float32"),
        data=DataConfig(image_size=32, batch_size=2, planes=(0,),
                        input_files=(main,), synthetic=False,
                        random_access=False, max_points=4096, num_threads=2),
        train=TrainConfig(checkpoint_dir=str(tmp / "ckpt"),
                          log_dir=str(tmp / "log")))
    jtr = JaxTrainer(cfg, mesh=make_mesh(1))
    jts = jtr.init_state()
    x = np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 32, 1)).astype(np.float32)
    _, state = uresnet_apply(jts.params, jts.model_state, x, cfg=cfg.model,
                             train=True)
    head = dict(jts.params["head"], b=jts.params["head"]["b"]
                + np.float32([0.15, 0, 0]))
    jts = jts._replace(model_state=state, params=dict(jts.params, head=head))
    ckpt = jtr.save(jts, 3)
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    return dict(tmp=tmp, main=main, tiled=tiled, cfg=cfg, cfg_path=str(cfg_path),
                ckpt=ckpt, jtr=jtr, jts=jts)


def _port(A, **overrides):
    cfg = load_config(A["cfg_path"], [f"{k}={v}" for k, v in overrides.items()])
    tr = Trainer(cfg, device="cpu")
    ts = tr.init_state()
    params, state, _ = load_serving_state(A["ckpt"])
    load_jax_params(ts.model, params, state)
    return tr, ts


def _assert_metrics(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5, abs=METRIC_TOL), k


def _assert_npz_close(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    assert set(got.files) == set(want.files)
    for k in ("event_id", "plane_id", "coords", "label"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
    top2 = np.sort(want["scores"], axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got["pred"][clear], want["pred"][clear])
    return len(want["scores"])


def test_exports_3d_equal_and_match_jax(A):
    """Sparse, dense and host exports of 3D volumes (coords (N, 3)) are bit
    for bit equal (tests/test_inference.py's 3D case), with 0 kernel
    launches, and the sparse one matches the JAX package's; so does the
    USEF writeback."""
    tr, ts = _port(A)
    before = (tfused.launches, tfused.launches_tensor_core,
              tfused.launches_f16_tensor_core)
    out, stats = {}, {}
    for mode, kw in (("sparse", dict(streamed=True, export="sparse")),
                     ("dense", dict(streamed=True, export="dense")),
                     ("host", dict(streamed=False, export="dense"))):
        out[mode] = str(A["tmp"] / f"port_{mode}.npz")
        stats[mode] = tevl.run_inference(tr, ts, A["main"], out[mode], **kw)
    assert (tfused.launches, tfused.launches_tensor_core,
            tfused.launches_f16_tensor_core) == before
    z = {m: np.load(p) for m, p in out.items()}
    assert z["sparse"]["coords"].shape[1] == 3 and len(z["sparse"]["scores"]) > 0
    for m in ("dense", "host"):
        assert stats[m] == stats["sparse"]
        for k in z["sparse"].files:
            np.testing.assert_array_equal(z[m][k], z["sparse"][k], err_msg=(m, k))
    want_path = str(A["tmp"] / "jax_sparse.npz")
    want = jev.run_inference(A["jtr"], A["jts"], A["main"], want_path)
    _assert_metrics(stats["sparse"], want)
    assert _assert_npz_close(out["sparse"], want_path) == stats["sparse"]["n_pixels"]

    from uresnet_tpu_torch.data import events as tev
    usef, jusef = str(A["tmp"] / "port.usef"), str(A["tmp"] / "jax.usef")
    tevl.run_inference(tr, ts, A["main"], usef, fmt="usef")
    jev.run_inference(A["jtr"], A["jts"], A["main"], jusef, fmt="usef")
    got_ev, want_ev = tev.read_events(usef), tev.read_events(jusef)
    assert len(got_ev) == len(want_ev) == N_EVENTS
    for ge, we in zip(got_ev, want_ev):
        assert [p.plane_id for p in ge.planes] == [0, 1, 2]
        for gp, wp in zip(ge.planes, we.planes):
            assert gp.coords.shape[1] == 3 and tuple(gp.shape) == tuple(wp.shape)
            np.testing.assert_array_equal(gp.coords, wp.coords)
            np.testing.assert_allclose(gp.values, wp.values, rtol=0, atol=1e-5)


def test_tiled_3d_covers_full_volume(A):
    """64^3 events through a 32^3 window (tests/test_inference.py's tiled 3D
    case): a grid of 8 clamped tiles per event, every charge voxel exported
    with detector coords and scored as the JAX package scores it."""
    from uresnet_tpu_torch.data import events as tev

    tr, ts = _port(A)
    out = str(A["tmp"] / "port_tiled.npz")
    got = tevl.run_inference(tr, ts, A["tiled"], out, tiled=True)
    want_path = str(A["tmp"] / "jax_tiled.npz")
    want = jev.run_inference(A["jtr"], A["jts"], A["tiled"], want_path,
                             tiled=True)
    _assert_metrics(got, want)
    assert got["n_tiles"] == 3 * 8
    n_expect = 0
    scale, clip = A["cfg"].data.normalize_scale, A["cfg"].data.normalize_clip
    for evt in tev.read_events(A["tiled"]):
        pl = evt.planes[0]
        flat = np.ravel_multi_index(tuple(pl.coords.T.astype(np.int64)), (64,) * 3)
        vals = np.zeros(64 ** 3, np.float32)
        vals[flat] = pl.values  # last wins
        n_expect += int((np.clip(vals * scale, 0, clip) > 0).sum())
    assert got["n_pixels"] == n_expect
    z = np.load(out)
    assert z["coords"].shape[1] == 3 and z["coords"].max() >= 32
    assert _assert_npz_close(out, want_path) == n_expect


def test_metrics_only_3d_counts_every_voxel(A, capsys):
    """--metrics-only --input: n_pixels = events x planes x S^3, metrics
    equal to the JAX evaluate_dataset's. The loss, an f32 sum over 32^3 x 2
    voxels per batch, is held to float64 at 1e-6 and to the JAX package at
    1e-4: XLA's CPU sum is 2.5e-5 off float64 here, the port's 5e-8."""
    import ast

    from uresnet_tpu_torch.data import events as tev
    from uresnet_tpu_torch.data.pipeline import densify_batch
    from uresnet_tpu_torch.engine.export import build_logits_fn

    want = jev.evaluate_dataset(A["jtr"], A["jts"])
    assert infer.main([A["cfg_path"], "--checkpoint", A["ckpt"], "--input",
                       A["main"], "--metrics-only", "--device", "cpu"]) == 0
    got = ast.literal_eval(capsys.readouterr().out.splitlines()[-1]
                           .split(": ", 1)[1])
    assert got["n_events"] == N_EVENTS
    assert got["n_pixels"] == N_EVENTS * 1 * 32 ** 3
    assert got["loss"] == pytest.approx(want.pop("loss"), rel=1e-4)
    _assert_metrics({k: v for k, v in got.items() if k != "loss"}, want)
    tr, ts = _port(A)
    b = densify_batch(tev.read_events(A["main"]), planes=(0,), image_size=32,
                      weight_mode=tr.cfg.data.weight_mode, num_class=3)
    lg = build_logits_fn(tr.cfg, ts.model)(T(b["data"])).double()
    xent = (torch.logsumexp(lg, -1)
            - lg.gather(-1, T(b["label"]).long()[..., None])[..., 0])
    ref = float((T(b["weight"]).double() * xent).mean())
    assert got["loss"] == pytest.approx(ref, rel=1e-6)
