"""Multi-plane batches (BASELINE config 3's geometry: rows = events x
planes) and the sharded loader, the port against the JAX package.

Train steps at planes [0, 1, 2] with 6 rows (2 events x 3 planes), augment
off, from the same initial state, on dense clouds at 16^2 (ROADMAP.md §3:
on mostly empty planes XLA's CPU f32 BN sums drift): the state after the
first step compared as test_torch_train_engine.py's parity is (1e-4), the
losses of three steps at 1e-5. (Adam's first step is lr * g / |g|: an
element whose gradient is near zero moves by +-lr with the sign of the
two packages' f32 noise, and the next steps carry it on; at 6 rows one BN
bias element of 8 differs by 3.2e-4 after three steps.) The port's augmentation
draws its own stream (ROADMAP.md §3), so its 3-plane form is held to the
dense augmentation of the same decisions instead, one per row.
``evaluate_dataset`` at three planes against the JAX package, with
n_pixels = events x 3 x 64^2. The port loader's ``shard=(rank, count)``
against the JAX loader's, mirroring tests/test_multihost_shard.py.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from uresnet_tpu.config import (Config, DataConfig, ModelConfig, OptimConfig,
                                ParallelConfig, TrainConfig)
from uresnet_tpu.data.events import SparseEvent, SparsePlane, write_events
from uresnet_tpu.data.loader import BatchLoader as JaxBatchLoader
from uresnet_tpu.data.synthetic import generate_file
from uresnet_tpu.engine import evaluator as jev
from uresnet_tpu.engine.trainer import Trainer as JaxTrainer
from uresnet_tpu.models.uresnet import uresnet_apply
from uresnet_tpu.parallel.mesh import make_mesh
from uresnet_tpu_torch.config import DataConfig as PortDataConfig
from uresnet_tpu_torch.data.loader import BatchLoader
from uresnet_tpu_torch.engine import evaluator as tevl
from uresnet_tpu_torch.engine.augment import augment_batch
from uresnet_tpu_torch.engine.trainer import Trainer
from uresnet_tpu_torch.models.convert import (flatten_tree, jax_train_state,
                                              load_jax_params,
                                              load_jax_train_state)

PLANES = (0, 1, 2)
TOL = 1e-4
METRIC_TOL = 1e-6


def _dense_cloud_file(path, n_events, seed):
    """Events of 3 planes, each 216 points on 60% of a 20x18 plane."""
    rng = np.random.default_rng(seed)
    pix = np.stack(np.meshgrid(np.arange(20), np.arange(18), indexing="ij"),
                   -1).reshape(-1, 2)
    events = []
    for _ in range(n_events):
        planes = []
        for p in PLANES:
            c = pix[rng.permutation(len(pix))[:216]].astype(np.int32)
            planes.append(SparsePlane(
                p, (20, 18), c, rng.uniform(1, 500, len(c)).astype(np.float32),
                rng.integers(0, 3, len(c)).astype(np.uint8)))
        events.append(SparseEvent(planes))
    write_events(path, events)
    return path


def _cfg(tmp, usef, image_size=16, batch_size=6, **data_kw) -> Config:
    return Config(
        model=ModelConfig(depth=2, base_filters=4, num_class=3,
                          compute_dtype="float32"),
        data=DataConfig(image_size=image_size, batch_size=batch_size,
                        planes=PLANES, input_files=(usef,), synthetic=False,
                        random_access=False, transfer="sparse",
                        max_points=256, backend="python", num_threads=1,
                        weight_mode="class_balance", **data_kw),
        optim=OptimConfig(lr=1e-3, schedule="cosine", decay_steps=10,
                          warmup_steps=1),
        train=TrainConfig(iterations=3, summary_iter=1, checkpoint_iter=0,
                          val_iter=0, seed=11,
                          checkpoint_dir=str(tmp / "ckpt"),
                          log_dir=str(tmp / "log")),
        parallel=ParallelConfig(data=1))


def _leaves(f) -> dict:
    opt = f["opt"]._asdict() if hasattr(f["opt"], "_asdict") else f["opt"]
    tree = {"params": f["params"], "state": f["model_state"],
            "mu": opt["mu"], "nu": opt["nu"]}
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    usef = _dense_cloud_file(str(tmp / "dense3.usef"), 6, seed=3)
    return tmp, _cfg(tmp, usef)


def test_loader_rows_are_events_times_planes(dense):
    """A 6-row batch holds 2 events x 3 planes, event-major, in both
    loaders, bit-equal."""
    _, cfg = dense
    jb = JaxBatchLoader(cfg.data, num_class=3)._make_batch()
    pb = BatchLoader(PortDataConfig(**dataclasses.asdict(cfg.data)),
                     num_class=3)._make_batch()
    assert jb.keys() == pb.keys()
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    assert pb["values"].shape[0] == 6


def test_trainer_steps_match_jax_at_three_planes(dense):
    """Three train steps of 6 rows (2 events x 3 planes) from the same
    initial state: the losses at 1e-5; params, BN state and Adam moments
    after the first step at 1e-4."""
    tmp, cfg = dense
    jtr = JaxTrainer(cfg, mesh=make_mesh(1))
    jts = jtr.init_state()
    ts0 = jax.device_get(jts)
    loader = JaxBatchLoader(cfg.data, num_class=3)
    batches, jloss = [], []
    for i in range(3):
        b = loader._make_batch()
        b.pop("cursor")
        batches.append(b)
        jts, m = jtr.train_step(jts, jtr._device_batch(b))
        jloss.append(float(m["loss"]))
        if i == 0:
            want = _leaves(jax.device_get(jts)._asdict())

    tr = Trainer(cfg, device="cpu")
    ts = tr.init_state()
    opt, key = load_jax_train_state(ts.model, ts0)
    ts = dataclasses.replace(ts, opt=opt, key=key)
    for i, b in enumerate(batches):
        ts, m = tr.train_step(ts, tr.device_batch(b))
        assert float(m["loss"]) == pytest.approx(jloss[i], rel=1e-5), i
        if i == 0:
            got = _leaves(jax_train_state(ts.model, ts.opt, ts.key))
    assert got.keys() == want.keys()
    moment_max = {kind: max(np.abs(v).max() for k, v in want.items()
                            if k.startswith(kind + ".")) for kind in ("mu", "nu")}
    for k, v in want.items():
        scale = moment_max.get(k.split(".")[0], max(np.abs(v).max(), 1.0))
        np.testing.assert_allclose(got[k] / scale, v / scale, rtol=0,
                                   atol=TOL, err_msg=k)


def test_augmented_three_plane_batch_flips_each_row(dense):
    """With augment on, a 6-row batch draws one decision column per row (2
    events x 3 planes), and the in-scatter augmentation equals the dense
    augmentation of the same decisions, bit for bit."""
    _, cfg = dense
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                            augment=True))
    tr = Trainer(cfg, device="cpu")
    b = BatchLoader(PortDataConfig(**dataclasses.asdict(cfg.data)),
                    num_class=3)._make_batch()
    b.pop("cursor")
    batch = tr.device_batch(b)
    dec = torch.tensor([[1, 0, 1, 1, 0, 0], [0, 1, 1, 0, 1, 0],
                        [1, 1, 0, 0, 0, 1]], dtype=torch.bool)
    got = tr._prepare(batch, dec)
    want = augment_batch(tr._prepare(batch), dims=2, decisions=dec)
    for k in ("data", "label", "weight"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    ts = tr.init_state()
    ts, m = tr.train_step(ts, batch)
    assert math.isfinite(float(m["loss"]))


@pytest.fixture(scope="module")
def ana(tmp_path_factory):
    """5 synthetic 3-plane events of 128^2 at image 64, batch 6 (2 events):
    the last batch's wrapped event is masked."""
    tmp = tmp_path_factory.mktemp("mpana")
    usef = generate_file(str(tmp / "ana3.usef"), 5, seed=21,
                         shape=(128, 128), planes=PLANES)
    cfg = _cfg(tmp, usef, image_size=64)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, max_points=4096))
    jtr = JaxTrainer(cfg, mesh=make_mesh(1))
    jts = jtr.init_state()
    x = np.random.default_rng(1).uniform(0, 1, (3, 64, 64, 1)).astype(np.float32)
    _, state = uresnet_apply(jts.params, jts.model_state, x, cfg=cfg.model,
                             train=True)
    # a decisive background, as in tests/test_torch_ana.py
    head = dict(jts.params["head"], b=jts.params["head"]["b"]
                + np.float32([0.15, 0, 0]))
    jts = jts._replace(model_state=state, params=dict(jts.params, head=head))
    return cfg, jtr, jts


def _port_state(cfg, jts):
    tr = Trainer(cfg, device="cpu")
    ts = tr.init_state()
    j = jax.device_get(jts)
    load_jax_params(ts.model, j.params, j.model_state)
    return tr, ts


def test_evaluate_dataset_three_planes_matches_jax(ana):
    """evaluate_dataset exactly once at 3 planes: n_events 5, n_pixels
    5 x 3 x 64^2, n_nonzero exact, the metrics the JAX package's."""
    cfg, jtr, jts = ana
    want = jev.evaluate_dataset(jtr, jts)
    tr, ts = _port_state(cfg, jts)
    got = tevl.evaluate_dataset(tr, ts)
    assert got["n_events"] == want["n_events"] == 5
    assert got["n_pixels"] == want["n_pixels"] == 5 * 3 * 64 * 64
    assert got["n_nonzero"] == want["n_nonzero"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5, abs=METRIC_TOL), k


def test_sampled_evaluation_three_planes_matches_jax(ana):
    cfg, jtr, jts = ana
    want = jev.evaluate_dataset(jtr, jts, num_batches=2)
    tr, ts = _port_state(cfg, jts)
    got = tevl.evaluate_dataset(tr, ts, num_batches=2)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5, abs=METRIC_TOL), k


# -- the sharded loader (tests/test_multihost_shard.py's three cases) -----------


def _shard_cfg(path, batch, planes=(0,)):
    return PortDataConfig(image_size=64, batch_size=batch, planes=planes,
                          input_files=(path,), synthetic=False,
                          random_access=False, transfer="sparse",
                          max_points=512)


@pytest.mark.parametrize("planes", [(0,), PLANES])
def test_port_shards_partition_events_as_jax(tmp_path, planes):
    """Two shards read disjoint events that together make the one-process
    batch, each half of its rows, and each shard's batch is the JAX
    loader's for the same shard, bit-equal."""
    path = generate_file(str(tmp_path / "s.usef"), 8, seed=2,
                         shape=(128, 128), planes=planes)
    batch = 4 * len(planes)
    cfg = _shard_cfg(path, batch, planes)
    full = BatchLoader(cfg, num_class=3)._make_batch()
    shards = [BatchLoader(cfg, num_class=3, shard=(r, 2))._make_batch()
              for r in (0, 1)]
    assert full["values"].shape[0] == batch
    assert all(b["values"].shape[0] == batch // 2 for b in shards)

    def sig(b):
        return {tuple(np.asarray(b["values"][i][:8]))
                for i in range(b["values"].shape[0])}

    assert sig(shards[0]) | sig(shards[1]) == sig(full)
    assert not (sig(shards[0]) & sig(shards[1]))
    jcfg = DataConfig(**dataclasses.asdict(cfg))
    for r, got in enumerate(shards):
        want = JaxBatchLoader(jcfg, num_class=3, shard=(r, 2))._make_batch()
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} r{r}")


def test_port_cxx_shard_matches_python(tmp_path):
    from uresnet_tpu_torch.data import cxx_decoder

    if not cxx_decoder.available():
        pytest.skip("liburesnet_decoder.so not built — run `make -C cxx/decoder`")
    path = generate_file(str(tmp_path / "sc.usef"), 8, seed=4,
                         shape=(128, 128), planes=(0,))
    for rank in (0, 1):
        cfg = _shard_cfg(path, 4)
        py = BatchLoader(cfg, num_class=3, shard=(rank, 2))
        cx = cxx_decoder.CxxBatchLoader(cfg, num_class=3,
                                        shard=(rank, 2)).start(1)
        a, b = py._make_batch(), cx.next()
        for k in ("coords", "values", "labels", "npoints", "shape"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} r{rank}")
        cx.stop()
        cx.close()


def test_port_shard_divisibility_error(tmp_path):
    path = generate_file(str(tmp_path / "s2.usef"), 6, seed=3,
                         shape=(128, 128), planes=(0,))
    with pytest.raises(ValueError, match="divisible"):
        BatchLoader(_shard_cfg(path, 3), num_class=3, shard=(0, 2))
