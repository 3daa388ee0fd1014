"""The port's own copies of the JAX package's jax-free host modules vs the
originals, on the CPU: config, data.{events,pipeline,synthetic,loader,
cxx_decoder,pset_compat} and engine.{logging,tb_writer}.

Every config under configs/ loads to the same fields; generated USEF files
are byte-identical; the batch builders, the epoch order and the loaders'
first batches are equal arrays; the native decoder's ctypes binding
declares the same C layout; the loggers write the same rows and records.
"""

import ctypes
import dataclasses
import glob
import json
import os

import numpy as np
import pytest

from uresnet_tpu import config as jconfig
from uresnet_tpu.data import cxx_decoder as jcxx
from uresnet_tpu.data import events as jevents
from uresnet_tpu.data import loader as jloader
from uresnet_tpu.data import pipeline as jpipeline
from uresnet_tpu.data import pset_compat as jpset
from uresnet_tpu.data import synthetic as jsynthetic
from uresnet_tpu.engine import logging as jlogging
from uresnet_tpu.engine import tb_writer as jtb
from uresnet_tpu_torch import config as tconfig
from uresnet_tpu_torch.data import cxx_decoder as tcxx
from uresnet_tpu_torch.data import events as tevents
from uresnet_tpu_torch.data import loader as tloader
from uresnet_tpu_torch.data import pipeline as tpipeline
from uresnet_tpu_torch.data import pset_compat as tpset
from uresnet_tpu_torch.data import synthetic as tsynthetic
from uresnet_tpu_torch.engine import logging as tlogging
from uresnet_tpu_torch.engine import tb_writer as ttb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p)
                 for p in glob.glob(os.path.join(ROOT, "configs", "*")))


def assert_batches_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


# -- config ---------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_config_loads_alike(name):
    if name.endswith((".yaml", ".yml")):
        pytest.importorskip("yaml")
    path = os.path.join(ROOT, "configs", name)
    overrides = ["optim.lr=3e-4", "BATCH_SIZE=8"]
    assert (dataclasses.asdict(tconfig.load_config(path, overrides))
            == dataclasses.asdict(jconfig.load_config(path, overrides)))


def test_config_json_and_kv_alike(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"model": {"depth": 3, "base_filters": 8},
                             "data": {"planes": [0, 1], "batch_size": 4}}))
    assert (dataclasses.asdict(tconfig.load_config(str(p), ["ITERATIONS=7"]))
            == dataclasses.asdict(jconfig.load_config(str(p), ["ITERATIONS=7"])))
    text = "NUM_CLASS 5\nBASE_NUM_FILTERS 8\nLEARNING_RATE 0.01\n"
    assert (dataclasses.asdict(tconfig.parse_kv_text(text))
            == dataclasses.asdict(jconfig.parse_kv_text(text)))
    for mod in (tconfig, jconfig):
        with pytest.raises(KeyError):
            mod.apply_overrides(mod.Config(), ["bogus.field=1"])


PSET = """
ThreadProcessor: {
  NumThreads:      6
  NumBatchStorage: 8
  RandomAccess:    true
  InputFiles:      ["train0.usef", "train1.usef"]
  ProcessList: {
    train_image:  { ImageProducer: "wire",    Channels: [2] }
  }
}
"""


def test_pset_alike(tmp_path):
    f = tmp_path / "io.cfg"
    f.write_text(PSET)
    assert tpset.parse_pset(PSET) == jpset.parse_pset(PSET)
    a, b = tconfig.DataConfig(), jconfig.DataConfig()
    tpset.apply_pset_io_config(str(f), a)
    jpset.apply_pset_io_config(str(f), b)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


# -- events, synthetic ----------------------------------------------------

@pytest.mark.parametrize("shape,planes", [((64, 64), (0, 2)),
                                          ((24, 24, 24), (0,))])
def test_generate_file_byte_identical(tmp_path, shape, planes):
    a = tsynthetic.generate_file(str(tmp_path / "t.usef"), 5, seed=7,
                                 shape=shape, planes=planes)
    b = jsynthetic.generate_file(str(tmp_path / "j.usef"), 5, seed=7,
                                 shape=shape, planes=planes)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert tsynthetic.GEN_VERSION == jsynthetic.GEN_VERSION
    # each package reads the other's file to the same events
    for x, y in zip(tevents.read_events(b), jevents.read_events(a)):
        assert len(x.planes) == len(y.planes)
        for p, q in zip(x.planes, y.planes):
            assert (p.plane_id, p.shape) == (q.plane_id, q.shape)
            np.testing.assert_array_equal(p.coords, q.coords)
            np.testing.assert_array_equal(p.values, q.values)
            np.testing.assert_array_equal(p.labels, q.labels)
    assert tevents.num_events(a) == jevents.num_events(a) == 5
    ta, ja = tevents.read_header(a), jevents.read_header(a)
    assert ta[:2] == ja[:2]
    np.testing.assert_array_equal(ta[2], ja[2])


# -- pipeline, loader helpers ---------------------------------------------

@pytest.fixture(scope="module")
def events2d():
    rng = np.random.default_rng(3)
    return [jsynthetic.generate_event(rng, shape=(48, 48), planes=(0, 1))
            for _ in range(3)]


@pytest.mark.parametrize("weight_mode", ["ones", "class_balance", "nonzero"])
def test_densify_batch_equal(events2d, weight_mode):
    kw = dict(image_size=32, planes=(0, 1), weight_mode=weight_mode,
              num_class=3, nonzero_boost=2.0)
    assert_batches_equal(tpipeline.densify_batch(events2d, **kw),
                         jpipeline.densify_batch(events2d, **kw))


@pytest.mark.parametrize("max_points", [16, 4096])
def test_sparse_batch_equal(events2d, max_points):
    kw = dict(planes=(1, 0), max_points=max_points, ndims=2)
    assert_batches_equal(tpipeline.sparse_batch(events2d, **kw),
                         jpipeline.sparse_batch(events2d, **kw))


@pytest.mark.parametrize("n,seed,epoch,shuffle",
                         [(1, 0, 0, True), (17, 3, 0, True), (17, 3, 4, True),
                          (9, 1, 2, False)])
def test_epoch_order_equal(n, seed, epoch, shuffle):
    np.testing.assert_array_equal(tloader.epoch_order(n, seed, epoch, shuffle),
                                  jloader.epoch_order(n, seed, epoch, shuffle))


@pytest.mark.parametrize("args", [(8, 2, 1), (12, 3, 2), (4, 1, 4), (6, 4, 1),
                                  (0, 1, 1), (8, 9, 1), (6, 2, 2)])
def test_check_batch_geometry_equal(args):
    def run(fn):
        try:
            return fn(*args)
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(tloader.check_batch_geometry) == run(jloader.check_batch_geometry)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("transfer", ["dense", "sparse"])
def test_batch_loader_first_batches_equal(tmp_path, train, transfer):
    path = jsynthetic.generate_file(str(tmp_path / "ev.usef"), 7, seed=4,
                                    shape=(64, 64), planes=(0, 1))
    kw = dict(image_size=32, batch_size=4, planes=(0, 1), input_files=(path,),
              synthetic=False, random_access=True, seed=13, num_threads=2,
              backend="python", transfer=transfer, max_points=512,
              weight_mode="class_balance")
    a = tloader.make_batch_loader(tconfig.DataConfig(**kw), train=train)
    b = jloader.make_batch_loader(jconfig.DataConfig(**kw), train=train)
    assert type(a).__name__ == type(b).__name__ == "BatchLoader"
    a.start()
    b.start()
    try:
        for _ in range(3):
            assert_batches_equal(a.next(), b.next())
    finally:
        a.stop()
        b.stop()
    assert a.num_events() == b.num_events()


def test_synthetic_input_resolves_alike(tmp_path, monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    kw = dict(image_size=32, synthetic=True, synthetic_events=3, seed=2,
              planes=(0,))
    a = tloader.resolve_input_files(tconfig.DataConfig(**kw), 2)
    b = jloader.resolve_input_files(jconfig.DataConfig(**kw), 2)
    assert a == b  # the same cache file: one generator, one name


# -- cxx_decoder ----------------------------------------------------------

def test_cxx_binding_alike():
    """The same C layout and library search: ``data.backend: auto`` finds
    the same liburesnet_decoder.so (or none) from either package."""
    for s in ("_UrdConfig", "_UrdBatch"):
        ta, ja = getattr(tcxx, s), getattr(jcxx, s)
        assert [(n, t._type_ if hasattr(t, "_type_") else t)
                for n, t in ta._fields_] == [
            (n, t._type_ if hasattr(t, "_type_") else t) for n, t in ja._fields_]
        assert ctypes.sizeof(ta) == ctypes.sizeof(ja)
    assert tcxx._WEIGHT_MODES == jcxx._WEIGHT_MODES
    assert tcxx._LIB_PATHS == jcxx._LIB_PATHS
    assert tcxx.available() == jcxx.available()


# -- logging --------------------------------------------------------------

def test_metrics_logger_alike(tmp_path, monkeypatch):
    monkeypatch.setattr("time.time", lambda: 1_700_000_000.0)
    rows = [(10, {"loss": 0.5, "acc": 0.25}), (20, {"loss": 0.125, "acc": 1.0})]
    for mod, d in ((tlogging, "t"), (jlogging, "j")):
        lg = mod.MetricsLogger(str(tmp_path / d), echo=False)
        for step, m in rows:
            lg.log(step, m)
        lg.close()
    for kind in ("train_metrics.csv", "train_metrics.jsonl"):
        assert ((tmp_path / "t" / kind).read_bytes()
                == (tmp_path / "j" / kind).read_bytes())
    tb = [sorted(glob.glob(str(tmp_path / d / "events.out.tfevents.*")))
          for d in ("t", "j")]
    assert len(tb[0]) == len(tb[1]) == 1
    with open(tb[0][0], "rb") as fa, open(tb[1][0], "rb") as fb:
        assert fa.read() == fb.read()
    assert ttb._masked_crc(b"uresnet") == jtb._masked_crc(b"uresnet")
