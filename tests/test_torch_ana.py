"""The port's analysis surface vs the JAX package's on the CPU.

One JAX checkpoint (depth 2, base 16, f32, non-trivial BN stats) and one
event file of 128x128 planes (two planes, image 64, so the crop moves) go
through the JAX ``run_inference`` / ``evaluate_dataset`` / ``Trainer``
and through the port (kernels run their plain versions on CPU tensors):
every export mode in npz and USEF, the tiled pass, exact and sampled
dataset evaluation and ``train.val_exact``. Integer columns are exact,
scores within 1e-5, ``pred`` equal wherever the top-2 margin exceeds 1e-4,
metrics within 1e-6. Then the port's own invariants: its modes agree bit
for bit, ``readback_group`` changes nothing, and the edge cases.
"""

import ast
import dataclasses
import json

import numpy as np
import pytest

from uresnet_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from uresnet_tpu.data.synthetic import generate_file
from uresnet_tpu.engine import evaluator as jev
from uresnet_tpu.engine.trainer import Trainer as JaxTrainer
from uresnet_tpu.models.uresnet import uresnet_apply
from uresnet_tpu.parallel.mesh import make_mesh
from uresnet_tpu_torch.cli import infer
from uresnet_tpu_torch.config import load_config
from uresnet_tpu_torch.data import events as tev
from uresnet_tpu_torch.engine import evaluator as tevl
from uresnet_tpu_torch.engine.checkpoint import load_serving_state
from uresnet_tpu_torch.engine.trainer import Trainer
from uresnet_tpu_torch.models.convert import load_jax_params

N_EVENTS, N_OTHER = 5, 3     # main file, second file of the dataset
MODES = {"sparse": dict(streamed=True, export="sparse"),
         "dense": dict(streamed=True, export="dense"),
         "host": dict(streamed=False, export="dense")}
METRIC_TOL = 1e-6


def _cfg(tmp, files, **train_kw) -> Config:
    return Config(
        model=ModelConfig(depth=2, base_filters=16, num_class=3,
                          compute_dtype="float32"),
        data=DataConfig(image_size=64, batch_size=4, planes=(0, 1),
                        input_files=tuple(files), synthetic=False,
                        random_access=False, num_threads=2),
        train=TrainConfig(checkpoint_dir=str(tmp / "ckpt"),
                          log_dir=str(tmp / "log"), **train_kw))


@pytest.fixture(scope="module")
def S(tmp_path_factory):
    """The shared setup, and a cache of the JAX package's runs."""
    tmp = tmp_path_factory.mktemp("ana")
    main = generate_file(str(tmp / "ana.usef"), N_EVENTS, seed=21,
                         shape=(128, 128), planes=(0, 1))
    other = generate_file(str(tmp / "other.usef"), N_OTHER, seed=22,
                          shape=(128, 128), planes=(0, 1))
    tiled = generate_file(str(tmp / "tiled.usef"), 3, seed=17,
                          shape=(96, 96), planes=(0, 1))
    cfg = _cfg(tmp, (main, other))
    jtr = JaxTrainer(cfg, mesh=make_mesh(1))
    jts = jtr.init_state()
    # non-trivial BN running stats, so the fold matters
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    _, state = uresnet_apply(jts.params, jts.model_state, x, cfg=cfg.model,
                             train=True)
    # a decisive background, as a trained net's: the untrained head leaves
    # background pixels whose top two classes tie in f32, where the two
    # packages' last-bit differences flip the argmax (and the metrics)
    head = dict(jts.params["head"], b=jts.params["head"]["b"]
                + np.float32([0.15, 0, 0]))
    jts = jts._replace(model_state=state, params=dict(jts.params, head=head))
    ckpt = jtr.save(jts, 3)
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    return dict(tmp=tmp, main=main, other=other, tiled=tiled, cfg=cfg,
                cfg_path=str(cfg_path), ckpt=ckpt, jtr=jtr, jts=jts, jax={})


def _jax(S, key, fn):
    if key not in S["jax"]:
        S["jax"][key] = fn()
    return S["jax"][key]


def jax_export(S, mode, fmt, tiled=False):
    src = S["tiled"] if tiled else S["main"]
    out = str(S["tmp"] / f"jax_{mode}_{tiled}.{fmt}")
    kw = {} if tiled else MODES[mode]
    stats = _jax(S, (mode, fmt, tiled), lambda: jev.run_inference(
        S["jtr"], S["jts"], src, out, fmt=fmt, tiled=tiled, **kw))
    return out, stats


def port(S, **overrides):
    """The port's trainer and state on the CPU, from the JAX checkpoint."""
    cfg = load_config(S["cfg_path"], [f"{k}={v}" for k, v in overrides.items()])
    tr = Trainer(cfg, device="cpu")
    ts = tr.init_state()
    params, state, _ = load_serving_state(S["ckpt"])
    load_jax_params(ts.model, params, state)
    return tr, ts


def port_export(S, mode, fmt, tiled=False, name=None, **kw):
    tr, ts = port(S)
    src = S["tiled"] if tiled else S["main"]
    out = str(S["tmp"] / f"{name or 'port'}_{mode}_{tiled}.{fmt}")
    mode_kw = {} if tiled else MODES[mode]
    stats = tevl.run_inference(tr, ts, src, out, fmt=fmt, tiled=tiled,
                               **mode_kw, **kw)
    return out, stats


def assert_metrics(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=METRIC_TOL), k


def assert_npz_close(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    assert set(got.files) == set(want.files)
    for k in ("event_id", "plane_id", "coords", "label"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
    top2 = np.sort(want["scores"], axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got["pred"][clear], want["pred"][clear])
    np.testing.assert_array_equal(got["pred"], got["scores"].argmax(1))
    return len(want["scores"])


def assert_usef_close(got_path, want_path, num_class=3):
    """Score planes read back with the port's events reader: same plane ids
    and shapes, coords exact, scores within 1e-5, labels (the predicted
    class) equal wherever the top-2 margin exceeds 1e-4."""
    got, want = tev.read_events(got_path), tev.read_events(want_path)
    assert len(got) == len(want) > 0
    n = 0
    for ge, we in zip(got, want):
        assert [p.plane_id for p in ge.planes] == [p.plane_id for p in we.planes]
        for gp, wp in zip(ge.planes, we.planes):
            assert tuple(gp.shape) == tuple(wp.shape)
            np.testing.assert_array_equal(gp.coords, wp.coords)
            np.testing.assert_allclose(gp.values, wp.values, rtol=0, atol=1e-5)
        for i in range(0, len(we.planes), num_class):
            sc = np.stack([p.values for p in we.planes[i:i + num_class]], 1)
            top2 = np.sort(sc, axis=1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > 1e-4
            np.testing.assert_array_equal(ge.planes[i].labels[clear],
                                          we.planes[i].labels[clear])
            n += len(sc)
    return n


def assert_files_equal(a, b):
    """Bit-equal exports: every npz array, or the USEF file's bytes."""
    if a.endswith(".npz"):
        za, zb = np.load(a), np.load(b)
        assert za.files == zb.files
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=(a, b, k))
        return
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


# -- parity with the JAX package ------------------------------------------------


def test_scores_at_points_matches_jax():
    """The per-point gather over random scores, bit for bit, with crops that
    move, padded points and points outside the window."""
    import jax.numpy as jnp
    import torch

    from uresnet_tpu.data.device_pipeline import scores_at_points as jsap
    from uresnet_tpu_torch.data.device_pipeline import scores_at_points
    from uresnet_tpu_torch.data.pipeline import sparse_batch
    from uresnet_tpu_torch.data.synthetic import generate_event

    rng = np.random.default_rng(5)
    evs = [generate_event(rng, shape=(100, 100), planes=(0,)) for _ in range(4)]
    b = sparse_batch(evs, planes=(0,), max_points=1024, ndims=2)
    scores = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jsap({k: jnp.asarray(v) for k, v in b.items()},
                           jnp.asarray(scores), image_size=32))
    got = scores_at_points({k: torch.from_numpy(v) for k, v in b.items()},
                           torch.from_numpy(scores), image_size=32)
    assert got.shape == (4, 1024, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fmt", ["npz", "usef"])
def test_export_matches_jax(S, mode, fmt):
    want_path, want = jax_export(S, mode, fmt)
    got_path, got = port_export(S, mode, fmt)
    assert_metrics(got, want)
    assert got["n_events"] == N_EVENTS
    if fmt == "npz":
        assert assert_npz_close(got_path, want_path) == got["n_pixels"] > 0
    else:
        assert assert_usef_close(got_path, want_path) > 0


@pytest.mark.parametrize("fmt", ["npz", "usef"])
def test_tiled_matches_jax(S, fmt):
    """96x96 planes at image 64: clamped tiles that overlap, context points
    in windows they are not owned by; every charge point scored."""
    want_path, want = jax_export(S, "tiled", fmt, tiled=True)
    got_path, got = port_export(S, "tiled", fmt, tiled=True)
    assert_metrics(got, want)
    assert got["n_tiles"] == want["n_tiles"] > 3 * 2
    if fmt == "npz":
        assert assert_npz_close(got_path, want_path) == got["n_pixels"]
    else:
        n = sum(len(p.values) for e in tev.read_events(S["tiled"])
                for p in e.planes if p.plane_id in (0, 1))
        assert assert_usef_close(got_path, want_path) == n


def test_usef_writeback_is_the_npz_scores(S):
    """The default USEF writeback: plane ids p*num_class+cls, the in-window
    points in detector coords (file order), labels their argmax, values
    the npz scores at the exported pixels (npz coords are window coords:
    the host window, equal to the device's, maps them)."""
    from uresnet_tpu_torch.data.pipeline import crop_or_pad_coords

    usef, _ = port_export(S, "sparse", "usef")
    npz, _ = port_export(S, "sparse", "npz")
    z = np.load(npz)
    back, inputs = tev.read_events(usef), tev.read_events(S["main"])
    hits = 0
    for eidx, (eo, ei) in enumerate(zip(back, inputs)):
        by_id = {p.plane_id: p for p in eo.planes}
        assert sorted(by_id) == list(range(6))
        for pin in ei.planes:
            cls = [by_id[tevl.score_plane_id(pin.plane_id, c, 3)]
                   for c in range(3)]
            shifted, inwin = crop_or_pad_coords(pin.coords, pin.shape, 64,
                                                values=pin.values)
            sc = np.stack([p.values for p in cls], 1)
            for p in cls:
                np.testing.assert_array_equal(p.coords, pin.coords[inwin])
            np.testing.assert_array_equal(cls[0].labels, sc.argmax(1))
            at = dict(zip(map(tuple, shifted[inwin].tolist()), sc))
            sel = (z["event_id"] == eidx) & (z["plane_id"] == pin.plane_id)
            for c, s in zip(z["coords"][sel].tolist(), z["scores"][sel]):
                np.testing.assert_array_equal(at[tuple(c)], s)
                hits += 1
    assert hits == len(z["scores"]) > 0


def test_evaluate_dataset_exact_matches_jax(S):
    """Both files of the dataset exactly once: 8 events at 2 per batch over
    two files; n_events, n_pixels, n_nonzero exact."""
    want = _jax(S, "exact", lambda: jev.evaluate_dataset(S["jtr"], S["jts"]))
    tr, ts = port(S)
    got = tevl.evaluate_dataset(tr, ts)
    n = N_EVENTS + N_OTHER
    assert got["n_events"] == want["n_events"] == n
    assert got["n_pixels"] == want["n_pixels"] == n * 2 * 64 * 64
    assert got["n_nonzero"] == want["n_nonzero"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5, abs=METRIC_TOL), k


def test_evaluate_dataset_exact_masks_wrapped_tail(S):
    """The main file alone: 5 events at 2 per batch, the last batch's
    wrapped row masked; the same counts as the streamed sparse pass."""
    tr, ts = port(S, **{"data.input_files": S["main"]})
    got = tevl.evaluate_dataset(tr, ts)
    ref = port_export(S, "sparse", "npz", name="tail")[1]
    assert got["n_events"] == N_EVENTS
    assert got["n_pixels"] == N_EVENTS * 2 * 64 * 64
    for k in ("acc_all", "acc_nonzero", "miou"):
        assert got[k] == pytest.approx(ref[k], abs=1e-12), k


def test_evaluate_dataset_sampled_matches_jax(S):
    want = _jax(S, "sampled", lambda: jev.evaluate_dataset(
        S["jtr"], S["jts"], num_batches=3))
    tr, ts = port(S)
    got = tevl.evaluate_dataset(tr, ts, num_batches=3)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5, abs=METRIC_TOL), k


def test_val_exact_validation_matches_jax(S):
    """Trainer.validate with train.val_exact (and the weight_sum loss) is
    the exactly-once pass in both packages."""
    cfg = dataclasses.replace(S["cfg"], train=dataclasses.replace(
        S["cfg"].train, val_exact=True, loss_normalize="weight_sum"))
    jtr = JaxTrainer(cfg, mesh=make_mesh(1))
    want = jtr.validate(S["jts"], num_batches=1)
    tr, ts = port(S, **{"train.val_exact": True,
                        "train.loss_normalize": "weight_sum"})
    got = tr.validate(ts, num_batches=1)
    assert got["n_events"] == want["n_events"] == N_EVENTS + N_OTHER
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5, abs=METRIC_TOL), k


def test_sampled_validation_matches_jax(S):
    """Trainer.validate without val_exact: k sampled held-out batches
    through the one eval step (the folded forward), as evaluate_dataset's
    sampled mode."""
    want = S["jtr"].validate(S["jts"], num_batches=2)
    tr, ts = port(S)
    got = tr.validate(ts, num_batches=2)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5, abs=METRIC_TOL), k


def test_cli_metrics_only_input_matches_jax(S, capsys):
    """--metrics-only --input evaluates that file alone, exactly once."""
    want = _jax(S, "exact_main", lambda: jev.evaluate_dataset(
        JaxTrainer(dataclasses.replace(S["cfg"], data=dataclasses.replace(
            S["cfg"].data, input_files=(S["main"],))), mesh=make_mesh(1)),
        S["jts"]))
    assert infer.main([S["cfg_path"], "--checkpoint", S["ckpt"],
                       "--metrics-only", "--input", S["main"],
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "restored step 3"
    got = ast.literal_eval(lines[-1].split(": ", 1)[1])
    assert got["n_events"] == N_EVENTS
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5, abs=METRIC_TOL), k


def test_cli_usef_and_tiled_match_jax(S, capsys):
    """The CLI's --format usef (default streamed sparse) and --tiled."""
    out = str(S["tmp"] / "cli.usef")
    assert infer.main([S["cfg_path"], "--checkpoint", S["ckpt"], "--input",
                       S["main"], "--output", out, "--format", "usef",
                       "--device", "cpu"]) == 0
    assert_usef_close(out, jax_export(S, "sparse", "usef")[0])
    out = str(S["tmp"] / "cli_tiled.npz")
    assert infer.main([S["cfg_path"], "--checkpoint", S["ckpt"], "--input",
                       S["tiled"], "--output", out, "--tiled",
                       "--readback-group", "1", "--device", "cpu"]) == 0
    want_path, want = jax_export(S, "tiled", "npz", tiled=True)
    assert_npz_close(out, want_path)
    got = ast.literal_eval(capsys.readouterr().out.splitlines()[-1]
                           .split(": ", 1)[1])
    assert got["n_tiles"] == want["n_tiles"]


# -- the port's own invariants ----------------------------------------------------


@pytest.mark.parametrize("fmt", ["npz", "usef"])
def test_modes_agree_bit_for_bit(S, fmt):
    """sparse == dense == host: the same forward over a bit-exact densify."""
    paths = {m: port_export(S, m, fmt, name="eq")[0] for m in MODES}
    assert_files_equal(paths["sparse"], paths["dense"])
    assert_files_equal(paths["sparse"], paths["host"])


@pytest.mark.parametrize("k", [1, 2, 16])
@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_readback_group_is_invisible(S, mode, k):
    base, m0 = port_export(S, mode, "npz", name="rbbase", readback_group=4)
    got, m1 = port_export(S, mode, "npz", name=f"rb{k}", readback_group=k)
    assert m0 == m1
    assert_files_equal(got, base)


@pytest.mark.parametrize("fmt", ["npz", "usef"])
def test_empty_file(S, tmp_path, fmt):
    tr, ts = port(S)
    path = str(tmp_path / "empty.usef")
    tev.write_events(path, [], ndims=2)
    out = str(tmp_path / f"out.{fmt}")
    m = tevl.run_inference(tr, ts, path, out, fmt=fmt)
    assert m["n_events"] == 0 and m["n_pixels"] == 0
    assert m["acc_all"] == 0.0 and m["miou"] == 1.0
    if fmt == "npz":
        z = np.load(out)
        assert len(z["event_id"]) == 0 and z["scores"].shape == (0, 3)
    else:
        assert tev.num_events(out) == 0


@pytest.mark.parametrize("mode", ["sparse", "dense", "host", "tiled"])
def test_out_of_range_label_raises(S, tmp_path, mode):
    planes = [tev.SparsePlane(plane_id=pid, shape=(128, 128),
                              coords=np.array([[5, 5], [6, 7]], np.int32),
                              values=np.array([1.0, 2.0], np.float32),
                              labels=np.array([1, 7], np.uint8))
              for pid in (0, 1)]
    bad = str(tmp_path / "bad.usef")
    tev.write_events(bad, [tev.SparseEvent(planes=planes)] * 2, ndims=2)
    tr, ts = port(S)
    kw = dict(tiled=True) if mode == "tiled" else MODES[mode]
    with pytest.raises(ValueError, match="num_class"):
        tevl.run_inference(tr, ts, bad, str(tmp_path / "o.npz"), **kw)


def _one_plane_port(S, path, **data):
    return port(S, **{"data.planes": 0, "data.input_files": path, **data})


def test_busy_event_never_truncated(S, tmp_path):
    """An event with more points than data.max_points: the streamed pad is
    sized from the file, so every mode exports all of it."""
    rng = np.random.default_rng(3)
    planes = []
    for npts in (700, 80):
        cs = rng.choice(64 * 64, npts, replace=False)
        planes.append(tev.SparsePlane(
            plane_id=0, shape=(128, 128),
            coords=np.stack([32 + cs // 64, 32 + cs % 64], 1).astype(np.int32),
            values=rng.uniform(1, 50, npts).astype(np.float32),
            labels=rng.integers(0, 3, npts).astype(np.uint8)))
    path = str(tmp_path / "busy.usef")
    tev.write_events(path, [tev.SparseEvent([p]) for p in planes], ndims=2)
    tr, ts = _one_plane_port(S, path, **{"data.batch_size": 2,
                                         "data.max_points": 256})
    outs, n = {}, set()
    for mode, kw in MODES.items():
        outs[mode] = str(tmp_path / f"{mode}.npz")
        n.add(tevl.run_inference(tr, ts, path, outs[mode], **kw)["n_pixels"])
    # a wire truncated at 256 points could export at most 256 + 80
    assert len(n) == 1 and n.pop() > 600
    assert_files_equal(outs["sparse"], outs["host"])
    assert_files_equal(outs["dense"], outs["host"])


def test_colliding_points_dedupe_last_wins(S, tmp_path):
    coords = np.array([[10, 10], [12, 12], [10, 10], [20, 20]], np.int32)
    values = np.array([5.0, 7.0, 9.0, 0.0], np.float32)   # dup at (10, 10);
    labels = np.array([1, 2, 2, 1], np.uint8)             # (20, 20) no charge
    path = str(tmp_path / "dup.usef")
    tev.write_events(path, [tev.SparseEvent([tev.SparsePlane(
        plane_id=0, shape=(64, 64), coords=coords, values=values,
        labels=labels)])], ndims=2)
    tr, ts = _one_plane_port(S, path, **{"data.batch_size": 1})
    outs = {}
    for mode, kw in MODES.items():
        outs[mode] = str(tmp_path / f"{mode}.npz")
        assert tevl.run_inference(tr, ts, path, outs[mode], **kw)["n_pixels"] == 2
    for mode in ("sparse", "dense"):
        assert_files_equal(outs[mode], outs["host"])
    z = np.load(outs["sparse"])
    assert z["coords"].tolist() == [[10, 10], [12, 12]]
    assert z["label"].tolist() == [2, 2]                  # last wins


@pytest.mark.parametrize("flags", [["--metrics-only"], ["--export", "dense"]],
                         ids=["metrics-only", "explicit-export"])
def test_cli_tiled_usage_errors(S, capsys, flags):
    with pytest.raises(SystemExit) as e:
        infer.main([S["cfg_path"], "--checkpoint", S["ckpt"], "--input",
                    S["main"], "--tiled", "--device", "cpu", *flags])
    assert e.value.code == 2
    assert "--tiled" in capsys.readouterr().err
