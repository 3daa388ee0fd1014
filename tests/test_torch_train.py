"""The port's training pieces vs the JAX package (or its numpy oracle) on the
CPU: losses, metrics, Adam/RMSProp with schedules, freeze and clip, the
on-device densify and augmentation, and batch staging.

Inputs are made with numpy from a seed and handed to both packages; the
tolerance is stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uresnet_tpu.config import OptimConfig
from uresnet_tpu.data.device_pipeline import crop_origin as jax_crop_origin
from uresnet_tpu.data.events import SparseEvent, SparsePlane
from uresnet_tpu.data.pipeline import densify_batch, sparse_batch
from uresnet_tpu.data.synthetic import generate_event
from uresnet_tpu.engine import losses as jlosses
from uresnet_tpu.engine import metrics as jmetrics
from uresnet_tpu.engine import optim as joptim
from uresnet_tpu_torch.data import device_pipeline as dp
from uresnet_tpu_torch.data.prefetch import device_prefetch
from uresnet_tpu_torch.engine import losses, metrics, optim
from uresnet_tpu_torch.engine.augment import augment_batch
from uresnet_tpu_torch.models.convert import flatten_tree as flat

T = torch.from_numpy


# -- losses and metrics --------------------------------------------------------

@pytest.mark.parametrize("normalize", ["mean", "weight_sum"])
def test_losses_match_jax(rng, normalize):
    """Per-pixel xent and the weighted loss, f32, 1e-6 relative."""
    logits = (rng.standard_normal((2, 6, 5, 3)) * 3).astype(np.float32)
    labels = rng.integers(0, 3, (2, 6, 5)).astype(np.int32)
    weights = rng.uniform(0.1, 2, (2, 6, 5)).astype(np.float32)
    np.testing.assert_allclose(
        losses.softmax_xent_per_pixel(T(logits), T(labels)).numpy(),
        np.asarray(jlosses.softmax_xent_per_pixel(logits, labels)),
        rtol=1e-6, atol=1e-6)
    got = losses.weighted_softmax_xent(T(logits), T(labels), T(weights),
                                       normalize=normalize)
    want = jlosses.weighted_softmax_xent(logits, labels, weights,
                                         normalize=normalize)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match="normalize"):
        losses.weighted_softmax_xent(T(logits), T(labels), T(weights),
                                     normalize="sum")


def test_metrics_match_jax(rng):
    """segmentation_metrics and segmentation_counts, exact counts and f32
    means at 1e-6; a class absent from both pred and label has IoU 1."""
    logits = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    logits[..., 3] -= 10  # class 3: never predicted ...
    labels = rng.integers(0, 3, (3, 8, 8)).astype(np.int32)  # ... nor labelled
    data = (rng.uniform(0, 1, (3, 8, 8, 1)) > 0.6).astype(np.float32)
    row_valid = np.array([1, 1, 0], np.float32)
    got = metrics.segmentation_metrics(T(logits), T(labels), T(data),
                                       num_class=4)
    want = jmetrics.segmentation_metrics(logits, labels, data, num_class=4)
    assert got.keys() == want.keys() and float(got["iou_class3"]) == 1.0
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    got_c = metrics.segmentation_counts(T(logits), T(labels), T(data),
                                        num_class=4, row_valid=T(row_valid))
    want_c = jmetrics.segmentation_counts(logits, labels, data, num_class=4,
                                          row_valid=row_valid)
    assert got_c.keys() == want_c.keys()
    for k in want_c:
        np.testing.assert_array_equal(got_c[k].numpy(), np.asarray(want_c[k]))
    assert (metrics.metrics_from_counts(metrics.reduce_counts(got_c))
            == jmetrics.metrics_from_counts(jmetrics.reduce_counts(want_c)))


# -- optimizer -----------------------------------------------------------------

def _tree(rng):
    return {"stem": {"conv": {"w": rng.standard_normal((3, 3, 1, 4))},
                     "bn": {"scale": rng.uniform(.5, 2, 4),
                            "bias": rng.standard_normal(4)}},
            "head": {"w": rng.standard_normal((3, 3, 4, 3)),
                     "b": rng.standard_normal(3)}}


@pytest.mark.parametrize("kw", [
    dict(),
    dict(schedule="cosine", decay_steps=4, warmup_steps=2),
    dict(schedule="exponential", decay_steps=3, decay_rate=0.5),
    dict(schedule="cosine", decay_steps=5, grad_clip_norm=0.5,
         weight_decay=1e-2),
    dict(freeze=("bn/scale$", "head/b"), weight_decay=1e-2,
         grad_clip_norm=0.5),
    dict(optimizer="rmsprop", schedule="cosine", decay_steps=4,
         warmup_steps=1, weight_decay=1e-2),
    dict(optimizer="rmsprop", freeze=("stem",), grad_clip_norm=0.3),
], ids=["adam", "cosine-warmup", "exponential", "clip-decay", "freeze",
        "rmsprop", "rmsprop-freeze"])
def test_adam_matches_jax(rng, kw):
    """Three updates of the port's optimizer vs adam_update: params, mu, nu
    at 1e-6; frozen leaves and their moments bit for bit untouched."""
    cfg = OptimConfig(lr=0.05, **kw)
    tree = jax.tree.map(lambda a: a.astype(np.float32), _tree(rng))
    names = list(flat(tree))
    jfreeze = joptim.freeze_mask(tree, cfg.freeze) if cfg.freeze else None
    freeze = optim.freeze_mask(names, cfg.freeze) if cfg.freeze else None
    if cfg.freeze:
        assert freeze == flat(jfreeze)
    jp, jopt = tree, joptim.adam_init(tree)
    tp = {k: T(v.copy()) for k, v in flat(tree).items()}
    topt = optim.adam_init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), tree)
        jp, jopt = joptim.adam_update(g, jopt, jp, cfg, freeze=jfreeze)
        gt = {k: T(v) for k, v in flat(g).items()}
        if freeze:
            gt = {k: v for k, v in gt.items() if not freeze[k]}
        old = dict(tp), dict(topt.mu), dict(topt.nu)
        tp, topt = optim.adam_update(gt, topt, tp, cfg, freeze=freeze)
        for k in names:
            if freeze and freeze[k]:
                assert (tp[k] is old[0][k] and topt.mu[k] is old[1][k]
                        and topt.nu[k] is old[2][k])
    assert topt.step == int(jopt.step) == 3
    for got, want in ((tp, jp), (topt.mu, jopt.mu), (topt.nu, jopt.nu)):
        want = jax.device_get(flat(want))
        for k in names:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    sched, jsched = optim.make_schedule(cfg), joptim.make_schedule(cfg)
    for s in (1, 2, 3, 7):
        np.testing.assert_allclose(sched(s), float(jsched(jnp.int32(s))),
                                   rtol=1e-6)


def test_freeze_mask_validation():
    names = ["stem.conv.w", "head.w"]
    with pytest.raises(ValueError, match="match no param leaf"):
        optim.freeze_mask(names, ("nonexistent",))
    with pytest.raises(ValueError, match="EVERY"):
        optim.freeze_mask(names, (".",))
    assert optim.freeze_mask(names, ("^head/w$",)) == {"stem.conv.w": False,
                                                       "head.w": True}


# -- densify and augmentation --------------------------------------------------

def _events(n=3, shape=(128, 128), seed=7):
    rng = np.random.default_rng(seed)
    evs = [generate_event(rng, shape=shape, planes=(0, 1)) for _ in range(n)]
    for ev in evs:
        for pl in ev.planes:
            pl.weights = rng.uniform(0.2, 3.0, len(pl.values)).astype(np.float32)
    return evs


def _dup_event():
    """Points repeat a pixel (later points must win, as in numpy), an empty
    plane, and charge only at zero."""
    coords = np.array([[10, 12], [40, 41], [10, 12], [40, 41], [70, 3]],
                      np.int64)
    dup = SparsePlane(plane_id=0, shape=(96, 80), coords=coords,
                      values=np.array([5., 300., 80., 20., 7.], np.float32),
                      labels=np.array([1, 2, 0, 1, 2], np.int32),
                      weights=np.array([.5, 2, 3, .25, 1], np.float32))
    empty = SparsePlane(plane_id=1, shape=(96, 80),
                        coords=np.zeros((0, 2), np.int64),
                        values=np.zeros(0, np.float32),
                        labels=np.zeros(0, np.int32),
                        weights=np.zeros(0, np.float32))
    return SparseEvent(planes=[dup, empty])


def _np_augment(dense, decisions):
    """numpy reference of the flips / rot90 (engine/augment.py semantics)."""
    out = {}
    for k, a in dense.items():
        a = a.copy()
        for b in range(a.shape[0]):
            for ax in range(2):
                if decisions[ax, b]:
                    a[b] = np.flip(a[b], ax)
            if decisions[2, b]:
                a[b] = np.rot90(a[b], 1, (0, 1))
        out[k] = a
    return out


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("weight_mode,boost", [
    ("class_balance", 1.0), ("ones", 0.0), ("nonzero", 2.0), ("file", 0.0)])
def test_densify_bit_exact_vs_numpy(weight_mode, boost, augment):
    """densify_on_device == data/pipeline.py densify_batch bit for bit, in
    every weight mode; with given augment decisions, == the numpy flips /
    rot90 of the dense images."""
    events = _events() + [_dup_event()]
    kw = dict(image_size=64, normalize_scale=0.01, normalize_clip=5.0,
              weight_mode=weight_mode, num_class=3, nonzero_boost=boost)
    want = densify_batch(events, planes=(0, 1), **kw)
    sp = sparse_batch(events, planes=(0, 1), max_points=4096,
                      with_weights=True)
    decisions = None
    if augment:
        decisions = np.random.default_rng(3).uniform(size=(3, 8)) < 0.5
        want = _np_augment(want, decisions)
        decisions = T(decisions)
    got = dp.densify_on_device({k: T(v) for k, v in sp.items()},
                               decisions=decisions, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_crop_origin_matches_jax():
    sp = sparse_batch(_events(4, seed=9) + [_dup_event()], planes=(0, 1),
                      max_points=4096)
    got = dp.crop_origin({k: T(v) for k, v in sp.items()}, image_size=48)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_crop_origin(sp, image_size=48)))


def test_augment_in_scatter_equals_dense_augment():
    """Decisions drawn from one generator seed, in the one order both paths
    use: augmenting the dense batch == augmenting inside the scatter."""
    sp = {k: T(v) for k, v in sparse_batch(_events(4), planes=(0, 1),
                                            max_points=4096).items()}
    kw = dict(image_size=64, weight_mode="class_balance")
    dense = dp.densify_on_device(sp, **kw)
    a = augment_batch(dense, dims=2,
                      generator=torch.Generator().manual_seed(5))
    d = dp.draw_decisions(torch.Generator().manual_seed(5), 8, 2)
    assert d.shape == (3, 8) and d.any() and not d.all()
    b = dp.densify_on_device(sp, decisions=d, **kw)
    for k in ("data", "label", "weight"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    want = _np_augment({k: v.numpy() for k, v in dense.items()}, d.numpy())
    for k in want:
        np.testing.assert_array_equal(a[k].numpy(), want[k])


def test_device_prefetch_cpu():
    """On the CPU the batches come through in order as tensors over the same
    memory, scalars untouched, the tail drained."""
    batches = [{"x": np.full((2, 3), i, np.float32), "cursor": np.int64(i)}
               for i in range(5)]
    got = list(device_prefetch(iter(batches), device="cpu", depth=2))
    assert [int(b["cursor"]) for b in got] == list(range(5))
    for b, src in zip(got, batches):
        assert torch.is_tensor(b["x"]) and b["x"].data_ptr() == \
            src["x"].__array_interface__["data"][0]
