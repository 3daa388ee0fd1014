"""The port's packed U-ResNet (uresnet_tpu_torch/models/packed.py), the
packed loss targets and the packed train step vs the JAX package on the
CPU, case for case of tests/test_packed_model.py.

Weights come from the JAX ``uresnet_init`` (BN state warmed by one JAX
train forward) and are carried across with ``load_jax_params``; inputs
are made with numpy from a seed. Each packed forward is held against the
port's canonical forward and against ``uresnet_apply(pack=True)`` (the
JAX ``uresnet_apply_packed``): f32 logits within 1e-4 of their max, new
BN state within 1e-4, every parameter's gradient within 1e-4 of the
leaf's max. The packed densify is bit-equal to the JAX package's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uresnet_tpu.config import (Config, DataConfig, ModelConfig, OptimConfig,
                                ParallelConfig, TrainConfig)
from uresnet_tpu.data.device_pipeline import densify_on_device as jax_densify
from uresnet_tpu.data.pipeline import sparse_batch
from uresnet_tpu.data.synthetic import generate_event
from uresnet_tpu.engine.losses import weighted_softmax_xent as jax_xent
from uresnet_tpu.engine.trainer import Trainer as JaxTrainer
from uresnet_tpu.models import packed as jpacked
from uresnet_tpu.models.uresnet import uresnet_apply, uresnet_init
from uresnet_tpu.parallel.mesh import make_mesh
from uresnet_tpu_torch.data import device_pipeline as dp
from uresnet_tpu_torch.engine.losses import weighted_softmax_xent
from uresnet_tpu_torch.engine.trainer import Trainer
from uresnet_tpu_torch.models import packed
from uresnet_tpu_torch.models import uresnet as uresnet_mod
from uresnet_tpu_torch.models.convert import (flatten_tree, jax_train_state,
                                              load_jax_params,
                                              load_jax_train_state)
from uresnet_tpu_torch.models.uresnet import UResNet
from uresnet_tpu_torch.parallel.mesh import Mesh

T = torch.from_numpy
TOL = 1e-4
BASE = ModelConfig(depth=2, base_filters=4, num_class=3,
                   compute_dtype="float32")


def _japply(params, state, x, *, cfg, train, packed_logits=False):
    """``uresnet_apply`` under jit: one CPU compile instead of one per
    primitive."""
    return jax.jit(functools.partial(uresnet_apply, cfg=cfg, train=train,
                                     packed_logits=packed_logits))(
        params, state, x)


def _setup(cfg, shape, seed=21):
    """JAX params, a warmed BN state and an input of ``shape``."""
    rng = np.random.default_rng(seed)
    params, state = uresnet_init(jax.random.PRNGKey(seed),
                                 dataclasses.replace(cfg, pack=False))
    warm = rng.uniform(0, 1, shape).astype(np.float32)
    _, state = _japply(params, state, warm, cfg=dataclasses.replace(
        cfg, pack=False), train=True)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    return jax.device_get(params), jax.device_get(state), x


def _model(cfg, params, state):
    model = UResNet(cfg, generator=torch.Generator().manual_seed(0))
    load_jax_params(model, params, state)
    return model


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _states_close(got, want):
    g, w = flatten_tree(got), flatten_tree(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                   rtol=TOL, atol=1e-6, err_msg=k)


def _forward_three_ways(cfg, params, state, x, train):
    """(port packed, port canonical, JAX packed) logits and states."""
    with torch.no_grad():
        lp, sp = _model(cfg, params, state)(T(x), train=train)
        lc, sc = _model(dataclasses.replace(cfg, pack=False), params,
                        state)(T(x), train=train)
    lj, sj = _japply(params, state, x, cfg=cfg, train=train)
    return (lp, sp), (lc, sc), (np.asarray(lj), jax.device_get(sj))


@pytest.mark.parametrize("extra_h", [False, True], ids=["s2d", "s2d+h"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_packed_equals_canonical(train, extra_h):
    cfg = dataclasses.replace(BASE, pack=True, pack_extra_h=extra_h)
    params, state, x = _setup(cfg, (2, 16, 16, 1))
    (lp, sp), (lc, sc), (lj, sj) = _forward_three_ways(cfg, params, state, x,
                                                       train)
    assert lp.dtype == torch.float32 and lp.shape == (2, 16, 16, 3)
    _close(lp, lc.numpy(), what="packed vs canonical")
    _close(lp, lj, what="packed vs JAX packed")
    _states_close(sp, flatten_tree(sc))
    _states_close(sp, sj)


def _grads(model, x, tgt):
    logits, _ = model(T(x), train=True)
    torch.mean((logits - T(tgt)) ** 2).backward()
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


def test_packed_grads_match():
    """Gradients to the canonical parameters through the on-the-fly
    packing equal the canonical forward's and ``jax.grad`` of the JAX
    packed forward's."""
    cfg = dataclasses.replace(BASE, pack=True, pack_extra_h=True)
    params, state, x = _setup(cfg, (2, 16, 16, 1), seed=23)
    tgt = np.random.default_rng(25).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    gp = _grads(_model(cfg, params, state), x, tgt)
    gc = _grads(_model(dataclasses.replace(cfg, pack=False), params, state),
                x, tgt)

    def loss(p):
        lg, _ = uresnet_apply(p, state, x, cfg=cfg, train=True)
        return jnp.mean((lg - tgt) ** 2)

    gj = flatten_tree(jax.device_get(jax.jit(jax.grad(loss))(params)))
    assert gp.keys() == gj.keys()
    for k in gj:
        _close(gp[k], gc[k], what=f"{k} vs canonical")
        _close(gp[k], gj[k], what=f"{k} vs JAX")


@pytest.mark.parametrize("dims,shape", [(2, (2, 32, 32, 1)),
                                        (3, (1, 16, 16, 16, 1))],
                         ids=["2d+h", "3d"])
def test_packed_grads_float64(dims, shape):
    """The float64 model chip_smoke.py's packed check runs (config
    ``compute_dtype=torch.float64``, BN statistics in f64): packed and
    canonical gradients of the weighted xent agree per leaf to 1e-10 of
    the leaf's max (f64 rounding, ~1e-14 here; f32 reads ~5e-6)."""
    cfg = dataclasses.replace(BASE, dims=dims, pack=True, pack_extra_h=True,
                              compute_dtype=torch.float64)
    params, state, x = _setup(dataclasses.replace(cfg, compute_dtype="float32"),
                              shape, seed=27)
    rng = np.random.default_rng(29)
    label = T(rng.integers(0, 3, shape[:-1]))
    weight = T(rng.uniform(0.5, 1.5, shape[:-1]))
    grads = []
    for pack in (True, False):
        model = _model(dataclasses.replace(cfg, pack=pack), params,
                       state).double()
        logits, new_state = model(T(x).double(), train=True)
        assert new_state["stem"]["bn"]["mean"].dtype == torch.float64
        weighted_softmax_xent(logits, label, weight).backward()
        grads.append({k: p.grad.numpy() for k, p in model.named_parameters()})
    for k in grads[1]:
        _close(grads[0][k], grads[1][k], tol=1e-10, what=k)


def test_packed_deeper_partial_packing(monkeypatch):
    """depth 3, base 16, threshold 64: levels 0 and 1 packed, level 2 and
    the bottleneck not; eval and train."""
    cfg = ModelConfig(depth=3, base_filters=16, num_class=2,
                      compute_dtype="float32", pack=True)
    assert [packed._packed_level(cfg, lvl) for lvl in range(3)] == [
        True, True, False]
    params, state, x = _setup(cfg, (1, 32, 32, 1), seed=26)
    levels = []
    real = packed.space_to_depth
    monkeypatch.setattr(packed, "space_to_depth",
                        lambda h, dims: levels.append(h.shape[1]) or real(h, dims=dims))
    for train in (False, True):
        levels.clear()
        (lp, sp), (lc, _), (lj, sj) = _forward_three_ways(cfg, params, state, x,
                                                          train)
        assert levels == [32, 16]  # the stem's input and level 1's
        _close(lp, lc.numpy(), what="packed vs canonical")
        _close(lp, lj, what="packed vs JAX packed")
        _states_close(sp, sj)


def test_packed_3d_equals_canonical():
    cfg = ModelConfig(dims=3, depth=2, base_filters=4, num_class=3,
                      compute_dtype="float32", pack=True)
    params, state, x = _setup(cfg, (1, 16, 16, 16, 1), seed=31)
    for train in (False, True):
        (lp, sp), (lc, sc), (lj, sj) = _forward_three_ways(cfg, params, state,
                                                           x, train)
        _close(lp, lc.numpy(), what="packed vs canonical")
        _close(lp, lj, what="packed vs JAX packed")
        _states_close(sp, flatten_tree(sc))
        _states_close(sp, sj)


@pytest.fixture(scope="module")
def remat_case():
    cfg = dataclasses.replace(BASE, pack=True, pack_extra_h=True)
    params, state, x = _setup(cfg, (1, 16, 16, 1), seed=28)

    def loss(p):
        lg, s = uresnet_apply(p, state, x, cfg=dataclasses.replace(
            cfg, remat=True), train=True)
        return jnp.mean(lg ** 2), s

    (_, sj), gj = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return cfg, params, state, x, flatten_tree(jax.device_get(gj)), \
        jax.device_get(sj)


@pytest.mark.parametrize("remat", ["none", "level", "block"])
def test_packed_remat(remat_case, remat):
    """Each remat mode's packed gradients equal the JAX package's (which
    remats by level); the recompute reruns the packing and BN, and the
    forward writes no buffer: the new stats come back once."""
    cfg, params, state, x, gj, sj = remat_case
    model = _model(dataclasses.replace(
        cfg, remat=False if remat == "none" else remat), params, state)
    before = {k: v.clone() for k, v in model.named_buffers()}
    logits, new_state = model(T(x), train=True)
    torch.mean(logits ** 2).backward()
    for k, p in model.named_parameters():
        assert np.isfinite(p.grad.numpy()).all(), k
        _close(p.grad, gj[k], what=k)
    _states_close(new_state, sj)
    for k, v in model.named_buffers():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


@pytest.mark.parametrize("extra_h", [False, True], ids=["s2d", "s2d+h"])
def test_packed_logits_loss_equals_canonical(extra_h):
    """The train loss on the head's packed logits and packed targets equals
    the canonical-logits loss, gradients too; the packed logits and
    ``pack_like_logits`` equal the JAX package's."""
    cfg = dataclasses.replace(BASE, pack=True, pack_extra_h=extra_h)
    ph = packed.loss_layout_phases(cfg)
    assert ph == jpacked.loss_layout_phases(cfg) == (8 if extra_h else 4)
    params, state, x = _setup(cfg, (2, 16, 16, 1), seed=40)
    rng = np.random.default_rng(42)
    labels = rng.integers(0, 3, (2, 16, 16)).astype(np.int64)
    weights = (rng.uniform(size=(2, 16, 16)) + 0.5).astype(np.float32)
    lab_p = packed.pack_like_logits(T(labels)[..., None], cfg)
    w_p = packed.pack_like_logits(T(weights)[..., None], cfg)
    np.testing.assert_array_equal(lab_p.numpy(), np.asarray(
        jpacked.pack_like_logits(jnp.asarray(labels)[..., None], cfg)))

    mc = _model(cfg, params, state)
    lc, _ = mc(T(x), train=True)
    loss_c = weighted_softmax_xent(lc, T(labels), T(weights))
    loss_c.backward()
    mp = _model(cfg, params, state)
    lp, _ = mp(T(x), train=True, packed_logits=True)
    assert tuple(lp.shape) == (2, 16 // (4 if extra_h else 2), 8, ph * 3)
    jl, _ = _japply(params, state, x, cfg=cfg, train=True,
                    packed_logits=True)
    _close(lp, np.asarray(jl), what="packed logits vs JAX")
    loss_p = weighted_softmax_xent(lp.reshape(lp.shape[:-1] + (ph, 3)),
                                   lab_p, w_p)
    loss_p.backward()
    assert abs(loss_p.item() - loss_c.item()) <= 1e-6 * abs(loss_c.item())
    jloss = jax_xent(jnp.asarray(jl).reshape(jl.shape[:-1] + (ph, 3)),
                     jnp.asarray(lab_p.numpy()), jnp.asarray(w_p.numpy()))
    assert abs(loss_p.item() - float(jloss)) <= TOL * abs(float(jloss))
    gc = dict(mc.named_parameters())
    for k, p in mp.named_parameters():
        _close(p.grad, gc[k].grad.numpy(), what=k)


@pytest.mark.parametrize("dims", [2, 3])
def test_head_dtype_f32_equality_and_unquantized(dims):
    """model.head_dtype float32: packed == canonical (and the JAX packed
    forward) with the head dtype raised over f32 compute; over bf16
    compute the packed head's logits leave the bf16 grid, a bf16 head's
    stay on it."""
    cfg = ModelConfig(dims=dims, depth=2, base_filters=4, num_class=3,
                      compute_dtype="float32", head_dtype="float32", pack=True)
    params, state, x = _setup(cfg, (2,) + (16,) * dims + (1,), seed=31)
    (lp, sp), (lc, sc), (lj, sj) = _forward_three_ways(cfg, params, state, x,
                                                       True)
    _close(lp, lc.numpy(), what="packed vs canonical")
    _close(lp, lj, what="packed vs JAX packed")
    _states_close(sp, sj)
    for head, off_grid in (("float32", True), ("", False)):
        bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16",
                                   head_dtype=head)
        with torch.no_grad():
            y, _ = _model(bcfg, params, state)(T(x), train=True)
        on_grid = torch.mean((y == y.bfloat16().float()).float()).item()
        assert (on_grid < 0.9) if off_grid else on_grid == 1.0, (head, on_grid)


# -- the trainer ------------------------------------------------------------------


def _cloud_batch(rng, rows, shape=(14, 16), n=180, max_points=256):
    """A sparse batch whose points cover most of a (14, 16) image: the
    dense clouds of the trainer parity tests."""
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


def _train_cfg(tmp, *, packed_loss=True, **model_kw):
    mk = dict(depth=2, base_filters=4, num_class=3, compute_dtype="float32",
              pack=True, pack_extra_h=True)
    mk.update(model_kw)
    return Config(
        model=ModelConfig(**mk),
        data=DataConfig(image_size=16, batch_size=4, planes=(0,),
                        weight_mode="class_balance", max_points=256,
                        backend="python"),
        optim=OptimConfig(lr=1e-3),
        train=TrainConfig(seed=3, packed_loss=packed_loss,
                          checkpoint_dir=str(tmp / "ckpt"),
                          log_dir=str(tmp / "log")),
        parallel=ParallelConfig(data=1))


def _leaves(ts_fields):
    f = ts_fields._asdict() if hasattr(ts_fields, "_asdict") else ts_fields
    opt = f["opt"]._asdict() if hasattr(f["opt"], "_asdict") else f["opt"]
    out = {f"params.{k}": v for k, v in flatten_tree(f["params"]).items()}
    out.update({f"state.{k}": v for k, v in flatten_tree(f["model_state"]).items()})
    for kind in ("mu", "nu"):
        out.update({f"{kind}.{k}": v for k, v in flatten_tree(opt[kind]).items()})
    return {k: np.asarray(v) for k, v in out.items()}


def test_packed_loss_trainer_step_matches_jax(tmp_path):
    """One ``train.packed_loss`` Trainer step of each package on a sparse
    batch (the label and weight scattered into the packed layout): params,
    BN state and Adam moments within 1e-4 of the max, and the loss and
    summary metrics; and the port's step equals its own canonical-loss
    step on the same pack: true model."""
    cfg = _train_cfg(tmp_path)
    batch = _cloud_batch(np.random.default_rng(0), 4)
    jtr = JaxTrainer(cfg, mesh=make_mesh(1))
    jts = jtr.init_state()
    ts0 = jax.device_get(jts)
    jts, jm = jtr.train_step(jts, jtr._device_batch(batch))
    want = _leaves(jax.device_get(jts))
    jm = jax.device_get(jm)

    def port_step(c):
        tr = Trainer(c, device="cpu")
        ts = tr.init_state()
        opt, key = load_jax_train_state(ts.model, ts0)
        ts = dataclasses.replace(ts, opt=opt, key=key)
        ts, m = tr.train_step(ts, tr.device_batch(batch))
        return _leaves(jax_train_state(ts.model, ts.opt, ts.key)), m

    got, m = port_step(cfg)
    assert Trainer(cfg, device="cpu")._loss_phases == 8
    moment_max = {kind: max(np.abs(v).max() for k, v in want.items()
                            if k.startswith(kind)) for kind in ("mu", "nu")}
    for k, v in want.items():
        scale = moment_max.get(k.split(".")[0], max(np.abs(v).max(), 1.0))
        np.testing.assert_allclose(got[k] / scale, v / scale, rtol=0,
                                   atol=TOL, err_msg=k)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    canon, mc = port_step(_train_cfg(tmp_path, packed_loss=False))
    for k, v in canon.items():
        scale = moment_max.get(k.split(".")[0], max(np.abs(v).max(), 1.0))
        np.testing.assert_allclose(got[k] / scale, v / scale, rtol=0,
                                   atol=TOL, err_msg=k)
    for k in mc:
        np.testing.assert_allclose(float(m[k]), float(mc[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_shipped_pack_runs_packed(tmp_path, monkeypatch):
    """model.pack: true runs the packed forward in a Trainer step (one
    packed forward, the canonical stem never called); pack: false runs
    none."""
    calls = []
    real = uresnet_mod.packed_forward
    monkeypatch.setattr(uresnet_mod, "packed_forward",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    stems = []
    real_stem = uresnet_mod.ConvBN.forward
    monkeypatch.setattr(uresnet_mod.ConvBN, "forward",
                        lambda self, *a, **kw: (stems.append(self), real_stem(
                            self, *a, **kw))[1])
    batch = _cloud_batch(np.random.default_rng(1), 4)
    for pack, n_packed in ((True, 1), (False, 0)):
        calls.clear()
        stems.clear()
        tr = Trainer(_train_cfg(tmp_path, packed_loss=False, pack=pack),
                     device="cpu")
        ts = tr.init_state()
        tr.train_step(ts, tr.device_batch(batch))
        assert len(calls) == n_packed
        assert (ts.model.stem in stems) is (not pack)


def test_packed_forward_refuses_a_model_axis():
    model = UResNet(dataclasses.replace(BASE, pack=True),
                    generator=torch.Generator().manual_seed(0))
    mesh = Mesh(rank=0, world=2, data=1, model=2)
    with pytest.raises(ValueError, match="requires the canonical layout"):
        model(torch.zeros(1, 16, 16, 1), train=True, mesh=mesh)


def test_frozen_leaves_stay_frozen_through_the_packing(tmp_path):
    """optim.freeze on a packed model: the frozen leaves' packed kernels
    carry no gradient, the leaves and their moments stay bit-equal, the
    rest train."""
    cfg = _train_cfg(tmp_path)
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, freeze=("^stem/", "enc0_b0/cb1/conv")))
    tr = Trainer(cfg, device="cpu")
    ts = tr.init_state()
    before = {k: p.detach().clone() for k, p in ts.model.named_parameters()}
    ts, _ = tr.train_step(ts, tr.device_batch(_cloud_batch(
        np.random.default_rng(2), 4)))
    for k, p in ts.model.named_parameters():
        frozen = k.startswith("stem.") or k == "enc0_b0.cb1.conv.w"
        assert torch.equal(p.detach(), before[k]) is frozen, k
        if frozen:
            assert not p.requires_grad and not ts.opt.mu[k].any(), k


# -- the packed loss targets of the densify ------------------------------------------


def _sparse(dims, n, seed, T_img):
    rng = np.random.default_rng(seed)
    shape = (2 * T_img,) * dims
    evs = [generate_event(rng, shape=shape, planes=(0,)) for _ in range(n)]
    for ev in evs:
        for pl in ev.planes:
            pl.weights = rng.uniform(0.2, 3.0, len(pl.values)).astype(np.float32)
    return sparse_batch(evs, planes=(0,), max_points=4096, ndims=dims,
                        with_weights=True)


@pytest.mark.parametrize("dims,hpack", [(2, False), (2, True), (3, False)],
                         ids=["2d", "2d+h", "3d"])
@pytest.mark.parametrize("weight_mode", ["class_balance", "ones", "nonzero",
                                         "file"])
def test_packed_densify_bit_equal_to_jax(dims, hpack, weight_mode):
    """densify_on_device(target_phases, target_hpack) == the JAX package's,
    bit for bit, data canonical and label / weight packed."""
    Ti = 32 if dims == 2 else 16
    sp = _sparse(dims, 3, 7 + dims, Ti)
    phases = (2 ** dims) * (2 if hpack else 1)
    kw = dict(image_size=Ti, num_class=3, normalize_scale=0.01,
              normalize_clip=5.0, weight_mode=weight_mode, nonzero_boost=2.0,
              target_phases=phases, target_hpack=hpack)
    got = dp.densify_on_device({k: T(v) for k, v in sp.items()}, **kw)
    want = jax.device_get(jax_densify({k: jnp.asarray(v) for k, v in sp.items()},
                                      **kw))
    lead = (3, Ti // (4 if hpack else 2)) + (Ti // 2,) * (dims - 1)
    assert tuple(got["label"].shape) == lead + (phases,)
    assert tuple(got["data"].shape) == (3,) + (Ti,) * dims + (1,)
    for k in ("data", "label", "weight"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("hpack", [False, True], ids=["s2d", "s2d+h"])
def test_packed_densify_with_augment_packs_the_canonical(hpack):
    """With in-scatter flips/rot90, the packed scatter equals
    ``pack_like_logits`` of the canonical densify on the same decisions
    (the JAX package draws its own stream, so this is held to the port's
    canonical densify)."""
    cfg = dataclasses.replace(BASE, pack=True, pack_extra_h=hpack)
    sp = {k: T(v) for k, v in _sparse(2, 4, 3, 32).items()}
    d = torch.from_numpy(np.random.default_rng(3).uniform(size=(3, 4)) < 0.5)
    assert d.any() and not d.all()
    kw = dict(image_size=32, weight_mode="nonzero", nonzero_boost=2.0,
              decisions=d)
    canon = dp.densify_on_device(sp, **kw)
    got = dp.densify_on_device(sp, target_phases=packed.loss_layout_phases(cfg),
                               target_hpack=hpack, **kw)
    torch.testing.assert_close(got["data"], canon["data"], rtol=0, atol=0)
    for k in ("label", "weight"):
        want = packed.pack_like_logits(canon[k][..., None], cfg)
        torch.testing.assert_close(got[k], want, rtol=0, atol=0)
