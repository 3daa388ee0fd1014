"""The sparse U-ResNet (models/sparse_uresnet.py, ops/sparse.py,
ops/cuda/sparse_conv.py) against its plain float32 reference
(tests/sparse_uresnet_reference.py) on the CPU, on seeded random weights:
the rulebooks against a brute-force pair search, each conv op's plain
version (the CUDA kernels' stand-in here) forward, input and weight
gradient, the whole net's logits, loss, gradients and one Adam step
through the Trainer, bf16 against the reference rounded the same way, the
ana step's scores and counts, cli.train and cli.infer through a
checkpoint, the modes the sparse net refuses, the config's round trip, and
a step of two data-parallel ranks (gloo) against one process. Small
sizes: extent 32, m = 4, 3 levels, two events of a few hundred points."""

import dataclasses
import itertools
import json
import math
import os
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import sparse_uresnet_reference as ref
from uresnet_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                      OptimConfig, TrainConfig)
from uresnet_tpu_torch.data.pipeline import sparse_batch
from uresnet_tpu_torch.data.synthetic import generate_event
from uresnet_tpu_torch.engine import evaluator
from uresnet_tpu_torch.engine.export import build_logits_fn, export_serving
from uresnet_tpu_torch.engine.trainer import Trainer, TrainState
from uresnet_tpu_torch.models.convert import (load_jax_train_state,
                                              unflatten_tree)
from uresnet_tpu_torch.ops import sparse as sp
from uresnet_tpu_torch.ops.cuda import sparse_conv as sc

EXTENT, LEVELS = 32, 3
MODEL = dict(arch="sparse_uresnet", dims=3, depth=LEVELS - 1, base_filters=4,
             blocks_per_level=2, num_class=3, in_channels=1, bn_eps=1e-4,
             bn_momentum=0.9, compute_dtype="float32",
             param_dtype="float32")
# Adam's eps at 1e-3 keeps its first step smooth in the gradient: with
# 1e-8 a step is lr * sign(g), which f32 order noise flips at g ~ 0
OPTIM = dict(optimizer="adam", lr=1e-3, schedule="constant", warmup_steps=0,
             decay_steps=0, b1=0.9, b2=0.999, eps=1e-3, weight_decay=0.0,
             grad_clip_norm=0.0)
DATA = dict(image_size=EXTENT, batch_size=2, planes=(0,),
            normalize_scale=0.01, normalize_clip=10.0,
            weight_mode="class_balance", max_points=1024)


def _conf(**model):
    return {"model": dict(MODEL, **model), "data": dict(DATA),
            "optim": dict(OPTIM)}


def _cfg(conf, tmp=None) -> Config:
    d = dict(conf["data"], synthetic_events=8, num_threads=1)
    t = {} if tmp is None else dict(checkpoint_dir=str(tmp / "ckpt"),
                                    log_dir=str(tmp / "log"))
    return Config(model=ModelConfig(**conf["model"]), data=DataConfig(**d),
                  optim=OptimConfig(**conf["optim"]), train=TrainConfig(**t))


def _batch(seed=5, n=2, extent=EXTENT, max_points=1024):
    rng = np.random.default_rng(seed)
    events = [generate_event(rng, shape=(extent,) * 3, planes=(0,))
              for _ in range(n)]
    return sparse_batch(events, planes=(0,), max_points=max_points, ndims=3)


def _leaves(m, seed=0):
    """Seeded leaves in the reference's names: Glorot kernels, BN scales
    in [0.5, 1.5), biases in [-0.2, 0.2), running means and variances."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in ref.leaf_shapes(m).items():
        u = torch.rand(shape, generator=g)
        if name.endswith("w"):
            k = math.prod(shape[:-2])
            out[name] = (u * 2 - 1) * math.sqrt(6 / (k * sum(shape[-2:])))
        elif name.endswith("scale"):
            out[name] = u + 0.5
        elif name.endswith(("bias", "head.b")):
            out[name] = (u * 2 - 1) * 0.2
        elif name.endswith("mean"):
            out[name] = (u - 0.5) * 0.2
        else:
            out[name] = u + 0.5
    return ({k: v for k, v in out.items() if not ref.is_stat(k)},
            {k: v for k, v in out.items() if ref.is_stat(k)})


def _trainer(conf, params, stats, tmp=None):
    tr = Trainer(_cfg(conf, tmp), device="cpu")
    ts = tr.init_state()
    zeros = unflatten_tree({k: torch.zeros_like(v) for k, v in params.items()})
    opt, key = load_jax_train_state(ts.model, {
        "params": unflatten_tree(params), "model_state": unflatten_tree(stats),
        "opt": {"step": 0, "mu": zeros, "nu": zeros}, "key": ts.key})
    return tr, TrainState(model=ts.model, opt=opt, key=key)


def _rel(a, b):
    """max |a - b| over max |b|."""
    a, b = (torch.as_tensor(t).detach().double() for t in (a, b))
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


# -- the rulebook ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rulebook_is_the_brute_force_pairs(seed):
    """Random clouds with isolated sites, sites on every face and corner
    of the extent and repeated points: each level's sites, the
    submanifold neighbours of every offset, the Down and Up maps and the
    weight gradient's pair lists, against a search over all pairs."""
    rng = np.random.default_rng(seed)
    B, P, E = 2, 200, 16
    coords = rng.integers(0, E, (B, P, 3))
    coords[0, :8] = np.array(list(itertools.product((0, E - 1), repeat=3)))
    coords[1, :4] = coords[1, 4:8]                    # repeated points
    coords[1, 10] = (7, 7, 7)                         # far from the rest
    npoints = np.array([P, P - 30])
    batch = {"coords": torch.as_tensor(coords, dtype=torch.int16),
             "values": torch.as_tensor(rng.uniform(1, 90, (B, P)),
                                       dtype=torch.float32),
             "labels": torch.as_tensor(rng.integers(0, 3, (B, P)),
                                       dtype=torch.uint8),
             "npoints": torch.as_tensor(npoints, dtype=torch.int32)}
    prep = sp.prepare(batch, extent=E, levels=4, num_class=3,
                      normalize_scale=0.01, normalize_clip=10.0)
    rb = sp.rulebook(prep)
    sites = []
    for lvl, lv in enumerate(rb.levels):
        want = sorted({(b,) + tuple(coords[b, p] >> lvl)
                       for b in range(B) for p in range(npoints[b])})
        got = [(int(e),) + tuple(c.tolist())
               for e, c in zip(lv.event, lv.coords)]
        assert sorted(got) == want and len(set(got)) == lv.n
        index = {s: i for i, s in enumerate(got)}
        sites.append(got)
        nbr = lv.nbr.table.numpy()
        for k, delta in enumerate(itertools.product((-1, 0, 1), repeat=3)):
            for j, s in enumerate(got):
                t = (s[0],) + tuple(a + d for a, d in zip(s[1:], delta))
                assert nbr[k, j] == index.get(t, -1)
        _check_pairs(lv.nbr)
    for lvl in range(len(rb.levels) - 1):
        coarse = {s: i for i, s in enumerate(sites[lvl + 1])}
        down, up = rb.down[lvl].table.numpy(), rb.up[lvl].table.numpy()
        assert (down >= 0).sum() == (up >= 0).sum() == len(sites[lvl])
        for i, s in enumerate(sites[lvl]):
            parent = coarse[(s[0],) + tuple(a >> 1 for a in s[1:])]
            o = (s[1] & 1) * 4 + (s[2] & 1) * 2 + (s[3] & 1)
            assert up[o, i] == parent and (up[:, i] >= 0).sum() == 1
            assert down[o, parent] == i
        _check_pairs(rb.down[lvl])
        _check_pairs(rb.up[lvl])
    # the points' sites; a repeated point's site takes its last value
    ps = prep.point_site.numpy()
    assert (ps[0] >= 0).all() and (ps[1, npoints[1]:] == -1).all()
    for p in range(4):
        assert ps[1, p] == ps[1, p + 4]
        assert prep.feats[ps[1, p], 0] == pytest.approx(
            min(float(batch["values"][1, p + 4]) * 0.01, 10.0))


def _check_pairs(rule):
    """A rule's pair list: each offset's rows ascending in runs of
    CHUNK, padded with -1, the offsets in order."""
    table, pairs = rule.table.numpy(), rule.pairs.numpy()
    chunk_k = rule.chunk_k.numpy()
    assert len(pairs) == len(chunk_k) * sp.CHUNK
    for k in range(table.shape[0]):
        got = pairs.reshape(-1, sp.CHUNK)[chunk_k == k].reshape(-1)
        assert list(got[got >= 0]) == list(np.nonzero(table[k] >= 0)[0])
    assert (np.diff(chunk_k) >= 0).all()


# -- the ops ------------------------------------------------------------------


def _rules(prep, batch):
    """(name, rule, back, mirror, n_in, K, the reference's pairs,
    n_out) of each kind of conv at level 0 -> 1."""
    rb = prep.rules
    rr = ref.rulebook(batch, EXTENT, LEVELS, scale=0.01, clip=10.0,
                      device="cpu")
    n0, n1 = rb.levels[0].n, rb.levels[1].n
    return [("SC", rb.levels[0].nbr, rb.levels[0].nbr, True, n0, 27,
             rr["sc"][0], n0),
            ("Down", rb.down[0], rb.up[0], False, n0, 8, rr["down"][0], n1),
            ("Up", rb.up[0], rb.down[0], False, n1, 8, rr["up"][0], n0),
            ("1x1", sp.IDENTITY, sp.IDENTITY, False, n0, 1, None, n0)], rr


def _prep(batch):
    prep = sp.prepare({k: torch.as_tensor(v) for k, v in batch.items()},
                      extent=EXTENT, levels=LEVELS, num_class=3,
                      normalize_scale=0.01, normalize_clip=10.0)
    prep.rules = sp.rulebook(prep)
    return prep


@pytest.mark.parametrize("kind", ["SC", "Down", "Up", "1x1"])
def test_ops_match_the_reference_conv(kind):
    """Forward, input gradient and weight gradient of each conv kind,
    float64: the port's rows are in Morton order, the reference's in
    row-major key order, matched through their coordinates. 1e-12 of the
    max: the same products summed in another order."""
    batch = _batch()
    prep = _prep(batch)
    rules, rr = _rules(prep, batch)
    name, rule, back, mirror, n_in, K, pairs, n_out = next(
        r for r in rules if r[0] == kind)
    # the reference's row of each of the port's sites, at both levels
    perm = [_site_order(prep, lvl) for lvl in range(2)]
    p_in = perm[1] if kind == "Up" else perm[0]
    p_out = perm[1] if kind == "Down" else perm[0]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(n_in, 5, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(K, 5, 6, generator=g, dtype=torch.float64,
                    requires_grad=True)
    dy = torch.randn(n_out, 6, generator=g, dtype=torch.float64)
    y_ref = ref.conv(x[p_in.argsort()], w, pairs, n_out)[p_out]
    dx_ref, dw_ref = torch.autograd.grad(y_ref, (x, w), dy)
    with torch.no_grad():
        y = sc.sparse_conv_fwd(x, w, rule.table)
        dx = sc.sparse_conv_dgrad(dy, w, back.table, mirror=mirror)
        dw = sc.sparse_conv_wgrad(x, dy, rule.table, rule.pairs,
                                  rule.chunk_k, K)
    for got, want in ((y, y_ref), (dx, dx_ref), (dw, dw_ref)):
        assert _rel(got, want) < 1e-12
    # and through the autograd function, with a residual and a bias
    res = torch.randn(n_out, 6, dtype=torch.float64, requires_grad=True)
    b = torch.randn(6, dtype=torch.float64, requires_grad=True)
    out = sc.sparse_conv(x, w, rule, back, mirror=mirror, residual=res,
                         bias=b)
    grads = torch.autograd.grad(out, (x, w, res, b), dy)
    assert _rel(out, y_ref + res + b) < 1e-12
    for got, want in zip(grads, (dx_ref, dw_ref, dy, dy.sum(0))):
        assert _rel(got, want) < 1e-12


def _site_order(prep, lvl):
    """perm[i]: the reference's row of the port's site i at ``lvl``: the
    reference sorts a level's sites by their packed (event, coordinates)
    key."""
    lv = prep.rules.levels[lvl]
    key = ref._key(lv.event, lv.coords, -(-EXTENT // (1 << lvl)))
    return key.argsort().argsort()


def test_kernels_count_nothing_on_the_cpu():
    before = (sc.launches_sparse_conv_fwd, sc.launches_sparse_conv_dgrad,
              sc.launches_sparse_conv_wgrad)
    test_ops_match_the_reference_conv("SC")
    assert before == (sc.launches_sparse_conv_fwd,
                      sc.launches_sparse_conv_dgrad,
                      sc.launches_sparse_conv_wgrad)
    assert sc.tile(3) == 16 and sc.tile(80) == 96 and sc.tile(160) == 96


# -- the net --------------------------------------------------------------------


def _ref_grads(conf, params, batch, quant=None):
    """The reference's logits at the points, loss and autograd gradients
    of one batch in train mode."""
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    with ref.true_f32():
        rb = ref.build(conf, batch, "cpu")
        logits = ref.forward(p, {}, rb, conf["model"], quant=quant)
        w = ref.class_weights(rb["label"], rb["event"], 2, 3, "class_balance")
        loss = ref.weighted_xent(logits, rb["label"], w)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    return ref.at_points(logits.detach(), rb["point_site"]), loss, grads


def _port_grads(conf, params, stats, batch):
    """The port's logits as Trainer._loss_fn gives them, its loss, and the
    gradients of every parameter."""
    tr, ts = _trainer(conf, params, stats)
    prep = tr._sparse_batch(tr.device_batch(batch))
    named = dict(ts.model.named_parameters())
    with torch.enable_grad():
        loss, logits, _ = tr._loss_fn(ts.model, prep)
        grads = dict(zip(named, torch.autograd.grad(
            loss, list(named.values()), allow_unused=True)))
    return tr, ts, logits.detach(), loss.detach(), grads


def test_net_matches_the_reference_in_f32():
    """Logits at the points, the loss, every leaf's gradient and one Adam
    step through Trainer.train_step_light: 1e-4 of each tensor's max (f32
    sums over the pairs, the BN statistics and the loss in other orders,
    through 11 layers and back)."""
    conf = _conf()
    params, stats = _leaves(conf["model"])
    batch = _batch()
    want_logits, want_loss, want_grads = _ref_grads(conf, params, batch)
    tr, ts, logits, loss, grads = _port_grads(conf, params, stats, batch)
    assert logits.shape == want_logits.shape == (2, 1024, 3)
    assert _rel(logits, want_logits) < 1e-4
    assert abs(float(loss) - float(want_loss)) < 1e-5 * float(want_loss)
    assert set(grads) == set(want_grads)
    for k in grads:
        assert grads[k] is not None, k
        assert _rel(grads[k], want_grads[k]) < 1e-4, k
    # one Adam step through the hot-loop step
    p = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    ref.adam(p, want_grads, mu, nu, 1, conf["optim"])
    ts, met = tr.train_step_light(ts, tr.device_batch(batch))
    assert abs(float(met["loss"]) - float(want_loss)) < 1e-5
    for k, v in ts.model.named_parameters():
        # lr g / (sqrt(g^2) + eps) is steepest where |g| ~ eps: there a
        # gradient's 1e-4 moves the step by a few times that
        assert _rel(v.detach() - params[k], p[k] - params[k]) < 5e-4, k


def _logit_err(got, want):
    """The mean norm over the points of got - want over that of want,
    logits centred over the classes, the worst event."""
    def c(t):
        t = t.double()
        return t - t.mean(-1, keepdim=True)
    return max(float(torch.linalg.vector_norm(c(g) - c(w), dim=-1).mean()
                     / torch.linalg.vector_norm(c(w), dim=-1).mean())
               for g, w in zip(got, want))


def _bf16(t):
    q = t.detach().to(torch.bfloat16).to(t.dtype)
    return t + (q - t).detach() if t.requires_grad else q


def _fp8(t):
    with torch.no_grad():
        scale = t.abs().amax().clamp(min=1e-30) / 448.0
        q = (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach() if t.requires_grad else q


def test_bf16_net_matches_the_reference_rounded_alike():
    """The bf16 model against the reference with its operands and outputs
    rounded to bf16 where the program rounds (ref ``quant``): within 0.05
    of how far the float32 reference lies from that rounded one. The two
    round the same sums at the same places, so they differ only where one
    bf16 rounding of a sum summed in another order goes the other way;
    the same reference in float8 e4m3, the precision below, lies several
    times farther (asserted: the tolerance tells bf16 from fp8)."""
    conf = _conf(compute_dtype="bfloat16")
    params, stats = _leaves(conf["model"])
    batch = _batch()
    f32, _, _ = _ref_grads(conf, params, batch)
    bf, _, g_bf = _ref_grads(conf, params, batch, quant=_bf16)
    fp8, _, _ = _ref_grads(conf, params, batch, quant=_fp8)
    _, _, logits, _, grads = _port_grads(conf, params, stats, batch)
    yard = _logit_err(bf, f32)
    assert _logit_err(logits, bf) < 0.05 * yard
    assert _logit_err(fp8, bf) > 3 * yard
    # gradients: the median leaf within 2% of the rounded reference's
    gaps = sorted(_rel(grads[k], g_bf[k]) for k in grads)
    assert gaps[len(gaps) // 2] < 0.02


@pytest.mark.parametrize("fault", ["shortcut", "bn", "skip"])
def test_a_dropped_term_fails_the_comparison(monkeypatch, fault):
    """The f32 comparison catches a block without its shortcut, a BN left
    out (the identity in place of the first BN of each block), and the
    decoder without its skip (zeros concatenated)."""
    from uresnet_tpu_torch.models import sparse_uresnet as net

    def block(self, x, ctx, level):
        h, s1 = ((torch.relu(x), {"mean": self.bn1.mean, "var": self.bn1.var})
                 if fault == "bn" else self.bn1(x, ctx, relu=True))
        h = net.sparse_conv(h, net._kernel(self.conv1.w), level.nbr,
                            mirror=True)
        h, s2 = self.bn2(h, ctx, relu=True)
        short = None
        if fault != "shortcut":
            short = x if self.proj is None else net.sparse_conv(
                x, net._kernel(self.proj.w), net.IDENTITY)
        return net.sparse_conv(h, net._kernel(self.conv2.w), level.nbr,
                               mirror=True, residual=short), {"bn1": s1,
                                                              "bn2": s2}

    class NoSkip:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def cat(ts, dim):
            return torch.cat([torch.zeros_like(ts[0]), ts[1]], dim)

    if fault == "skip":
        monkeypatch.setattr(net, "torch", NoSkip())
    else:
        monkeypatch.setattr(net.SparseResBlock, "forward", block)
    conf = _conf()
    params, stats = _leaves(conf["model"])
    batch = _batch()
    want, _, _ = _ref_grads(conf, params, batch)
    _, _, logits, _, _ = _port_grads(conf, params, stats, batch)
    assert _rel(logits, want) > 1e-2


def test_no_tensor_of_the_whole_volume():
    """Rows, rulebook, forward and backward at extent 64 allocate nothing
    of 64^3 elements or more: the sparse net never densifies."""
    conf = _conf()
    conf["data"]["image_size"] = 64
    params, stats = _leaves(conf["model"])
    batch = _batch(extent=64)
    largest = [0]

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if torch.is_tensor(t):
                    largest[0] = max(largest[0], t.numel())
            return out

    tr, ts = _trainer(conf, params, stats)
    with Sizes():
        tr.train_step_light(ts, tr.device_batch(batch))
    assert 0 < largest[0] < 64 ** 3


def test_ana_step_matches_the_reference():
    """The ana step (evaluator._ana_step_sparse over build_logits_fn) in
    eval mode: softmax scores at the points within 1e-5 (f32, other
    orders), and the counts exact: the sites of each event, the charged
    ones, the confusion sums and the right calls, a padded row masked."""
    conf = _conf()
    params, stats = _leaves(conf["model"])
    batch = _batch()
    want = ref.analyse(conf, params, stats, batch, device="cpu")
    tr, ts = _trainer(conf, params, stats)
    dev = tr.device_batch(batch)
    dev["row_valid"] = torch.tensor([1.0, 0.0])
    out = evaluator._ana_step_sparse(tr.cfg, build_logits_fn(
        tr.cfg, ts.model), dev)
    assert np.abs(out["pscores"].numpy() - want["pscores"]).max() < 1e-5
    assert out["origin"].tolist() == [[0, 0, 0]] * 2
    rows = ref.rulebook(batch, EXTENT, LEVELS, scale=0.01, clip=10.0,
                        device="cpu")
    n_first = int((rows["event"] == 0).sum())
    assert float(out["n_pixels"]) == n_first
    assert out["n_nonzero"].tolist() == [n_first, 0.0]
    # the confusion counts of event 0 from the reference's own scores
    pred = torch.as_tensor(want["pscores"][0]).argmax(-1)
    ps = rows["point_site"][0]
    site_pred = torch.zeros(len(rows["event"]), dtype=torch.long)
    site_pred[ps[ps >= 0]] = pred[ps >= 0]
    first = rows["event"] == 0
    conf_m = torch.bincount(site_pred[first] * 3 + rows["label"][first],
                            minlength=9).reshape(3, 3)
    assert out["conf"][0].tolist() == conf_m.float().tolist()
    assert float(out["correct_nonzero"][0]) == float(conf_m.trace())
    assert float(out["conf"][1].sum()) == 0.0


def test_cli_train_and_infer_through_a_checkpoint(tmp_path, capsys):
    """cli.train trains the sparse net on synthetic 32^3 volumes and
    writes a checkpoint whose leaves are the reference's names; cli.infer
    --metrics-only counts every voxel of a file exactly once, and the
    streamed sparse export scores every one of them."""
    from uresnet_tpu_torch import generate_file
    from uresnet_tpu_torch.cli import infer, train
    from uresnet_tpu_torch.engine import checkpoint as ckpt

    conf = _conf()
    cfg = {"model": conf["model"], "optim": conf["optim"],
           "data": dict(conf["data"], planes=[0], synthetic_events=8,
                        num_threads=1),
           "train": {"iterations": 2, "summary_iter": 1,
                     "checkpoint_iter": 2, "val_iter": 0,
                     "checkpoint_dir": str(tmp_path / "ckpt"),
                     "log_dir": str(tmp_path / "log")}}
    path = tmp_path / "sparse.json"
    path.write_text(json.dumps(cfg))
    assert train.main([str(path), "--device", "cpu"]) == 0
    latest = ckpt.latest_checkpoint(str(tmp_path / "ckpt"))
    with np.load(latest) as z:
        names = {k.split("/", 2)[2].replace("/", ".") for k in z.files
                 if k.startswith(("train_state/params/",
                                  "train_state/model_state/"))}
    assert names == set(ref.leaf_shapes(conf["model"]))
    events = generate_file(str(tmp_path / "ana.usef"), 3, seed=4,
                           shape=(EXTENT,) * 3, planes=(0,))
    capsys.readouterr()
    argv = [str(path), "--input", events, "--device", "cpu"]
    assert infer.main(argv + ["--metrics-only"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    metrics = eval(line.split("metrics: ", 1)[1])
    from uresnet_tpu_torch.data import events as ev
    voxels = sum(len(e.planes[0].values) for e in ev.read_events(events))
    assert metrics["n_events"] == 3 and metrics["n_pixels"] == voxels
    assert infer.main(argv + ["--output", str(tmp_path / "s.npz")]) == 0
    with np.load(tmp_path / "s.npz") as z:
        assert len(z["scores"]) == voxels
        assert np.allclose(z["scores"].sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("mode", [
    "model.pack", "model.remat", "data.augment", "data.transfer: dense",
    "tensor parallelism", "spatial parallelism", "tiled", "host",
    "dense export", ".uxm serving artifact", "Trainer.forward"])
def test_refused_modes_name_themselves(mode, tmp_path):
    conf = _conf()
    cfg = _cfg(conf)
    trainer_modes = {
        "model.pack": ("model", dict(pack=True)),
        "model.remat": ("model", dict(remat="block")),
        "data.augment": ("data", dict(augment=True)),
        "data.transfer: dense": ("data", dict(transfer="dense")),
        "tensor parallelism": ("parallel", dict(model=2)),
        "spatial parallelism": ("parallel", dict(spatial=2))}
    if mode in trainer_modes:
        section, kw = trainer_modes[mode]
        if section == "model":  # a replace keeps the fields alone
            kw = dict(kw, arch=cfg.model.arch)
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
            getattr(cfg, section), **kw)})
        with pytest.raises(ValueError, match=mode.split(" (")[0]):
            Trainer(cfg, device="cpu")
        return
    params, stats = _leaves(conf["model"])
    tr, ts = _trainer(conf, params, stats)
    if mode == ".uxm serving artifact":
        with pytest.raises(ValueError, match=mode):
            export_serving(tr.cfg, ts.model)
        return
    if mode == "Trainer.forward":
        with pytest.raises(ValueError, match=mode):
            tr.forward(ts, np.zeros((1,) + (EXTENT,) * 3 + (1,), np.float32))
        return
    kw = {"tiled": dict(tiled=True), "host": dict(streamed=False),
          "dense export": dict(export="dense")}[mode]
    with pytest.raises(ValueError, match=mode):
        evaluator.run_inference(tr, ts, "unread.usef",
                                str(tmp_path / "o.npz"), **kw)


def test_the_architecture_key_keeps_the_dense_config():
    """``model.arch`` is a keyword of ModelConfig, not a field: the port's
    fields stay the JAX package's one for one; a replace passes it again;
    overrides set it."""
    from uresnet_tpu_torch.config import apply_overrides

    m = ModelConfig(arch="sparse_uresnet", depth=3)
    assert "arch" not in dataclasses.asdict(m)
    assert "arch" not in ModelConfig.__dataclass_fields__
    assert m.arch == "sparse_uresnet" and ModelConfig().arch == "uresnet"
    assert dataclasses.replace(m, depth=2, arch=m.arch).arch == m.arch
    cfg = apply_overrides(Config(), ["model.arch=sparse_uresnet"])
    assert cfg.model.arch == "sparse_uresnet"
    with pytest.raises(ValueError, match="unknown model.arch"):
        Trainer(apply_overrides(Config(), ["model.arch=other"]), device="cpu")


def test_to_dict_keeps_the_architecture(tmp_path):
    """``Config.to_dict`` writes ``model.arch`` where it is not the dense
    net's, so its JSON loads back as the sparse net; a dense config's
    dict has no such key (it stays the JAX package's)."""
    from uresnet_tpu_torch.config import load_config

    cfg = _cfg(_conf())
    d = cfg.to_dict()
    assert d["model"]["arch"] == "sparse_uresnet"
    path = tmp_path / "c.json"
    path.write_text(json.dumps(d))
    back = load_config(str(path))
    assert back.model.arch == "sparse_uresnet"
    assert back.to_dict() == d
    assert "arch" not in Config().to_dict()["model"]


# -- data parallelism -----------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP_MODES = ("mean", "weight_sum")


def _dp_trainer(normalize):
    """The trainer of a global batch of 4 events; under a process group,
    2 a rank."""
    conf = _conf()
    conf["data"]["batch_size"] = 4
    cfg = _cfg(conf)
    return Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, loss_normalize=normalize)), device="cpu")


def _dp_step(tr, batch):
    """One train step from the seed's state: its loss and accuracy, and
    the params and BN state before and after."""
    ts = tr.init_state()
    leaves = lambda: {k: v.detach().clone() for k, v in itertools.chain(
        ts.model.named_parameters(), ts.model.named_buffers())}
    before = leaves()
    ts, met = tr.train_step(ts, tr.device_batch(batch))
    return ({k: float(met[k]) for k in ("loss", "acc_all", "acc_nonzero")},
            before, leaves())


def _dp_worker(outdir):
    """One rank: a step of each loss normalization on its 2 of the 4
    events, written to outdir."""
    import torch.distributed as dist

    from uresnet_tpu_torch.parallel import mesh

    mesh.init_distributed("cpu")
    rank = dist.get_rank()
    mine = {k: v[2 * rank:2 * rank + 2] for k, v in _batch(7, n=4).items()}
    for normalize in DP_MODES:
        met, _, after = _dp_step(_dp_trainer(normalize), mine)
        torch.save({"metrics": met, "after": after},
                   os.path.join(outdir, f"{normalize}{rank}.pt"))
    mesh.shutdown()
    return 0


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    from uresnet_tpu_torch.parallel.mesh import join_local, start_local

    outdir = str(tmp_path_factory.mktemp("sparse_dp"))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    procs = start_local([sys.executable, os.path.abspath(__file__), outdir],
                        2, env=env, cwd=ROOT)
    for rank, (rc, out) in enumerate(join_local(procs, timeout=180)):
        assert rc == 0, f"rank {rank} failed:\n{out}"
    return outdir


@pytest.mark.parametrize("normalize", DP_MODES)
def test_two_ranks_step_as_one_process(dp_run, normalize):
    """Two gloo ranks, 2 events each, of unequal site counts: the logged
    loss and metrics and both replicas' params and BN state after one step
    equal one process's step on the 4 events. The loss and metrics to
    1e-5 (f32 sums in another order); the params' and BN state's change
    to 1e-4 of its largest element (the gradients and BN moments are
    summed across ranks in another order, and Adam's first step with eps
    1e-3 moves by lr g / (|g| + eps), so a gradient's 1e-7 moves the step
    by up to 1e-4 of lr). A rank that divides by its own site count or
    weight sum gives another gradient: 1e-1 of the change or more."""
    batch = _batch(7, n=4)
    assert batch["npoints"][:2].sum() != batch["npoints"][2:].sum()
    met, before, want = _dp_step(_dp_trainer(normalize), batch)
    ranks = [torch.load(os.path.join(dp_run, f"{normalize}{r}.pt"))
             for r in (0, 1)]
    for k in want:
        torch.testing.assert_close(ranks[0]["after"][k], ranks[1]["after"][k],
                                   rtol=0, atol=0, msg=k)
        assert _rel(ranks[0]["after"][k] - before[k],
                    want[k] - before[k]) < 1e-4, k
    for k, v in met.items():
        assert ranks[0]["metrics"][k] == pytest.approx(v, rel=1e-5), k


if __name__ == "__main__":
    raise SystemExit(_dp_worker(sys.argv[1]))
