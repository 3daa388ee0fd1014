"""The port's 3D ops and model vs the JAX package on the CPU (BASELINE
config 4's family, cut to depth 2, base 4, 16^3 and odd shapes).

Inputs are made with numpy from a seed; weights come from the JAX
``uresnet_init`` and are carried across with ``load_jax_params``. f32
comparisons hold within 1e-4 of the max (ops within 1e-5, as the 2D op
tests); bf16 outputs within one bf16 ulp plus 1e-4 of the max, the
kernel-vs-plain bf16 tolerance of chip_smoke.py.

The f32 head over a bf16 model (``head_dtype: float32``, config 4): the
port rounds the head's operands to bf16 and sums in f32, the TPU's DEFAULT
pass. The JAX package on the CPU runs DEFAULT as true f32 and does not
round the head weight. So the port equals the JAX package exactly when the
head weights are already bf16-representable, and otherwise differs by the
bf16 rounding of the head kernel; both are pinned below.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uresnet_tpu.config import ModelConfig
from uresnet_tpu.engine.losses import weighted_softmax_xent as jax_xent
from uresnet_tpu.models.fold import fold_batchnorm as jax_fold
from uresnet_tpu.models.fold import uresnet_apply_folded as jax_apply_folded
from uresnet_tpu.models.uresnet import uresnet_apply, uresnet_init
from uresnet_tpu.ops.conv import conv as jax_conv
from uresnet_tpu.ops.conv import conv_general as jax_conv_general
from uresnet_tpu.ops.conv import head_precision as jconv_head_precision
from uresnet_tpu.ops.conv import conv_transpose as jax_conv_transpose
from uresnet_tpu.ops.norm import batch_norm as jax_batch_norm
from uresnet_tpu_torch.engine.losses import weighted_softmax_xent
from uresnet_tpu_torch.models import fold
from uresnet_tpu_torch.models import uresnet as uresnet_mod
from uresnet_tpu_torch.models.convert import (flatten_tree, jax_params,
                                              load_jax_params, trees)
from uresnet_tpu_torch.models.uresnet import UResNet
from uresnet_tpu_torch.ops import conv as tconv
from uresnet_tpu_torch.ops import norm as tnorm
from uresnet_tpu_torch.ops.cuda import conv2d as tfused

T = torch.from_numpy
CFG = ModelConfig(dims=3, depth=2, base_filters=4, num_class=3,
                  compute_dtype="float32")
TOL = 1e-4
BF16_REL, BF16_SLACK = 2.0 ** -7, 1e-4


def _w(rng, k, cin, cout, dims=3):
    return (rng.standard_normal((k,) * dims + (cin, cout)) * .3).astype(np.float32)


def _assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = BF16_REL * np.abs(want) + BF16_SLACK * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


# -- ops -------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 8, 8), (7, 7, 7), (15, 12, 9)],
                         ids=["even", "odd", "non-cubic"])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv3d_matches_jax(rng, stride, shape):
    """SAME conv in 3D: (floor, ceil) pads per axis, (0, 1) at stride 2 on
    even axes."""
    x = rng.standard_normal((2,) + shape + (5,)).astype(np.float32)
    p = {"w": _w(rng, 3, 5, 6), "b": rng.standard_normal(6).astype(np.float32)}
    want = jax_conv(jnp.asarray(x), p, stride=stride, dims=3,
                      compute_dtype=jnp.float32)
    got = tconv.conv(T(x), {k: T(v) for k, v in p.items()}, stride=stride,
                     dims=3, compute_dtype=torch.float32)
    assert got.shape == want.shape == (2,) + tuple(-(-s // stride) for s in shape) + (6,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("shape", [(4, 4, 4), (5, 4, 3)])
def test_conv_transpose3d_matches_jax(rng, shape):
    x = rng.standard_normal((2,) + shape + (6,)).astype(np.float32)
    p = {"w": _w(rng, 3, 6, 4), "b": rng.standard_normal(4).astype(np.float32)}
    want = jax_conv_transpose(jnp.asarray(x), p, dims=3,
                                compute_dtype=jnp.float32)
    got = tconv.conv_transpose(T(x), {k: T(v) for k, v in p.items()}, dims=3,
                               compute_dtype=torch.float32)
    assert got.shape == want.shape == (2,) + tuple(2 * s for s in shape) + (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


def test_conv_dims_validated():
    """Spatial axes other than 2 or 3, or a ``dims`` that does not match the
    input, raise ValueError (the JAX package's ``_dim_numbers``)."""
    p = {"w": torch.zeros(3, 3, 3, 2, 2)}
    with pytest.raises(ValueError, match="dims must be 2 or 3"):
        tconv.conv(torch.zeros(1, 4, 4, 4, 2), p, dims=2)
    with pytest.raises(ValueError, match="dims must be 2 or 3"):
        tconv.conv_general(torch.zeros(1, 4, 2), p["w"][0, 0], stride=1,
                           compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="dims must be 2 or 3"):
        tconv.conv_general(torch.zeros(1, 2, 2, 2, 2, 2), p["w"][None],
                           stride=1, compute_dtype=torch.float32)


def _grad_case(rng, kind, stride, shape=(8, 7, 6)):
    x = rng.standard_normal((2,) + shape + (5,)).astype(np.float32)
    w = _w(rng, 3, 5, 6)
    out = (tuple(s * stride for s in shape) if kind == "convt"
           else tuple(-(-s // stride) for s in shape))
    g = rng.standard_normal((2,) + out + (6,)).astype(np.float32)
    return x, w, g


KINDS = [("conv", 1), ("conv", 2), ("convt", 2)]


@pytest.mark.parametrize("kind,stride", KINDS)
def test_conv3d_grads_match_jax(rng, kind, stride):
    """dx and dw of the f32 3D conv vs jax.vjp of conv_general, 1e-5."""
    x, w, g = _grad_case(rng, kind, stride)
    y, vjp = jax.vjp(lambda xx, ww: jax_conv_general(
        xx, ww, strides=stride, padding="SAME", dims=3,
        compute_dtype=jnp.float32, kind=kind), jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    xt, wt = T(x).requires_grad_(), T(w).requires_grad_()
    got = tconv.conv_general(xt, wt, stride=stride, compute_dtype=torch.float32,
                             kind=kind)
    got.backward(T(g))
    for a, b in ((got.detach(), y), (xt.grad, want_dx), (wt.grad, want_dw)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("kind,stride", KINDS)
def test_conv3d_bf16_f32_weight_grad_matches_jax(rng, kind, stride):
    """The bf16 3D conv vs the JAX package's ``_conv_f32wgrad`` (its bf16
    ``conv_general``): y and dx bf16 within one ulp; dw an f32 tensor, never
    rounded to bf16, within 1e-5 of its max."""
    x, w, g = _grad_case(rng, kind, stride, shape=(9, 8, 6))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    y, vjp = jax.vjp(lambda xx, ww: jax_conv_general(
        xx, ww, strides=stride, padding="SAME", dims=3,
        compute_dtype=jnp.bfloat16, kind=kind), xb, jnp.asarray(w))
    want_dx, want_dw = vjp(gb)
    assert want_dw.dtype == jnp.float32
    xt = T(np.asarray(xb.astype(jnp.float32))).bfloat16().requires_grad_()
    wt = T(w).requires_grad_()
    got = tconv.conv_general(xt, wt, stride=stride,
                             compute_dtype=torch.bfloat16, kind=kind)
    assert got.dtype == torch.bfloat16
    got.backward(T(np.asarray(gb.astype(jnp.float32))).bfloat16())
    assert wt.grad.dtype == torch.float32
    _assert_bf16_close(got.float().detach().numpy(), y.astype(jnp.float32))
    _assert_bf16_close(xt.grad.float().numpy(), want_dx.astype(jnp.float32))
    want_dw = np.asarray(want_dw)
    np.testing.assert_allclose(wt.grad.numpy(), want_dw, rtol=0,
                               atol=1e-5 * np.abs(want_dw).max())


def test_batch_norm_5d_matches_jax(rng):
    """Eval and train BN on (B, D, H, W, C): y and the new running stats,
    f32 statistics with the JAX package's E[x^2] - E[x]^2."""
    x = (rng.standard_normal((2, 5, 6, 4, 7)) * 2 + 1).astype(np.float32)
    p = {"scale": rng.uniform(.5, 2, 7).astype(np.float32),
         "bias": rng.standard_normal(7).astype(np.float32)}
    s = {"mean": rng.standard_normal(7).astype(np.float32),
         "var": rng.uniform(.2, 3, 7).astype(np.float32)}
    tp = {k: T(v) for k, v in p.items()}
    ts = {k: T(v.copy()) for k, v in s.items()}
    want, _ = jax_batch_norm(jnp.asarray(x), p, s, train=False, eps=1e-3)
    got = tnorm.batch_norm(T(x), tp, ts, eps=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want, want_s = jax_batch_norm(jnp.asarray(x), p, s, train=True,
                                  momentum=0.99, eps=1e-3)
    got, got_s = tnorm.batch_norm_train(T(x), tp, ts, momentum=0.99, eps=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(want_s[k]),
                                   rtol=1e-5, atol=1e-5)


# -- model -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """(JAX params, BN state warmed by one JAX train forward, input 16^3
    batch 2). Dense inputs: on mostly empty volumes some channels' batch
    variance is a small difference of large moments (E[x^2] - E[x]^2),
    where f32 sums in another order differ by more than the tolerance."""
    rng = np.random.default_rng(5)
    params, state = uresnet_init(jax.random.PRNGKey(3), CFG)
    warm = rng.uniform(0, 1, (2, 16, 16, 16, 1)).astype(np.float32)
    _, state = uresnet_apply(params, state, warm, cfg=CFG, train=True)
    x = rng.uniform(0, 1, (2, 16, 16, 16, 1)).astype(np.float32)
    return jax.device_get((params, state)) + (x,)


def _model(cfg, params, state):
    model = UResNet(cfg, generator=torch.Generator().manual_seed(0))
    load_jax_params(model, params, state)
    return model


def test_conversion_carries_5d_kernels(pair):
    """The JAX trees load into the 3D model and come back leaf for leaf, as
    5-D (3, 3, 3, C_in, C_out) kernels under the JAX key names."""
    params, state, _ = pair
    model = _model(CFG, params, state)
    assert tuple(model.stem.conv.w.shape) == (3, 3, 3, 1, 4)
    assert tuple(model.enc1_b0.cb1.conv.w.shape) == (3, 3, 3, 8, 8)
    p2, s2 = jax_params(model)
    want = flatten_tree(params) | {f"s.{k}": v for k, v in flatten_tree(state).items()}
    got = flatten_tree(p2) | {f"s.{k}": v for k, v in flatten_tree(s2).items()}
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("pack", [False, True], ids=["canonical", "packed"])
def test_eval_forward_matches_jax(pair, pack):
    """The port's eval forward vs ``uresnet_apply`` with ``pack=False``
    and with ``pack=True``, the config as shipped: canonical against
    canonical, the port's packed forward against the JAX packed one."""
    params, state, x = pair
    cfg = dataclasses.replace(CFG, pack=pack)
    want, _ = uresnet_apply(params, state, x, cfg=cfg, train=False)
    model = _model(cfg, params, state)
    with torch.no_grad():
        got, got_state = model(T(x))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 16, 3)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())
    assert got_state["stem"]["bn"]["mean"] is model.stem.bn.mean


@pytest.fixture(scope="module")
def train_case(pair):
    params, state, x = pair
    rng = np.random.default_rng(11)
    label = rng.integers(0, 3, x.shape[:-1]).astype(np.int32)
    weight = rng.uniform(0.2, 3, x.shape[:-1]).astype(np.float32)

    def loss_fn(p):
        logits, new_state = uresnet_apply(p, state, x, cfg=CFG, train=True)
        return jax_xent(logits, label, weight), (logits, new_state)

    (loss, (logits, new_state)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    return (label, weight), jax.device_get(
        {"loss": loss, "logits": logits, "state": new_state, "grads": grads})


def _port_train(pair, train_case, remat):
    params, state, x = pair
    (label, weight), _ = train_case
    model = _model(dataclasses.replace(CFG, remat=remat), params, state)
    logits, new_state = model(T(x), train=True)
    loss = weighted_softmax_xent(logits, T(label), T(weight))
    loss.backward()
    return model, loss, logits, new_state


@pytest.mark.parametrize("remat", ["none", "level", "block"])
def test_train_forward_and_grads_match_jax(pair, train_case, remat):
    """Train mode: loss, logits, new BN state and every per-leaf gradient
    vs ``jax.value_and_grad`` of ``uresnet_apply(pack=False)``, each remat
    mode; the forward writes no buffer."""
    params, state, _ = pair
    _, want = train_case
    model, loss, logits, new_state = _port_train(
        pair, train_case, False if remat == "none" else remat)
    assert abs(loss.item() - float(want["loss"])) <= TOL * abs(float(want["loss"]))
    np.testing.assert_allclose(logits.detach().numpy(), want["logits"], rtol=0,
                               atol=TOL * np.abs(want["logits"]).max())
    got_s, want_s = flatten_tree(new_state), flatten_tree(want["state"])
    assert got_s.keys() == want_s.keys()
    for k in want_s:
        np.testing.assert_allclose(got_s[k].numpy(), want_s[k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    want_g = flatten_tree(want["grads"])
    got_g = {k: p.grad for k, p in model.named_parameters()}
    assert got_g.keys() == want_g.keys()
    for k, g in want_g.items():
        scale = max(np.abs(g).max(), 1e-12)
        np.testing.assert_allclose(got_g[k].numpy() / scale, g / scale,
                                   rtol=0, atol=TOL, err_msg=k)
    np.testing.assert_array_equal(model.stem.bn.mean.numpy(),
                                  state["stem"]["bn"]["mean"])


def test_folded_forward_matches_jax(pair, monkeypatch):
    """The BN-folded 3D forward vs the JAX fold (tests/test_fold.py's 3D
    case): every conv goes through conv/conv_transpose, no fused call and no
    kernel launch."""
    params, state, x = pair
    want = jax_apply_folded(jax_fold(params, state, CFG), x, cfg=CFG)
    model = _model(CFG, params, state)
    calls = []
    monkeypatch.setattr(fold, "fused_conv3x3_bn_relu_v2",
                        lambda *a, **kw: calls.append(a))
    before = (tfused.launches, tfused.launches_tensor_core,
              tfused.launches_f16_tensor_core)
    for backend in ("auto", "pallas", "xla"):
        cfg = dataclasses.replace(CFG, kernel_backend=backend)
        with torch.no_grad():
            folded = fold.kernel_operands(
                fold.fold_batchnorm(*trees(model), cfg), cfg)
            got = fold.uresnet_apply_folded(folded, T(x), cfg=cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL * np.abs(np.asarray(want)).max())
    assert calls == []
    assert (tfused.launches, tfused.launches_tensor_core,
            tfused.launches_f16_tensor_core) == before


# -- the f32 head over a bf16 model ------------------------------------------------

HEAD_CFG = dataclasses.replace(CFG, compute_dtype="bfloat16",
                               head_dtype="float32")
# the whole bf16 forward: chip_smoke.py's kernel-vs-cuDNN tolerances (bf16
# convs here and in XLA sum in other orders, so ~1e-4 of their outputs
# differ by a bf16 ulp, and that spreads through the layers)
FWD_MAX_SOFTMAX_DIFF, FWD_MIN_AGREE = 0.05, 0.98


def _bf16_head(params):
    w = jnp.asarray(params["head"]["w"]).astype(jnp.bfloat16).astype(jnp.float32)
    return dict(params, head=dict(params["head"], w=np.asarray(w)))


def _port_head(monkeypatch, params, state, x, cfg=HEAD_CFG):
    """The port's logits, and the head's bf16 input and f32 weight."""
    heads = []
    real = uresnet_mod.BlockCtx.conv  # every conv of the forward

    def head_conv(ctx, h, p, *args, **kw):
        if p["w"].shape[-1] == cfg.num_class:  # only the head's
            heads.append((h, p))
        return real(ctx, h, p, *args, **kw)

    monkeypatch.setattr(uresnet_mod.BlockCtx, "conv", head_conv)
    with torch.no_grad():
        got, _ = _model(cfg, params, state)(T(x))
    (h, p), = heads
    assert got.dtype == torch.float32 and h.dtype == torch.bfloat16
    return got, h, p


def _jax_head(h, p):
    """The JAX package's head on the same input: f32 compute at its
    ``head_precision`` (DEFAULT; true f32 on the CPU)."""
    hb = jnp.asarray(h.float().numpy()).astype(jnp.bfloat16)
    out = jax_conv(hb, {k: jnp.asarray(v.detach().numpy()) for k, v in p.items()},
                   dims=3, compute_dtype=jnp.float32,
                   precision=jconv_head_precision(jnp.float32, jnp.bfloat16))
    return np.asarray(out)


@pytest.mark.parametrize("pack", [False, True], ids=["canonical", "packed"])
def test_f32_head_semantics_equal_jax(pair, monkeypatch, pack):
    """bf16 model, f32 head, head weights already bf16-representable: on
    the same bf16 input the port's head equals the JAX package's within f32
    summation order, in f32 values that bf16 cannot hold; the whole forward
    agrees with ``uresnet_apply`` (pack=False and the shipped pack=True)
    at the bf16 forward tolerances."""
    params, state, x = pair
    params = _bf16_head(params)
    got, h, p = _port_head(monkeypatch, params, state, x)
    want_head = _jax_head(h, p)
    np.testing.assert_allclose(got.numpy(), want_head, rtol=0,
                               atol=1e-6 * np.abs(want_head).max())
    assert not torch.equal(got, got.bfloat16().float())
    cfg = dataclasses.replace(HEAD_CFG, pack=pack)
    want = np.asarray(uresnet_apply(params, state, x, cfg=cfg, train=False)[0])
    assert want.dtype == np.float32
    sm = torch.softmax(got, -1).numpy()
    sm_want = np.asarray(jax.nn.softmax(want, -1))
    assert np.abs(sm - sm_want).max() <= FWD_MAX_SOFTMAX_DIFF
    assert (sm.argmax(-1) == sm_want.argmax(-1)).mean() >= FWD_MIN_AGREE


def test_f32_head_differs_by_head_weight_rounding(pair, monkeypatch):
    """On unrounded head weights the JAX package on the CPU keeps the f32
    kernel where the port rounds it to bf16 (the TPU's DEFAULT pass). On the
    same input the difference is that rounding's: 4.2e-3 of the logits' max
    here (asserted between 1e-4 and 1e-2), and per voxel within 2^-9 (half
    a bf16 ulp) of the conv of |h| with |w|."""
    params, state, x = pair
    got, h, p = _port_head(monkeypatch, params, state, x)
    want = _jax_head(h, p)
    diff = np.abs(got.numpy() - want)
    rel = diff.max() / np.abs(want).max()
    assert 1e-4 < rel < 1e-2, rel
    with torch.no_grad():
        bound = tconv.conv(h.float().abs(), {"w": p["w"].detach().abs()}, dims=3,
                           compute_dtype=torch.float32).numpy()
    assert (diff <= 2.0 ** -9 * bound + 1e-6 * np.abs(want).max()).all()


def test_head_conv_allows_tf32_whatever_the_flag(monkeypatch):
    """The raised head convolves bf16-rounded operands with TF32 allowed in
    its forward and both gradients, even when an f32 model in the process
    turned the global flag off, and restores the flag; on the CPU it equals
    stock autograd of the rounded operands exactly."""
    entered = []
    real = tconv._tf32_convs

    def recording():
        entered.append(torch.backends.cudnn.allow_tf32)
        return real()

    monkeypatch.setattr(tconv, "_tf32_convs", recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(3)
    x = T(rng.standard_normal((1, 6, 5, 4, 16)).astype(np.float32)).bfloat16()
    w = T(_w(rng, 3, 16, 3))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = tconv.conv(xa, {"w": wa}, dims=3, compute_dtype=torch.float32,
                   precision=torch.bfloat16)
    g = torch.randn_like(y)
    y.backward(g)
    assert entered == [False, False] and not torch.backends.cudnn.allow_tf32
    xs = x.float().requires_grad_()
    ws = w.bfloat16().float().requires_grad_()
    ys = tconv.conv(xs, {"w": ws}, dims=3, compute_dtype=torch.float32)
    ys.backward(g)
    assert len(entered) == 2  # true f32 convs do not allow TF32
    torch.testing.assert_close(y, ys, rtol=0, atol=0)
    torch.testing.assert_close(wa.grad, ws.grad, rtol=0, atol=0)
    torch.testing.assert_close(xa.grad.float(), xs.grad.bfloat16().float(),
                               rtol=0, atol=0)
