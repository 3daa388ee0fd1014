"""The port's serving artifact (uresnet_tpu_torch/engine/export.py,
uresnet_tpu_torch/tools/export_serving.py) against the JAX package's, on
the CPU; the cases of tests/test_export.py, plus the fused conv op's own.

The same numpy-seeded params (tests/test_export.py ``trained_ish_tree``)
are carried into the port by ``load_jax_params``. The loaded artifact is
held to the port's in-process serving forward, to the JAX eval forward and
to the JAX package's own loaded artifact of the same weights, at rtol/atol
2e-5 (f32, as tests/test_export.py). The metadata equals the JAX export's
but for ``format`` and ``platforms``. The op passes ``opcheck``, and the
exported 2D graph calls it once per eligible conv. The loaded call sets the
TF32 flags its model needs for its own duration only.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_export import trained_ish_tree
from uresnet_tpu.config import Config, ModelConfig
from uresnet_tpu.engine import export as jexport
from uresnet_tpu.models.uresnet import uresnet_apply
from uresnet_tpu_torch.config import load_config
from uresnet_tpu_torch.engine import export as texport
from uresnet_tpu_torch.models import fold
from uresnet_tpu_torch.models.convert import load_jax_params
from uresnet_tpu_torch.models.uresnet import UResNet
from uresnet_tpu_torch.ops.cuda import conv2d as tfused

TOL = 2e-5


def tiny_cfg(*, dims=2, pack=False, compute_dtype="float32", base=4,
             head_dtype=""):
    cfg = Config()
    cfg.model = ModelConfig(dims=dims, depth=2, base_filters=base,
                            blocks_per_level=2, compute_dtype=compute_dtype,
                            pack=pack, head_dtype=head_dtype)
    cfg.data.image_size = 16 if dims == 2 else 8
    cfg.data.batch_size = 2
    return cfg


def port_cfg(cfg, tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg.to_dict()))
    return load_config(str(path))


def port_model(pcfg, params, state):
    model = UResNet(pcfg.model, generator=torch.Generator().manual_seed(0))
    load_jax_params(model, params, state)
    return model


def port_artifact(tmp_path, cfg, params, state, name="m.uxm", **kw):
    """(loaded callable, metadata, port config, port model) of the port's
    export of ``params``/``state``."""
    pcfg = port_cfg(cfg, tmp_path)
    model = port_model(pcfg, params, state)
    payload, meta = texport.export_serving(pcfg, model, **kw)
    path = str(tmp_path / name)
    texport.save_serving(path, payload, meta)
    fn, meta2 = texport.load_serving(path, device="cpu")
    assert meta2 == json.loads(json.dumps(meta))
    return fn, meta, pcfg, model


def jax_artifact(tmp_path, cfg, params, state, **kw):
    payload, meta = jexport.export_serving(cfg, params, state,
                                           platforms=("cpu",), **kw)
    path = str(tmp_path / "jax.uxm")
    jexport.save_serving(path, payload, meta)
    return path, meta


def jax_softmax(cfg, params, state, x):
    logits, _ = uresnet_apply(jax.tree.map(jnp.asarray, params),
                              jax.tree.map(jnp.asarray, state),
                              jnp.asarray(x), cfg=cfg.model, train=False)
    return np.asarray(jax.nn.softmax(logits, axis=-1))


@pytest.mark.parametrize("dims", [2, 3])
def test_roundtrip_matches_eval_forward(tmp_path, dims):
    cfg = tiny_cfg(dims=dims)
    params, state = trained_ish_tree(cfg)
    fn, meta, pcfg, model = port_artifact(tmp_path, cfg, params, state)
    payload = texport.export_serving(pcfg, model)[0]
    assert torch.export.load(io.BytesIO(payload)).example_inputs is None
    S = cfg.data.image_size
    x = np.random.default_rng(3).random((2,) + (S,) * dims + (1,)).astype(
        np.float32)
    got = fn(x).numpy()
    assert got.shape == tuple(meta["output_shape"])
    want = texport.build_serving_fn(pcfg, model)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, jax_softmax(cfg, params, state, x),
                               rtol=TOL, atol=TOL)
    jpath, _ = jax_artifact(tmp_path, cfg, params, state)
    jfn, _ = jexport.load_serving(jpath)
    np.testing.assert_allclose(got, np.asarray(jfn(x)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_packed_trained_config_exports_canonical(tmp_path):
    """model.pack is a training-layout choice: the artifact is the
    canonical forward, and the metadata keeps pack as configured."""
    cfg = tiny_cfg(pack=True)
    params, state = trained_ish_tree(cfg, seed=5)
    fn, meta, _, _ = port_artifact(tmp_path, cfg, params, state, batch_size=1)
    x = np.random.default_rng(4).random((1, 16, 16, 1)).astype(np.float32)
    canon = tiny_cfg(pack=False)
    np.testing.assert_allclose(fn(x).numpy(),
                               jax_softmax(canon, params, state, x),
                               rtol=TOL, atol=TOL)
    assert meta["model"]["pack"] is True


def test_wrong_input_shape_raises(tmp_path):
    cfg = tiny_cfg()
    params, state = trained_ish_tree(cfg)
    fn, _, _, _ = port_artifact(tmp_path, cfg, params, state)
    with pytest.raises(Exception):  # the exported program's input guard
        fn(np.zeros((2, 8, 8, 1), np.float32))


def test_bad_magic_raises(tmp_path):
    path = tmp_path / "junk.uxm"
    path.write_bytes(b"NOTANART" + b"\0" * 16)
    with pytest.raises(ValueError, match="bad magic"):
        texport.load_serving(str(path), device="cpu")


def _rewrite_meta(src, dst, **changes):
    """Copy a .uxm with its metadata changed."""
    with open(src, "rb") as f:
        f.read(8)
        (n,) = np.frombuffer(f.read(4), "<u4")
        meta = json.loads(f.read(int(n)).decode())
        payload = f.read()
    meta.update(changes)
    texport.save_serving(dst, payload, meta)


def test_newer_version_raises(tmp_path):
    cfg = tiny_cfg()
    params, state = trained_ish_tree(cfg)
    port_artifact(tmp_path, cfg, params, state)
    newer = str(tmp_path / "newer.uxm")
    _rewrite_meta(str(tmp_path / "m.uxm"), newer,
                  version=texport.FORMAT_VERSION + 1)
    with pytest.raises(ValueError, match="newer than this reader"):
        texport.load_serving(newer, device="cpu")


def test_jax_artifact_raises(tmp_path):
    """A StableHLO .uxm of the JAX package is refused by its format name."""
    cfg = tiny_cfg()
    params, state = trained_ish_tree(cfg)
    jpath, _ = jax_artifact(tmp_path, cfg, params, state)
    with pytest.raises(ValueError,
                       match="'uresnet_tpu-serving'.*'uresnet_tpu_torch-serving'"):
        texport.load_serving(jpath, device="cpu")


def test_device_not_in_platforms_raises(tmp_path):
    cfg = tiny_cfg()
    params, state = trained_ish_tree(cfg)
    pcfg = port_cfg(cfg, tmp_path)
    payload, meta = texport.export_serving(
        pcfg, port_model(pcfg, params, state), platforms=("cuda",))
    path = str(tmp_path / "cuda_only.uxm")
    texport.save_serving(path, payload, meta)
    with pytest.raises(ValueError, match="exported for"):
        texport.load_serving(path, device="cpu")


def test_metadata_equals_jax_export(tmp_path):
    cfg = tiny_cfg(compute_dtype="bfloat16", head_dtype="float32")
    params, state = trained_ish_tree(cfg, seed=2)
    _, meta, _, _ = port_artifact(tmp_path, cfg, params, state, step=7)
    _, jmeta = jax_artifact(tmp_path, cfg, params, state, step=7)
    assert meta["format"] == "uresnet_tpu_torch-serving"
    assert meta["platforms"] == ["cuda", "cpu"]
    strip = lambda m: {k: v for k, v in json.loads(json.dumps(m)).items()
                       if k not in ("format", "platforms")}
    assert strip(meta) == strip(jmeta)
    assert strip(meta)["trained_step"] == 7


def test_cli_exports_from_real_checkpoint(tmp_path, capsys):
    """End to end: one Trainer step, save, export through the tool's main()
    with its selftest, then load and call here."""
    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.tools import export_serving as tool

    cfg = tiny_cfg()
    cfg.data.synthetic_events = 8
    cfg.data.num_threads = 1
    cfg.train.checkpoint_dir = str(tmp_path / "ck")
    cfg.train.log_dir = str(tmp_path / "log")
    cfg.train.iterations = cfg.train.summary_iter = 1
    cfg.train.checkpoint_iter = 1
    cfg.train.val_iter = 0
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    Trainer(load_config(str(cfg_path)), device="cpu").fit(iterations=1,
                                                          log=False)
    out = str(tmp_path / "model.uxm")
    assert tool.main(["--config", str(cfg_path), "--output", out,
                      "--devices", "cpu", "--device", "cpu", "--batch", "2",
                      "--selftest"]) == 0
    assert "selftest OK" in capsys.readouterr().out
    fn, meta = texport.load_serving(out, device="cpu")
    assert meta["trained_step"] == 1 and meta["platforms"] == ["cpu"]
    scores = fn(np.zeros(meta["input_shape"], np.float32)).numpy()
    np.testing.assert_allclose(scores.sum(-1), 1.0, rtol=1e-5)


# -- the fused conv op ---------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("op", ["v2", "v1"])
def test_opcheck(dtype, residual, op):
    """torch.library.opcheck on the CPU: schema, fake tensor, autograd
    registration and dispatch of both registered entry points."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 6, 5, 16, generator=g).to(dtype)
    w = (torch.randn(3, 3, 16, 32, generator=g) * 0.1).to(dtype)
    scale, bias = torch.rand(32, generator=g) + 0.5, torch.randn(32, generator=g)
    r = torch.randn(2, 6, 5, 32, generator=g).to(dtype) if residual else None
    fn = tfused._op_v2 if op == "v2" else tfused._op_v1
    torch.library.opcheck(fn, (x, w, scale, bias, r, residual))
    want = tfused.fused_conv3x3_bn_relu_v2_reference(x, w, scale, bias, r,
                                                     relu=residual)
    torch.testing.assert_close(fn(x, w, scale, bias, r, residual), want,
                               rtol=0, atol=0)


def _graph_ops(payload):
    program = torch.export.load(io.BytesIO(payload))
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function"]


def test_exported_graph_calls_the_op_at_every_eligible_conv(tmp_path,
                                                           monkeypatch):
    """A bf16 2D export holds one fused-op node per conv the fold sends to
    the kernel (counted in the in-process forward); a 3D export none."""
    cfg = tiny_cfg(compute_dtype="bfloat16", base=16)
    params, state = trained_ish_tree(cfg, seed=3)
    pcfg = port_cfg(cfg, tmp_path)
    model = port_model(pcfg, params, state)
    calls = []
    real = fold.fused_conv3x3_bn_relu_v2
    monkeypatch.setattr(fold, "fused_conv3x3_bn_relu_v2",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    texport.build_serving_fn(pcfg, model)(torch.zeros(1, 16, 16, 1))
    monkeypatch.undo()
    ops = _graph_ops(texport.export_serving(pcfg, model)[0])
    assert len(calls) == 20
    assert ops.count("uresnet_tpu_torch.fused_conv3x3_bn_relu_v2.default") == 20
    cfg3 = tiny_cfg(dims=3, compute_dtype="bfloat16", base=16,
                    head_dtype="float32")
    params3, state3 = trained_ish_tree(cfg3, seed=4)
    pcfg3 = port_cfg(cfg3, tmp_path)
    ops3 = _graph_ops(texport.export_serving(
        pcfg3, port_model(pcfg3, params3, state3))[0])
    assert not [o for o in ops3 if "uresnet_tpu_torch" in o]


@pytest.mark.parametrize("compute_dtype,head_dtype,dims,tf32", [
    ("float32", "", 2, False),           # true f32: TF32 off
    ("bfloat16", "float32", 3, True),    # config 4's raised head: TF32 on
])
def test_loaded_call_sets_tf32_for_itself(tmp_path, monkeypatch,
                                          compute_dtype, head_dtype, dims,
                                          tf32):
    """The loaded call runs with TF32 as its model needs it, whatever the
    caller's flags, gives the same scores under every setting of them, and
    leaves them as it found them."""
    cfg = tiny_cfg(dims=dims, compute_dtype=compute_dtype,
                   head_dtype=head_dtype)
    params, state = trained_ish_tree(cfg, seed=6)
    fn, meta, _, _ = port_artifact(tmp_path, cfg, params, state)
    inside = []
    real = texport._tf32

    @contextlib.contextmanager
    def recording(allow):
        with real(allow):
            inside.append((torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32))
            yield

    monkeypatch.setattr(texport, "_tf32", recording)
    x = np.random.default_rng(7).random(meta["input_shape"]).astype(np.float32)
    outs = []
    for cudnn_flag in (True, False):
        for matmul_flag in (True, False):
            monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", cudnn_flag)
            monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                                matmul_flag)
            outs.append(fn(x))
            assert (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32) == (cudnn_flag,
                                                               matmul_flag)
    assert inside == [(tf32, tf32)] * 4
    assert all(torch.equal(o, outs[0]) for o in outs)
