"""The port's TF1 checkpoint import (uresnet_tpu_torch/models/import_tf.py,
uresnet_tpu_torch/tools/import_tf_ckpt.py) against the JAX package's; the
cases of tests/test_import_tf.py.

The synthetic TF dumps are tests/test_import_tf.py's: built from a
randomized JAX tree by the importer's inverse transforms (tf.layers
numbered names, slim-style natural names, optimizer-slot noise, biased
convs, scale-less BNs). The port's import of each dump gives params and
state bit-equal to the JAX package's import and to the original tree; its
transforms are held to their definitions with the port's own convs; its
checkpoint restores in the port and serves the forward the JAX package
computes from the original tree.
"""

import os

import jax
import numpy as np
import pytest
import torch

from test_import_tf import (add_optimizer_noise, make_tf_dump,
                            randomized_tree, tiny_model)
from uresnet_tpu.config import ModelConfig
from uresnet_tpu.engine.checkpoint import _path_str
from uresnet_tpu.models import import_tf as jimport
from uresnet_tpu.models.uresnet import uresnet_apply
from uresnet_tpu_torch.config import Config as TConfig
from uresnet_tpu_torch.config import ModelConfig as TModelConfig
from uresnet_tpu_torch.engine.checkpoint import load_serving_state
from uresnet_tpu_torch.models import import_tf as timport
from uresnet_tpu_torch.models.convert import flatten_tree, load_jax_params
from uresnet_tpu_torch.models.uresnet import UResNet
from uresnet_tpu_torch.ops import conv as tconv
from uresnet_tpu_torch.ops import norm as tnorm


def tmodel(cfg: ModelConfig) -> TModelConfig:
    """The port's ModelConfig with the same fields."""
    return TModelConfig(**{f: getattr(cfg, f)
                           for f in TModelConfig.__dataclass_fields__})


def flat(tree):
    """'/'-keyed numpy leaves of a JAX tree or a port (dict) tree."""
    if any(isinstance(v, dict) for v in tree.values()):
        return {k.replace(".", "/"): np.asarray(v)
                for k, v in flatten_tree(tree).items()}
    return {_path_str(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_bit_equal(got, want):
    g, w = flat(got), flat(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def both(dump, cfg, **kw):
    """The port's import of ``dump``, after checking it bit-equal to the
    JAX package's (params, state and report)."""
    got = timport.map_tf_dump(dump, tmodel(cfg), **kw)
    want = jimport.map_tf_dump(dump, cfg, **kw)
    assert_bit_equal(got[0], want[0])
    assert_bit_equal(got[1], want[1])
    assert got[2] == want[2]
    return got


# -- transforms -----------------------------------------------------------------


@pytest.mark.parametrize("dims", [2, 3])
def test_tconv_transform_matches_tf_gradient_semantics(dims):
    """TF conv2d_transpose(x, w_tf) is the gradient of a SAME strided conv
    with kernel w_tf w.r.t. its input: the port's strided conv's autograd
    input gradient equals its conv_transpose of the imported kernel."""
    rng = np.random.default_rng(0)
    k, s, cin, cout, S = 3, 2, 4, 5, 6 if dims == 2 else 4
    x = torch.from_numpy(rng.standard_normal((2,) + (S,) * dims + (cin,))
                         .astype(np.float32))
    w_tf = rng.standard_normal((k,) * dims + (cout, cin)).astype(np.float32)
    a0 = torch.zeros((2,) + (s * S,) * dims + (cout,), requires_grad=True)
    y = tconv.conv_general(a0, torch.from_numpy(w_tf), stride=s,
                           compute_dtype=torch.float32)
    (y_tf,) = torch.autograd.grad(y, a0, x)
    w_ours = timport.tconv_kernel_from_tf(w_tf)
    np.testing.assert_array_equal(w_ours, jimport.tconv_kernel_from_tf(w_tf))
    y_ours = tconv.conv_general(x, torch.from_numpy(w_ours.copy()), stride=s,
                                compute_dtype=torch.float32, kind="convt")
    np.testing.assert_allclose(y_tf.numpy(), y_ours.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_tconv_transform_is_involution():
    w = np.random.default_rng(1).standard_normal((3, 3, 4, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        timport.tconv_kernel_from_tf(timport.tconv_kernel_from_tf(w)), w)


@pytest.mark.parametrize("train", [True, False])
def test_conv_bias_fold_into_bn_mean_is_exact(train):
    """BN(z + b) with stored mean m == BN(z) with stored mean m - b, in
    both modes, through the port's BatchNorm."""
    rng = np.random.default_rng(2)
    z = torch.from_numpy(rng.standard_normal((4, 8, 8, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    p = {"scale": torch.ones(5) + 0.3, "bias": torch.zeros(5) - 0.1}
    mean = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    var = torch.from_numpy(rng.random(5).astype(np.float32) + 0.5)
    bn = tnorm.batch_norm_train if train else tnorm.batch_norm
    y_ref = bn(z + b, p, {"mean": mean, "var": var})
    y_fold = bn(z, p, {"mean": mean - b, "var": var})
    if train:
        y_ref, y_fold = y_ref[0], y_fold[0]
    np.testing.assert_allclose(y_ref.numpy(), y_fold.numpy(), rtol=1e-5,
                               atol=1e-5)


# -- round trips ------------------------------------------------------------------


@pytest.mark.parametrize("style", ["numbered", "slim"])
def test_roundtrip_exact(style):
    cfg = tiny_model()
    params, state = randomized_tree(cfg)
    dump = add_optimizer_noise(make_tf_dump(params, state, cfg, style=style))
    items = list(dump.items())
    np.random.default_rng(3).shuffle(items)
    got_p, got_s, report = both(dict(items), cfg)
    assert_bit_equal(got_p, params)
    assert_bit_equal(got_s, state)
    assert len(report) == sum(len(g) for g in timport.unit_sequence(tmodel(cfg)))
    assert "transform" in timport.format_report(report)


def test_roundtrip_3d():
    cfg = tiny_model(dims=3, depth=1, base=2, blocks=1)
    params, state = randomized_tree(cfg, seed=5)
    got_p, got_s, _ = both(make_tf_dump(params, state, cfg), cfg)
    assert_bit_equal(got_p, params)
    assert_bit_equal(got_s, state)


def test_roundtrip_with_biases_and_missing_gamma():
    """Conv biases fold into BN means, proj biases into cb2 betas, a
    scale-less BN gets gamma=1/beta=0: bit-equal to the JAX import."""
    cfg = tiny_model()
    params, state = randomized_tree(cfg, seed=7)
    params["down0"]["bn"]["scale"] = np.ones_like(
        np.asarray(params["down0"]["bn"]["scale"]))
    params["down0"]["bn"]["bias"] = np.zeros_like(
        np.asarray(params["down0"]["bn"]["bias"]))
    rng = np.random.default_rng(8)
    f1 = cfg.base_filters * 2
    cb = {"stem": rng.standard_normal(cfg.base_filters).astype(np.float32),
          "up1": rng.standard_normal(f1).astype(np.float32)}
    pb = rng.standard_normal(f1).astype(np.float32)
    params_tf = jax.tree.map(np.asarray, params)
    params_tf["dec1_b0"]["cb2"]["bn"]["bias"] = (
        params_tf["dec1_b0"]["cb2"]["bn"]["bias"] - pb)
    dump = make_tf_dump(params_tf, state, cfg, conv_bias=cb,
                        proj_bias={"dec1_b0": pb}, drop_gamma=("down0",))
    got_p, got_s, report = both(dump, cfg)
    for got, want in ((got_p, params), (got_s, state)):
        g, w = flat(got), flat(want)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0,
                                       err_msg=k)
    notes = {r[0]: r[2] for r in report}
    assert "folded into BN mean" in notes["stem"]
    assert "folded into cb2 BN beta" in notes["dec1_b0/proj"]


def test_spec_overlay_fixes_wrong_numbering():
    cfg = tiny_model()
    params, state = randomized_tree(cfg, seed=9)
    dump = make_tf_dump(params, state, cfg)
    swapped = dict(dump)
    swapped["conv2d_1/kernel"], swapped["conv2d_2/kernel"] = (
        dump["conv2d_2/kernel"], dump["conv2d_1/kernel"])
    got_p, _, _ = both(swapped, cfg)
    assert not np.allclose(got_p["enc0_b0"]["cb1"]["conv"]["w"],
                           np.asarray(params["enc0_b0"]["cb1"]["conv"]["w"]))
    spec = {"enc0_b0/cb1": "conv2d_2", "enc0_b0/cb2": "conv2d_1"}
    got_p, got_s, _ = both(swapped, cfg, spec=spec)
    assert_bit_equal(got_p, params)
    assert_bit_equal(got_s, state)


def test_proj_position_is_shape_disambiguated():
    cfg = tiny_model(depth=1, blocks=1)
    params, state = randomized_tree(cfg, seed=11)
    dump = make_tf_dump(params, state, cfg)
    names = [k for k in dump if k.endswith("/kernel") and "transpose" not in k]
    shapes = {n: dump[n].shape for n in names}
    proj_name = next(n for n, s in shapes.items() if s[0] == 1)
    cb1_name = sorted((n for n, s in shapes.items()
                       if s == (3, 3, cfg.base_filters * 2, cfg.base_filters)),
                      key=len)[0]
    swapped = dict(dump)
    swapped[proj_name], swapped[cb1_name] = dump[cb1_name], dump[proj_name]
    got_p, got_s, _ = both(swapped, cfg)
    assert_bit_equal(got_p, params)
    assert_bit_equal(got_s, state)


# -- failure modes ------------------------------------------------------------------


def test_wrong_architecture_count_raises():
    cfg = tiny_model()
    dump = make_tf_dump(*randomized_tree(cfg), cfg)
    with pytest.raises(timport.TFImportError, match="needs"):
        timport.map_tf_dump(dump, tmodel(tiny_model(depth=3)))


def test_shape_mismatch_names_unit():
    cfg = tiny_model()
    dump = make_tf_dump(*randomized_tree(cfg), cfg)
    dump["conv2d/kernel"] = dump["conv2d/kernel"][..., :2]
    with pytest.raises(timport.TFImportError, match="stem"):
        timport.map_tf_dump(dump, tmodel(cfg))


def test_unknown_spec_scope_raises():
    cfg = tiny_model()
    dump = make_tf_dump(*randomized_tree(cfg), cfg)
    with pytest.raises(timport.TFImportError, match="unknown TF scope"):
        timport.map_tf_dump(dump, tmodel(cfg), spec={"stem": "nope/nothing"})


# -- end to end -------------------------------------------------------------------


def test_import_checkpoint_restores_and_forward_matches(tmp_path):
    """The port writes a step-0 checkpoint in the JAX layout (the same
    leaves as the JAX package's import, bit-equal but for the PRNG key);
    the port's Trainer restores it for fine-tuning, and its eval forward
    equals the JAX forward of the original tree."""
    from uresnet_tpu_torch.engine.trainer import Trainer

    jcfg = tiny_model()
    params, state = randomized_tree(jcfg, seed=13)
    dump = make_tf_dump(params, state, jcfg)
    mcfg = tmodel(jcfg)
    path = timport.write_import_checkpoint(
        str(tmp_path / "imported"), *timport.map_tf_dump(dump, mcfg)[:2], mcfg)
    assert path.endswith("step_00000000.npz")
    jpath = jimport.write_import_checkpoint(
        str(tmp_path / "jax"), *jimport.map_tf_dump(dump, jcfg)[:2], jcfg)
    with np.load(path) as z, np.load(jpath) as jz:
        assert set(z.files) == set(jz.files)
        for k in jz.files:
            assert z[k].shape == jz[k].shape and z[k].dtype == jz[k].dtype, k
            if k != "train_state/key":
                np.testing.assert_array_equal(z[k], jz[k], err_msg=k)

    cfg = TConfig()
    cfg.model = mcfg
    cfg.train.checkpoint_dir = str(tmp_path / "ck")
    cfg.train.log_dir = str(tmp_path / "log")
    cfg.train.load_file = path
    cfg.train.load_params_only = True
    ts, step, cursor = Trainer(cfg, device="cpu").restore()
    assert step == 0 and cursor == 0
    x = np.random.default_rng(14).random((2, 16, 16, 1)).astype(np.float32)
    with torch.no_grad():
        got, _ = ts.model(torch.from_numpy(x))
    want, _ = uresnet_apply(params, state, x, cfg=jcfg, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_convert_tool_cli(tmp_path, capsys):
    """``python -m uresnet_tpu_torch.tools.import_tf_ckpt convert`` end to
    end, with --report and --dry-run; the written params and BN state equal
    the JAX tool's."""
    from uresnet_tpu_torch.tools import import_tf_ckpt as tool

    cfg = tiny_model()
    params, state = randomized_tree(cfg, seed=15)
    dump_path = tmp_path / "vars.npz"
    np.savez(dump_path, **add_optimizer_noise(make_tf_dump(params, state, cfg)))
    cfg_path = tmp_path / "m.json"
    cfg_path.write_text(
        '{"model": {"depth": 2, "base_filters": 4, "blocks_per_level": 2,'
        ' "compute_dtype": "float32"}}')
    assert tool.main(["convert", str(dump_path), str(tmp_path / "out"),
                      "--config", str(cfg_path), "--report", "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "dry run" in out and "stem" in out
    assert not (tmp_path / "out").exists()
    assert tool.main(["convert", str(dump_path), str(tmp_path / "out"),
                      "--config", str(cfg_path)]) == 0
    path = tmp_path / "out" / "step_00000000.npz"
    assert os.path.exists(path)
    got_p, got_s, step = load_serving_state(str(path))
    assert step == 0
    model = UResNet(tmodel(cfg), generator=torch.Generator())
    load_jax_params(model, got_p, got_s)
    assert_bit_equal(got_p, params)
    assert_bit_equal(got_s, state)
