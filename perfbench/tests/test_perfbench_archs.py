"""The architecture modules (archs/<arch>.py): the dense U-ResNet's gives
what the harness's direct calls of harness/reference.py and
harness/flops.py give, a run reaches every hook through the cell's
module, and a configuration without a known architecture is refused."""

import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

import small
from harness import checks, events, loops, quant, reference, spec, weights

SEED = 2 ** 31 + 29
HOOKS = ["leaf_shapes", "is_stat", "view", "calibrate", "train_steps",
         "train_logits", "analyse", "batch_flops"]
# sha256 over each leaf's name and float32 bytes, in order, of the seeded
# draw at SEED on the CPU, and the FLOPs of a forward and of a training
# step of one pool batch: as the harness made and counted them before it
# asked an architecture module (flops.forward_flops, train_step_flops)
PINNED = {
    "train_2d_512": {
        "train": "7734fc8e267fde32682f38f07ff95d4575e67b6d329c275759e8af6e7ae56882",
        "serve": "1989f4e16e13201f90c51e088f1c7fd0cefe8e47ed8038320eeda1ad22dacf2d",
        "leaves": 282, "forward": 2139967455232, "step": 6419902365696},
    "train_3d_192": {
        "train": "2b29f8eb753c83ddb43a8aedac1de997e18c5704eeb7ecdb57566502a82741d3",
        "serve": "6c12d5ef1e61231a33f391a05060ec28d5e3a36066a9f092a3de46c5b5c97a0e",
        "leaves": 231, "forward": 1805371047936, "step": 5416113143808},
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_leaves_draws_and_flops_are_the_old_ones(name):
    cell = spec.cell(name)
    conf, want = cell.config, PINNED[name]
    shapes = cell.arch.leaf_shapes(conf)
    assert list(shapes.items()) == list(
        reference.leaf_shapes(cell.model).items())
    assert len(shapes) == want["leaves"]
    assert [cell.arch.is_stat(k) for k in shapes] == [
        reference.is_stat(k) for k in shapes]
    for mode in ("train", "serve"):
        leaves = weights.make(cell, SEED, "cpu", serve=mode == "serve")
        h = hashlib.sha256()
        for k, v in leaves.items():
            h.update(k.encode())
            h.update(v.numpy().tobytes())
        assert h.hexdigest() == want[mode], mode
    # the dense count reads nothing of the batch
    for batch in events.make_pool(SEED, batches=2, batch_size=2,
                                  shape=(40,) * cell.model["dims"],
                                  max_points=64):
        assert cell.arch.batch_flops(conf, batch, train=False) == \
            want["forward"]
        assert cell.arch.batch_flops(conf, batch, train=True) == want["step"]


def _equal(a, b):
    """Bit-equal nested results: dicts, lists, tensors, arrays, floats."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("train,serve", [("train_2d_512", "serve_2d_512"),
                                         ("train_3d_192", "serve_3d_192")])
def test_reference_hooks_are_the_direct_calls(train, serve):
    """At the small cells' sizes: each hook bit-equal to the call of
    harness/reference.py that the harness made before."""
    cell = small.cell(train)
    conf, arch, m, d = cell.config, cell.arch, cell.model, cell.data
    pool = loops._pool(cell, SEED)

    def densify(batch, mode):
        return reference.densify(
            batch, size=d["image_size"], scale=d["normalize_scale"],
            clip=d["normalize_clip"], weight_mode=mode,
            num_class=m["num_class"])

    views = [arch.view(conf, b, d["weight_mode"]) for b in pool[:2]]
    for v, b in zip(views, pool):
        want = densify(b, d["weight_mode"])
        label = np.take_along_axis(want["label"].reshape(len(want["flat"]), -1),
                                   want["flat"], 1)
        _equal(v, dict(want, point_label=label))
    params, _ = weights.split(cell, weights.make(cell, SEED, "cpu",
                                                 serve=False))
    _equal(arch.train_steps(conf, params, views, device="cpu"),
           reference.train_steps(m, cell.optim, params, views, device="cpu"))
    for q in (None, quant.bf16):
        _equal(arch.train_logits(conf, params, views[0], device="cpu",
                                 quant=q),
               reference.train_logits(m, params, views[0], device="cpu",
                                      quant=q))

    cell = small.cell(serve)
    conf, m = cell.config, cell.model
    leaves = weights.make(cell, SEED, "cpu", serve=True)
    params, stats = weights.split(cell, leaves)
    view = arch.view(conf, pool[0], "ones")
    arch.calibrate(conf, leaves, view, device="cpu")
    with torch.no_grad(), reference.true_f32():
        reference.forward(params, stats, torch.as_tensor(view["data"]), m,
                          mode="calibrate")
    _equal(weights.split(cell, leaves)[1], stats)
    for q in (None, quant.fp8):
        _equal(arch.analyse(conf, params, stats, view, device="cpu", quant=q),
               reference.analyse(m, params, stats, view, device="cpu",
                                 quant=q))


STUB = '''
"""An architecture that hands every hook to the real archs/uresnet.py
and records which it was asked for."""
import importlib.util

_spec = importlib.util.spec_from_file_location("perfbench_arch_real", {real!r})
real = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(real)
CALLS = set()


def _recorded(name):
    fn = getattr(real, name)

    def hook(*args, **kwargs):
        CALLS.add(name)
        return fn(*args, **kwargs)
    return hook


for _name in {hooks!r}:
    globals()[_name] = _recorded(_name)
'''


def test_a_stub_architecture_reaches_every_hook(tmp_path, monkeypatch):
    """A small train cell and a small ana cell, traced, through a module in
    another archs/ directory: between them every hook is asked for, the
    runs are correct, and the window's FLOPs are the module's count."""
    (tmp_path / "uresnet.py").write_text(STUB.format(
        real=os.path.join(spec.ARCHS, "uresnet.py"), hooks=HOOKS))
    monkeypatch.setattr(spec, "ARCHS", str(tmp_path))
    calls = set()
    for name in ("train_2d_512", "serve_2d_512"):
        cell = small.cell(name, compute_dtype="float32")
        assert cell.arch.__file__ == str(tmp_path / "uresnet.py")
        res = loops.run(cell, SEED, 0.2, True, "cpu", time.perf_counter())
        assert checks.judge(res["numbers"], cell.limits)[0]
        run = res["traced"]
        train = cell.mix["loop"] == "train"
        assert run.flops == run.steps * cell.arch.real.batch_flops(
            cell.config, None, train=train)
        calls |= cell.arch.CALLS
    assert calls == set(HOOKS)


@pytest.mark.parametrize("arch", [None, "no_such_arch"])
def test_cell_refuses_a_configuration_without_a_known_arch(tmp_path,
                                                          monkeypatch, arch):
    bench = spec.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == "uresnet2d_512")
    with open(os.path.join(spec.ROOT, entry["file"])) as f:
        conf = json.load(f)
    conf.pop("arch")
    if arch is not None:
        conf["arch"] = arch
    path = tmp_path / "uresnet2d_512.json"
    path.write_text(json.dumps(conf))
    entry["file"] = str(path)
    monkeypatch.setattr(spec, "load_benchmark", lambda: bench)
    with pytest.raises(ValueError, match="uresnet2d_512.json") as err:
        spec.cell("train_2d_512")
    assert "'uresnet'" in str(err.value)
