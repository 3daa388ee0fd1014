"""The port's benchmark (uresnet_tpu_torch/tools/bench.py) against bench.py
on the CPU: its own MAC count equals benchmarks/flops.py's, the config it
builds for each flag equals the one bench.py builds (captured at bench.py's
Trainer, off the TPU and with a stand-in TPU), and a ``--quick --device
cpu`` run of each mode prints one JSON line with bench.py's keys."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types

import pytest

from uresnet_tpu_torch.tools import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, *path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dims,size,depth,base,batch", [
    (2, 512, 5, 16, 32), (2, 128, 5, 16, 4), (2, 64, 3, 8, 2),
    (2, 256, 4, 32, 1), (3, 192, 4, 16, 1), (3, 32, 4, 16, 2),
    (3, 64, 2, 4, 3)])
def test_macs_equal_benchmarks_flops(dims, size, depth, base, batch):
    flops = _load("jax_flops", "benchmarks", "flops.py")
    kw = dict(size=size, batch=batch, dims=dims, depth=depth, base=base)
    assert bench.uresnet_forward_macs(**kw) == flops.uresnet_forward_macs(**kw)


class _Captured(Exception):
    pass


def _jax_bench_config(monkeypatch, argv, on_tpu):
    """The Config bench.py builds for ``argv``: its Trainer replaced by one
    that raises with the config; ``on_tpu`` stands a TPU in for the
    device list."""
    import jax

    import uresnet_tpu.engine.trainer as jtrainer
    import uresnet_tpu.parallel.mesh as jmesh

    def capture(cfg, mesh=None):
        raise _Captured(cfg)

    monkeypatch.setattr(jtrainer, "Trainer", capture)
    monkeypatch.setattr(jmesh, "make_mesh", lambda *a, **k: None)
    if on_tpu:
        monkeypatch.setattr(jax, "devices", lambda *a: [
            types.SimpleNamespace(platform="tpu")])
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    with pytest.raises(_Captured) as e:
        _load("jax_bench", "bench.py").main()
    return e.value.args[0]


FLAG_SETS = {
    "default": [], "quick": ["--quick"], "3d": ["--dims", "3"],
    "3d-batch2": ["--dims", "3", "--batch", "2"],
    "3d-quick": ["--dims", "3", "--quick"],
    "no-pack": ["--no-pack"], "freeze": ["--freeze", "stem*,enc0*"],
    "remat-level": ["--remat", "level"], "remat-false": ["--remat", "False"],
    "3d-remat-false": ["--dims", "3", "--batch", "2", "--remat", "false"],
    "knobs": ["--no-pack-extra-h", "--pack-threshold", "128", "--dtype",
              "float32", "--head-dtype", "bfloat16", "--base-filters", "8",
              "--size", "64", "--batch", "3", "--infer"],
}


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "card"])
@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_config_equals_jax_bench(flags, on_card, monkeypatch):
    argv = FLAG_SETS[flags]
    want = _jax_bench_config(monkeypatch, argv, on_tpu=on_card)
    args = bench.parse_args(argv)
    cfg, steps = bench.bench_config(args, on_card=on_card)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert steps == (min(args.steps, 5) if args.quick else args.steps)


TRAIN_KEYS = {"metric", "value", "unit", "vs_baseline", "useful_tflops",
              "raw_tflops", "baseline_note"}
INFER_KEYS = TRAIN_KEYS - {"baseline_note"}


@pytest.mark.parametrize("mode,extra,metric,keys", [
    ("train", [], "train_images_per_sec_per_chip_128x128_2d", TRAIN_KEYS),
    ("infer", ["--infer"], "infer_images_per_sec_per_chip_128_2d",
     INFER_KEYS),
    ("3d", ["--dims", "3"], "train_images_per_sec_per_chip_32x32_3d",
     TRAIN_KEYS)])
def test_quick_run_prints_one_json_line(mode, extra, metric, keys):
    proc = subprocess.run(
        [sys.executable, "-m", "uresnet_tpu_torch.tools.bench", "--quick",
         "--steps", "1", "--device", "cpu", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    out = json.loads(lines[0])
    assert set(out) == keys
    assert out["metric"] == metric
    assert out["unit"] == "images/sec/chip"
    assert out["value"] > 0 and out["useful_tflops"] >= 0
    # the packed step issues more than the canonical model's useful math
    assert out["raw_tflops"] >= out["useful_tflops"]
    assert out["vs_baseline"] == 0.0  # baseline_cpu.json has no 128 / 32 key
