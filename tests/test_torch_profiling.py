"""The port's tracing hooks (uresnet_tpu_torch/engine/profiling.py) and
``cli.train --profile``, on the CPU.

``trace`` writes a Chrome trace holding the annotated region; ``annotate``
is a shared null context while no profiler records; under a profiler the
train step, the analysis step and the staging record their ``uresnet.*``
phase spans, each once a step, in order, none inside another;
``cli.train --profile DIR`` trains the first summary window inside a trace
that holds them and exits 0.
"""

import contextlib
import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from uresnet_tpu_torch.cli import train as cli_train
from uresnet_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                      OptimConfig, TrainConfig)
from uresnet_tpu_torch.engine import evaluator, profiling
from uresnet_tpu_torch.engine.export import build_logits_fn
from uresnet_tpu_torch.engine.trainer import Trainer

TRAIN = ["uresnet.train.densify", "uresnet.train.forward",
         "uresnet.train.loss", "uresnet.train.backward",
         "uresnet.train.optim"]
ANA = ["uresnet.ana.densify", "uresnet.ana.forward", "uresnet.ana.scores"]


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    logdir = tmp_path / "prof"
    with profiling.trace(str(logdir), device="cpu"):
        with profiling.annotate("uresnet.region"):
            torch.relu(torch.randn(64, 64)) @ torch.randn(64, 64)
    files = glob.glob(str(logdir / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "uresnet.region" in names and "aten::relu" in names


def test_annotate_is_a_shared_null_context_without_a_profiler():
    off = profiling.annotate("uresnet.a")
    assert off is profiling.annotate("uresnet.b")
    assert isinstance(off, contextlib.nullcontext)
    with profiling.annotate("uresnet.a"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pass
    assert not [e for e in prof.events() if e.name.startswith("uresnet.")]


def _cfg(dims: int) -> Config:
    return Config(
        model=ModelConfig(dims=dims, depth=2, base_filters=4, num_class=3,
                          compute_dtype="float32", pack=True,
                          pack_extra_h=dims == 2),
        data=DataConfig(image_size=16, batch_size=2 if dims == 2 else 1,
                        planes=(0,), weight_mode="class_balance",
                        max_points=128, backend="python"),
        optim=OptimConfig(lr=1e-3),
        train=TrainConfig(seed=3))


def _sparse(cfg: Config, seed: int = 0) -> dict:
    """A sparse batch of ``cfg``'s rows and size, 100 points a row."""
    rng = np.random.default_rng(seed)
    d, dims = cfg.data, cfg.model.dims
    rows, P, n = d.batch_size, d.max_points, 100
    cells = np.stack(np.unravel_index(np.arange(d.image_size ** dims),
                                      (d.image_size,) * dims), -1)
    coords = np.zeros((rows, P, dims), np.int16)
    values = np.zeros((rows, P), np.float32)
    labels = np.zeros((rows, P), np.uint8)
    for r in range(rows):
        coords[r, :n] = cells[rng.permutation(len(cells))[:n]]
        values[r, :n] = rng.uniform(1, 500, n)
        labels[r, :n] = rng.integers(0, 3, n)
    return {"coords": coords, "values": values, "labels": labels,
            "npoints": np.full(rows, n, np.int32),
            "shape": np.full((rows, dims), d.image_size, np.int32)}


def _events(prof):
    return sorted(prof.events(), key=lambda e: e.time_range.start)


def _spans(prof):
    return [e for e in _events(prof) if e.name.startswith("uresnet.")]


def _inside(e, outer) -> bool:
    return (outer.time_range.start <= e.time_range.start
            and e.time_range.end <= outer.time_range.end)


def _assert_siblings(spans):
    for i, a in enumerate(spans):
        others = spans[:i] + spans[i + 1:]
        assert not any(_inside(a, b) for b in others), a.name


@pytest.mark.parametrize("dims,light", [(2, True), (3, True), (2, False)])
def test_train_step_records_its_phase_spans_once_a_step(dims, light):
    """The phases of ``train_step_light`` (and of the summary step, with
    its metrics span last) once a step, in order, as siblings; the
    staging span holds the whole of ``device_batch``'s host work."""
    cfg = _cfg(dims)
    tr = Trainer(cfg, device="cpu")
    ts = tr.init_state()
    sparse = _sparse(cfg)
    step = tr.train_step_light if light else tr.train_step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function("test.device_batch"):
                batch = tr.device_batch(sparse)
            ts, metrics = step(ts, batch)
    phases = ["uresnet.stage"] + TRAIN + ([] if light else
                                          ["uresnet.train.metrics"])
    spans = _spans(prof)
    assert [e.name for e in spans] == phases * 2
    _assert_siblings(spans)
    assert np.isfinite(float(metrics["loss"]))
    events = _events(prof)
    for outer in (e for e in events if e.name == "test.device_batch"):
        (stage,) = [e for e in spans if e.name == "uresnet.stage"
                    and _inside(e, outer)]
        work = [e for e in events if _inside(e, outer)
                and e not in (outer, stage)]
        assert all(_inside(e, stage) for e in work), [e.name for e in work]


@pytest.mark.parametrize("dims", [2, 3])
def test_ana_step_records_its_phase_spans_once_a_batch(dims):
    cfg = _cfg(dims)
    tr = Trainer(cfg, device="cpu")
    logits_fn = build_logits_fn(cfg, tr.init_state().model)
    sparse = dict(_sparse(cfg, seed=1),
                  row_valid=np.ones((cfg.data.batch_size,), np.float32))
    batch = tr.device_batch(sparse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = [evaluator._ana_step_sparse(cfg, logits_fn, batch)
                for _ in range(2)]
    spans = _spans(prof)
    assert [e.name for e in spans] == ANA * 2
    _assert_siblings(spans)
    assert set(outs[0]) == set(outs[1]) > {"pscores", "origin"}


def test_cli_train_profile_exits_0_and_writes_a_trace(tmp_path, capsys):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({
        "model": {"depth": 2, "base_filters": 4, "compute_dtype": "float32"},
        "data": {"image_size": 32, "batch_size": 2, "planes": [0],
                 "synthetic": True, "synthetic_events": 8, "num_threads": 1},
        "train": {"iterations": 100, "summary_iter": 2, "checkpoint_iter": 0,
                  "val_iter": 0, "checkpoint_dir": str(tmp_path / "ckpt"),
                  "log_dir": str(tmp_path / "log")}}))
    prof = tmp_path / "prof"
    assert cli_train.main([str(cfg), "--device", "cpu", "--profile",
                           str(prof)]) == 0
    assert f"profile trace written to {prof}" in capsys.readouterr().out
    (trace,) = glob.glob(str(prof / "trace_*.json"))
    assert os.path.getsize(trace) > 0
    with open(trace) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    for span in TRAIN:
        assert names.count(span) == 2, span
    # fit stages prefetch_depth batches ahead of the step
    assert names.count("uresnet.stage") >= 2
    assert names.count("uresnet.train.metrics") == 1
    # the first summary window only: 2 steps, then the final checkpoint
    with open(tmp_path / "log" / "train_metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [2]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["LATEST",
                                                     "step_00000002.npz"]
