"""The port's profiling hooks (uresnet_tpu_torch/engine/profiling.py) and
``cli.train --profile``, on the CPU (port of uresnet_tpu/engine/profiling.py).

``trace`` writes a Chrome trace holding the annotated region; ``StepTimer``
reports on window edges only, with the JAX package's arithmetic;
``cli.train --profile DIR`` trains the first summary window inside a trace
and exits 0, as the JAX CLI does.
"""

import glob
import json
import os

import pytest
import torch

from uresnet_tpu.engine import profiling as jprofiling
from uresnet_tpu_torch.cli import train as cli_train
from uresnet_tpu_torch.engine import profiling


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    logdir = tmp_path / "prof"
    with profiling.trace(str(logdir), device="cpu"):
        with profiling.annotate("uresnet_region"):
            torch.relu(torch.randn(64, 64)) @ torch.randn(64, 64)
    files = glob.glob(str(logdir / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "uresnet_region" in names and "aten::relu" in names


def test_device_sync_accepts_trees():
    profiling.device_sync({"a": [torch.zeros(2)], "b": 1})
    profiling.device_sync([])  # nothing to wait for


@pytest.mark.parametrize("window", [1, 3])
def test_step_timer_reports_on_window_edges(monkeypatch, window):
    """The port's StepTimer and the JAX package's, on the same clock: the
    same ticks report, with the same numbers."""
    clock = iter(range(0, 1000, 2))
    now = {}

    def fake_clock():
        now["t"] = next(clock) / 10
        return now["t"]

    for mod in (profiling, jprofiling):
        monkeypatch.setattr(mod.time, "perf_counter", fake_clock)
    outs = []
    for Timer in (profiling.StepTimer, jprofiling.StepTimer):
        clock = iter(range(0, 1000, 2))
        t = Timer(window=window)
        outs.append([t.tick(4) for _ in range(3 * window)])
    ours, theirs = outs
    assert ours == theirs
    reported = [i for i, o in enumerate(ours) if o is not None]
    assert reported == [2 * window - 1, 3 * window - 1]
    assert ours[-1]["images_per_sec"] == pytest.approx(4 * window / 0.2)
    assert ours[-1]["step_ms"] == pytest.approx(200 / window)


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
    # the first summary window only: 2 steps, then the final checkpoint
    with open(tmp_path / "log" / "train_metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [2]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["LATEST",
                                                     "step_00000002.npz"]
