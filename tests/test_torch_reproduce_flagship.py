"""The port's flagship reproducer
(uresnet_tpu_torch/tools/reproduce_flagship.py) against tools/
reproduce_flagship.py on the CPU: the same stage commands with the module
names mapped, the same held-out cache file, the ``metrics:`` parse and the
exit on a mismatched stage 4; and the four stages run end to end at a tiny
bf16 config on the CPU."""

import importlib.util
import json
import os
import shutil
import sys
import tempfile

import pytest

from uresnet_tpu_torch.tools import reproduce_flagship as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_reproduce_flagship",
        os.path.join(ROOT, "tools", "reproduce_flagship.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mapped(line):
    """A JAX stage command with the port's module names."""
    py = sys.executable
    return (line.replace(f"{py} tools/make_release_ckpt.py",
                         f"{py} -m uresnet_tpu_torch.tools.make_release_ckpt")
            .replace("-m uresnet_tpu.cli.", "-m uresnet_tpu_torch.cli."))


@pytest.mark.parametrize("flagship", ["2d", "3d"])
def test_dry_run_prints_jax_commands_mapped(flagship, capsys):
    jax_tool = _jax_tool()
    assert port.FLAGSHIPS == jax_tool.FLAGSHIPS
    assert jax_tool.main([flagship, "--dry-run"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert port.main([flagship, "--dry-run"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4
    assert got == [_mapped(line) for line in want]
    assert not any("uresnet_tpu." in line or "tools/" in line for line in got)
    # --device goes to both CLIs, and to nothing else
    assert port.main([flagship, "--dry-run", "--device", "cpu"]) == 0
    dev = capsys.readouterr().out.splitlines()
    assert dev == [g + (" --device cpu" if ".cli." in g else "")
                   for g in got]


def test_heldout_cache_equals_jax(tmp_path, monkeypatch):
    """The same file name, and the same bytes, from each package's loader
    (each side in its own temp dir)."""
    jax_tool = _jax_tool()
    paths = {}
    for side, fn in (("jax", jax_tool.heldout_cache),
                     ("port", port.heldout_cache)):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.setattr(tempfile, "tempdir", str(d))
        paths[side] = fn("configs/train_2d_512.yaml", 4)
        assert os.path.dirname(paths[side]) == str(d)
    assert os.path.basename(paths["jax"]) == os.path.basename(paths["port"])
    assert "_10007_" in os.path.basename(paths["port"])
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()


def test_metrics_line():
    out = "restored step 3\nmetrics: {'miou': 0.5, 'n_events': 4.0}\nbye\n"
    assert port.metrics_line(out) == "{'miou': 0.5, 'n_events': 4.0}"
    with pytest.raises(SystemExit, match="no 'metrics:' line"):
        port.metrics_line("restored step 3\n")


@pytest.mark.parametrize("same", [True, False], ids=["match", "mismatch"])
def test_stage4_must_equal_stage2(same, monkeypatch, capsys):
    """Stages run through ``run`` (stubbed): equal metrics lines print OK
    and return 0; a stage 4 that differs exits nonzero naming both."""
    calls = []

    def fake_run(cmd, *, dry, capture=False):
        calls.append(cmd)
        if not capture:
            return ""
        art = any(c.startswith("train.load_file=") for c in cmd)
        miou = 0.25 if (art and not same) else 0.5
        return f"restored step 7\nmetrics: {{'miou': {miou}}}\n"

    monkeypatch.setattr(port, "run", fake_run)
    monkeypatch.setattr(port, "heldout_cache", lambda cfg, n: "/held.usef")
    if same:
        assert port.main(["2d"]) == 0
        assert "OK: artifacts/q20k_bf16.npz" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit) as e:
            port.main(["2d"])
        assert e.value.code not in (0, None)
        assert "ARTIFACT MISMATCH" in str(e.value.code)
    assert [c[2] for c in calls] == [
        "uresnet_tpu_torch.cli.train", "uresnet_tpu_torch.cli.infer",
        "uresnet_tpu_torch.tools.make_release_ckpt",
        "uresnet_tpu_torch.cli.infer"]
    assert calls[1][calls[1].index("--input") + 1] == "/held.usef"


def test_reproduce_tiny_end_to_end(tmp_path, monkeypatch, capsys):
    """The four stages as subprocesses on the CPU at a tiny bf16 config
    (the release checkpoint is bit-exact only for bf16 compute): stage 4
    prints stage 2's metrics line exactly."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({
        "model": {"depth": 2, "base_filters": 4, "compute_dtype": "bfloat16"},
        "data": {"image_size": 32, "batch_size": 2, "planes": [0],
                 "num_threads": 1, "backend": "python"},
        "train": {"summary_iter": 2, "checkpoint_iter": 0, "val_iter": 0}}))
    name = f"tiny_{os.getpid()}"
    monkeypatch.setitem(port.FLAGSHIPS, "tiny", dict(
        config=str(cfg), iterations=2, train_events=4, heldout_events=3,
        name=name))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    parents = [os.path.join(port.REPO, d)
               for d in ("ckpt", "log", "artifacts")]
    new_parents = [d for d in parents if not os.path.exists(d)]
    written = [os.path.join(d, name) for d in parents[:2]]
    artifact = os.path.join(parents[2], f"{name}_bf16.npz")
    try:
        assert port.main(["tiny", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        lines = [ln for ln in out.splitlines() if ln.startswith("metrics: ")]
        assert len(lines) == 2 and lines[0] == lines[1]
        assert "'n_events': 3.0" in lines[0]
        assert f"OK: artifacts/{name}_bf16.npz" in out
        assert os.path.exists(artifact)
    finally:
        for d in written:
            shutil.rmtree(d, ignore_errors=True)
        if os.path.exists(artifact):
            os.remove(artifact)
        for d in new_parents:  # only what this test made, if left empty
            if os.path.isdir(d) and not os.listdir(d):
                os.rmdir(d)
