"""A run that finds no card, or no program, fails and prints no result."""

import os
import shutil
import subprocess
import sys

import torch

from harness import main, spec

ARGS = ["--workload", "train_2d_512", "--seed", "2147483659", "--seconds",
        "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_fails_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main.main(ARGS, 0.0) != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_fail(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert main.main(ARGS, 0.0) != 0
    assert capsys.readouterr().out == ""


def test_run_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and perfbench/."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "perfbench"),
                    tmp_path / "perfbench")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
