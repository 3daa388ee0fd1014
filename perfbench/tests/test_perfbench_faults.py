"""Runs of the harness with the timed path broken underneath, on the CPU
at a small size, held to the cells' own limits: each fault a cell can
have makes ``correct`` false, and the sound program keeps it true. (The
cells run on one card: no exchange between cards to leave out.)"""

import time

import pytest

import small
from harness import checks, faults, loops

SEED = 2 ** 31 + 101
CELLS = ["train_2d_512", "train_3d_192", "serve_2d_512", "serve_3d_192"]


def _correct(name: str, seconds: float = 0.2) -> bool:
    cell = small.cell(name, compute_dtype="float32")
    res = loops.run(cell, SEED, seconds, False, "cpu", time.perf_counter())
    return checks.judge(res["numbers"], cell.limits)[0]


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name):
    assert _correct(name)


@pytest.mark.parametrize("fault", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    kind = small.cell(name).mix["loop"]
    faults.FAULTS[kind][fault](monkeypatch.setattr)
    assert not _correct(name)



def test_sample_lists_what_the_window_missed():
    """The sampled batches that a window never reached, which the run
    serves after it so that it compares the whole sample."""
    s = loops._Sample(SEED, 2, [5, 9, 3, 7])
    assert 1 in s.want and len(s.want) in (2, 3)
    s.offer(1, {})
    assert s.missing() == sorted(s.want - {1})
    for i in s.missing():
        s.offer(i, {})
    assert s.missing() == [] and [i for i, _ in s.items()] == sorted(s.want)
