"""The lower-precision control: the reference with float8 e4m3 operands
(harness/quant.py ``fp8``) put in the program's place comes out not
correct under each cell's limits. On the CPU at a small size; with a
card, also at the cell's own size (``readings.py --control`` there reads
three seeds or more)."""

import pytest
import torch

import readings
import small
from harness import checks, loops, spec

SEED = 2 ** 31 + 303
CELLS = ["train_2d_512", "train_3d_192", "serve_2d_512", "serve_3d_192"]


def control_numbers(cell, device):
    if cell.mix["loop"] == "ana":
        return readings.ana_control(cell, SEED, device)
    pool = loops._pool(cell, SEED)
    views = [loops._view(cell, pool[i], cell.data["weight_mode"])
             for i in range(cell.mix["check_steps"])]
    from harness import weights

    params, _ = weights.split(cell, weights.make(cell, SEED, device,
                                                 serve=False))
    ref = loops.train_reference(cell, params, views, device)
    return readings.train_control(cell, SEED, device, ref)[0]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_small(name):
    cell = small.cell(name)
    numbers = control_numbers(cell, "cpu")
    assert not checks.judge(numbers, cell.limits)[0], numbers


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    cell = spec.cell(name)
    numbers = control_numbers(cell, torch.device("cuda"))
    assert not checks.judge(numbers, cell.limits)[0], numbers
