"""The control of each cell's check, the reference computed in TF32 in
the program's place, must come out not correct.  Here at a tiny size on
the CPU (TF32 emulated by rounding each product's operands); the card
test runs it at the cell's own size on three seeds."""

import pytest
import torch

from perfbench import harness

from conftest import tiny_cell

CELLS = ["aceff_pbc10.md_25k", "aceff.serve_b128"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_a_tiny_size(cell, one_thread):
    c = tiny_cell(cell)
    readings = c.driver().control(c, 2 ** 35 + 3, torch.device("cpu"))
    assert any(v > lim for _, v, lim in readings), readings


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_full_size(cell, card):
    c = harness.Cell(cell)
    for seed in (2 ** 36 + 1, 2 ** 36 + 2, 2 ** 36 + 3):
        readings = c.driver().control(c, seed, card)
        assert any(v > lim for _, v, lim in readings), (seed, readings)
        torch.cuda.empty_cache()
