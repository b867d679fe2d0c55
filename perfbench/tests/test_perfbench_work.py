"""The work counts against hand counts on systems small enough to count
by hand."""

import pytest
import torch

from perfbench.harness import least_seconds
from perfbench.work import edge_mlp_pre, embedding, model_step, pairs, q_tier

CFG = dict(embedding_dimension=2, num_rbf=1, q_dim=1, num_layers=1,
           cutoff_upper=1.5, coulomb_cutoff=None)


def line_of_three():
    pos = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0]])
    return pos, torch.zeros(3, dtype=torch.long)


def test_pairs_on_a_line():
    pos, batch = line_of_three()
    # (0,1) (1,0) (1,2) (2,1) within 1.5; (0,2) at 2.0 is not
    assert pairs.count_within(pos, batch, 1.5) == 4
    assert pairs.count_within(pos, batch, 2.5) == 6
    g = pairs.geometry(CFG, pos, batch)
    # the three self pairs join the four; every ordered pair for Coulomb
    assert g == {"atoms": 3, "molecules": 1, "pairs": 7, "coulomb_pairs": 6}


def test_pairs_across_the_box_and_molecules():
    pos = torch.tensor([[0.2, 5.0, 5.0], [9.9, 5.0, 5.0], [5.0, 5.0, 5.0]])
    batch = torch.tensor([0, 0, 1])
    box = torch.tensor([10.0, 10.0, 10.0])
    # 0 and 1 are 0.3 apart through the face; 2 is another molecule
    assert pairs.count_within(pos, batch, 1.0, box) == 2
    assert pairs.count_within(pos, batch, 1.0) == 0
    cfg = dict(CFG, coulomb_cutoff=6.0)
    g = pairs.geometry(cfg, pos, batch, box)
    assert g["pairs"] == 5 and g["coulomb_pairs"] == 2 and g["molecules"] == 2


def test_group_counts_by_hand():
    geom = {"atoms": 3, "molecules": 1, "pairs": 7, "coulomb_pairs": 6}
    # F = 2, R = 1, L = 1
    assert embedding.count(CFG, geom) == {
        "tc": 7 * 2 * (2 * 1 * 6), "fp32": 7 * 67 * 2,
        "bytes": 7 * 56 + 3 * 8 * (4 + 18) + 4 * 2 * 6}
    mlp = 2 * 2 + 2 * 2 * 4 + 2 * 4 * 6          # rbf W1a, W2, W3
    weights = 4 * (2 + 8 + 4 + 24 + 6)
    assert q_tier.count(CFG, geom) == {
        "tc": 7 * 2 * mlp, "fp32": 7 * 67 * 2,
        "bytes": 7 * 20 + 3 * 4 * 51 * 2 + 2 * weights}
    assert edge_mlp_pre.count(CFG, geom) == {
        "tc": 7 * (16 + 48), "fp32": 7 * 18,
        "bytes": 7 * 4 * 9 + 4 * (8 + 24 + 10)}


def test_model_step_by_hand():
    geom = {"atoms": 3, "molecules": 1, "pairs": 7, "coulomb_pairs": 6}
    f, r, q = 2, 1, 1
    atom = (4 + 16 + 18 + 2 * 8 + 36 + 6 + 1) * f * f \
        + 2 * 4 * q * f + 4 * q * f + 162 * f + f
    pair = 6 * r * f + 23 * f + 2 * r * f + 16 * f * f + 23 * f
    assert model_step.flops(CFG, geom) == 2 * (3 * atom + 7 * pair
                                                + 6 * (6 * q + 20))


@pytest.mark.parametrize("work, peak, want", [
    ({"tc": 0, "fp32": 67.0, "bytes": 0}, (67.0, 1.0, 495.0), 1.0),
    ({"tc": 165.0, "fp32": 0, "bytes": 0}, (67.0, 1.0, 495.0), 1.0),
    ({"tc": 1.0, "fp32": 1.0, "bytes": 10.0}, (67.0, 5.0, 495.0), 2.0),
])
def test_least_seconds(work, peak, want):
    assert least_seconds(work, peak) == pytest.approx(want)
