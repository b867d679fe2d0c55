"""The plain reference against the program's plain path on the CPU, at a
tiny size: molecules with the all-to-all head, and a periodic box with
the reaction-field head on the gather and the blocked paths."""

import numpy as np
import pytest
import torch

from perfbench import systems
from perfbench.reference import tensornet2 as ref

from conftest import TINY_MODEL, tiny_cell

# float32 sums in another order: the two agree to ~1e-6 of the largest
# force (the control, TF32, reads ~2e-3 at this size)
TOL = 1e-5


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def port(cfg, weights, spec=None):
    from torchmdnet_tpu_torch.models.model import create_model

    pot = create_model(dict(cfg, cell_block_spec=spec), device="cpu")
    pot.module.load_state_dict(weights)
    return pot


def test_weights_load_into_the_program(one_thread):
    cell = tiny_cell("aceff.serve_b128")
    weights = ref.make_weights(cell.config["model"], 5, "cpu")
    pot = port(cell.config["model"], weights)
    got = pot.module.state_dict()
    assert got.keys() == weights.keys()
    assert all(torch.equal(got[k], weights[k]) for k in weights)


def test_molecules_all_to_all(one_thread):
    cfg = tiny_cell("aceff.serve_b128").config["model"]
    rng = np.random.default_rng(3)
    z, pos, batch, q = (torch.as_tensor(a) for a in systems.molecule_batch(
        rng, 4, (5, 12), (4.5, 64), (1, 6, 7, 8), None, (-1.0, 0.0, 1.0),
        40.0))
    weights = ref.make_weights(cfg, 11, "cpu")
    y, f = port(cfg, weights).apply(z, pos, batch, num_mols=4, q=q)
    e_r, f_r, _ = ref.energy_forces(weights, cfg, z, pos, batch, q, 4)
    assert rel(y.flatten(), e_r) < TOL and rel(f, f_r) < TOL


def test_every_seed_asks_for_the_same_sizes():
    def sizes(seed):
        _, _, batch, _ = systems.molecule_batch(
            np.random.default_rng(seed), 8, (5, 12), (4.5, 64), (1, 6),
            None, (0.0,), 40.0)
        return np.bincount(batch)

    a, b = sizes(1), sizes(2 ** 40 + 7)
    assert sorted(a) == sorted(b) == [5, 6, 7, 8, 9, 10, 11, 12]
    assert list(a) != list(b)


@pytest.mark.parametrize("blocked", [False, True], ids=["gather", "blocked"])
def test_periodic_reaction_field(one_thread, blocked):
    from torchmdnet_tpu_torch.md.integrators import make_md_step
    from torchmdnet_tpu_torch.ops.cell_blocks import (
        tune_cell_block_spec, tune_stencil_window_spec)

    cell = tiny_cell("aceff_pbc10.md_25k")
    cfg, t = cell.config["model"], cell.traffic
    z, pos, masses, length = systems.jittered_lattice(
        9, t["atoms"], t["density"], t["elements"], t["jitter"])
    weights = ref.make_weights(cfg, 12, "cpu")
    box3 = [length] * 3
    spec = wspec = None
    if blocked:
        spec = tune_cell_block_spec(pos, box3, cfg["cutoff_upper"] + 1.0,
                                    cap=16)
        wspec = tune_stencil_window_spec(pos, box3, spec,
                                         cfg["coulomb_cutoff"] + 1.0)
    init_state, _, _ = make_md_step(
        port(cfg, weights, spec), z, np.zeros(len(z), np.int64), masses,
        dt=0.05, box=np.diag(box3).astype(np.float32), q=torch.zeros(1),
        neighbor_strategy="cell", cell_block_spec=spec,
        coulomb_window_spec=wspec)
    st = init_state(pos)
    e_r, f_r, _ = ref.energy_forces(
        weights, cfg, torch.as_tensor(z), torch.as_tensor(pos),
        torch.zeros(len(z), dtype=torch.long), torch.zeros(1), 1,
        box=torch.full((3,), length))
    assert rel(st.energy.flatten(), e_r) < TOL and rel(st.force, f_r) < TOL


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0])
    # half a TF32 step rounds to the even neighbour, one and a half up
    assert ref._round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2.0 ** -9, -3.0]


def test_param_table_widths():
    table = {name: shape for name, shape, _ in
             ref.param_table(dict(TINY_MODEL, num_layers=2))}
    f = TINY_MODEL["embedding_dimension"]
    assert table["representation_model.layers.1.linears_scalar.0.weight"] \
        == (f, TINY_MODEL["num_rbf"] + 2 * TINY_MODEL["q_dim"])
