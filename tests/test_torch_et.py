"""The port's Equivariant Transformer (``models/torchmd_et.py``) against
the JAX package's on the CPU: energies and forces of a batch of three
molecules (one atom alone) with ghost rows, the same weights, rtol = 1e-4
and atol = 1e-4 of the largest value (``torch_parity.py::close_to_scale``), over ``distance_influence`` (keys, values, both, none),
``vector_cutoff`` on and off and ``neighbor_embedding`` on and off, and
under ``precision=64`` (JAX in x64); a periodic lattice on cell lists;
then, torch only, the rotation of its vector features.  One jitted JAX
init and evaluation per case."""

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from torch_parity import (ET_ARGS, attn_check, attn_system, lattice_system,
                          one_torch_thread)  # noqa: F401
from torchmdnet_tpu_torch.models.model import create_model

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# every value of each option at least once, in four models
CASES = {
    "keys-vector_cutoff": dict(distance_influence="keys"),
    "values-plain_cutoff-no_neighbor_embedding": dict(
        distance_influence="values", vector_cutoff=False,
        neighbor_embedding=False),
    "both-vector_cutoff-no_neighbor_embedding": dict(
        distance_influence="both", neighbor_embedding=False),
    "none-plain_cutoff": dict(distance_influence="none",
                              vector_cutoff=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_energies_and_forces_match_jax(case):
    pot, _ = attn_check(dict(ET_ARGS, **CASES[case]))
    layer = pot.module.representation_model.attention_layers[0]
    influence = CASES[case]["distance_influence"]
    assert (layer.dk_proj is not None) == (influence in ("keys", "both"))
    assert (layer.dv_proj is not None) == (influence in ("values", "both"))


def test_precision_64_matches_jax_x64():
    """``precision=64``: float64 weights and inputs, against JAX's model
    evaluated in x64 on float64 positions."""
    with jax.enable_x64(True):
        pot, forces = attn_check(dict(ET_ARGS, precision=64), seed=1)
    assert forces.dtype == np.float64
    assert all(p.dtype == torch.float64 for p in pot.module.parameters())


def test_periodic_cell_lists_match_jax():
    """64 atoms on a jittered lattice in a 10.4 Å periodic box, the
    model's own cell lists (3 cells a side of 3.47 Å for a 3.4 Å cutoff,
    K = 32): minimum-image geometry through the same weights."""
    z, pos, box = lattice_system(n_side=4, spacing=2.6, seed=2)
    args = dict(ET_ARGS, cutoff_upper=3.4, max_num_neighbors=32,
                neighbor_strategy="cell", cells_per_dim=(3, 3, 3))
    pot, _ = attn_check(args, system=(z, pos, np.zeros(len(z), np.int32),
                                      1), box=box)
    nbr = pot.module.representation_model.build_neighbors(
        torch.from_numpy(pos), torch.zeros(len(z), dtype=torch.long),
        box=torch.from_numpy(box))
    assert not bool(nbr.overflow)
    assert int(nbr.mask.sum(1).max()) > 8  # images inside the cutoff


def test_vector_features_rotate():
    """A rotation of the positions leaves ``x`` and the energy as they
    are and rotates ``vec`` (its spatial axis) and the forces."""
    z, pos, batch, m = attn_system()
    pot = create_model(ET_ARGS, device="cpu", seed=2)
    rep = pot.module.representation_model
    rot = torch.from_numpy(Rotation.random(random_state=5).as_matrix()).float()
    t = dict(z=torch.from_numpy(z).long(), batch=torch.from_numpy(batch).long())
    p = torch.from_numpy(pos)
    x0, v0 = rep(t["z"], p, t["batch"], atom_mask=t["batch"] < m)
    x1, v1 = rep(t["z"], p @ rot.T, t["batch"], atom_mask=t["batch"] < m)
    assert float(v0.abs().max()) > 1e-2  # not vacuous
    torch.testing.assert_close(x1, x0, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v1, torch.einsum("ij,njf->nif", rot, v0),
                               rtol=1e-4, atol=1e-5)
    y0, f0 = pot.apply(z, pos, batch, num_mols=m)
    y1, f1 = pot.apply(z, (p @ rot.T).numpy(), batch, num_mols=m)
    torch.testing.assert_close(y1, y0, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(f1, f0 @ rot.T, rtol=1e-4, atol=1e-5)
