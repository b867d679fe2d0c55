"""The port's TorchMD-GN (``models/torchmd_gn.py``) against the JAX
package's on the CPU: energies and forces of ``torch_parity.py::
attn_system`` (its third molecule is one atom with no neighbour) with the
same weights (rtol = 1e-4, atol = 1e-4 of the largest value) for each
``aggr`` (the mean's count + 1 denominator, the max's 0 on an empty row),
with ``neighbor_embedding`` on and off, and under ``precision=64`` (JAX in
x64)."""

import jax
import numpy as np
import pytest
import torch

from torch_parity import (GN_ARGS, attn_check, attn_system,
                          one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("aggr,neighbor_embedding", [
    ("add", True), ("mean", False), ("max", True)])
def test_energies_and_forces_match_jax(aggr, neighbor_embedding):
    pot, forces = attn_check(dict(GN_ARGS, aggr=aggr,
                                  neighbor_embedding=neighbor_embedding))
    rep = pot.module.representation_model
    assert rep.interactions[0].conv.aggr == aggr
    # the lone atom feels no force, and its list row is empty
    z, pos, batch, m = attn_system()
    lone = int(np.flatnonzero(batch == 2)[0])
    assert not forces[lone].any()
    nbr = rep.build_neighbors(torch.from_numpy(pos), torch.from_numpy(batch),
                              atom_mask=torch.from_numpy(batch < m))
    assert not bool(nbr.mask[lone].any())  # no self loop either


def test_precision_64_matches_jax_x64():
    with jax.enable_x64(True):
        _, forces = attn_check(dict(GN_ARGS, precision=64, aggr="max"),
                               seed=1)
    assert forces.dtype == np.float64
