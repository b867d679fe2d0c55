"""The port's TorchMD-T (``models/torchmd_t.py``) against the JAX
package's on the CPU: energies and forces of ``torch_parity.py::
attn_system`` with the same weights (rtol = 1e-4, atol = 1e-4 of the
largest value) over ``distance_influence`` with ``neighbor_embedding`` on
and off, and under ``precision=64`` (JAX in x64)."""

import jax
import numpy as np
import pytest
import torch

from torch_parity import T_ARGS, attn_check, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("influence,neighbor_embedding", [
    ("keys", True), ("values", False), ("both", False), ("none", True)])
def test_energies_and_forces_match_jax(influence, neighbor_embedding):
    pot, _ = attn_check(dict(T_ARGS, distance_influence=influence,
                             neighbor_embedding=neighbor_embedding))
    rep = pot.module.representation_model
    assert (rep.neighbor_embedding is not None) == neighbor_embedding
    _, vec = rep(torch.ones(2, dtype=torch.long),
                 torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]),
                 torch.zeros(2, dtype=torch.long))
    assert vec is None  # an invariant model


def test_precision_64_matches_jax_x64():
    with jax.enable_x64(True):
        _, forces = attn_check(dict(T_ARGS, precision=64), seed=1)
    assert forces.dtype == np.float64
