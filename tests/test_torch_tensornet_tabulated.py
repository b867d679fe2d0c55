"""The port's TensorNet against the JAX package, given the same weights
through ``params_from_jax``: energies and forces with the tabulated
Chebyshev filters and with the fused radial embedding (the JAX kernels in
interpret mode) on a periodic lattice and an open molecule (helpers
``torch_parity.py::tn_*``; the plain and fused edge MLP variants:
``test_torch_tensornet.py``), and the options that were not covered
before (``precision=16``, ``remat``)."""

import pytest
import torch

from torch_parity import (TENSORNET_ARGS, one_torch_thread, open_molecule,
                          tn_check_against_jax, tn_setup)
from torchmdnet_tpu_torch.models.model import create_model

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def setup():
    return tn_setup()


@pytest.mark.parametrize("system", ["lattice", "open"])
@pytest.mark.parametrize("variant", ["tabulated", "pallas_embedding"])
def test_energy_and_forces_match_jax(setup, variant, system, monkeypatch):
    tn_check_against_jax(setup, variant, system, monkeypatch)


@pytest.mark.parametrize("key,value", [("precision", 16), ("remat", True)])
def test_uncovered_options_raise(key, value):
    """``precision=16`` and ``remat``, which raised ``NotImplementedError``
    until they were ported (ROADMAP Queue 1 [17]), now build TensorNet:
    bfloat16 layers on float32 weights, or layers that recompute their
    edge pipeline in the backward; the tabulated model evaluates to
    finite energies and forces."""
    pot = create_model(dict(TENSORNET_ARGS, tabulated_edge_mlp=16,
                            **{key: value}), device="cpu")
    rep = pot.module.representation_model
    if key == "remat":
        assert rep.tensor_embedding.remat and rep.layers[0].remat
    else:
        assert rep.layers[0].linears_tensor[0].compute_dtype == torch.bfloat16
        assert rep.layers[0].linears_tensor[0].weight.dtype == torch.float32
    z, pos, _ = open_molecule(12, seed=2)
    y, f = pot.apply(z, pos, num_mols=1)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(f).all())
