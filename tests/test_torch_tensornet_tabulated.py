"""The port's TensorNet against the JAX package, given the same weights
through ``params_from_jax``: energies and forces with the tabulated
Chebyshev filters and with the fused radial embedding (the JAX kernels in
interpret mode) on a periodic lattice and an open molecule (helpers
``torch_parity.py::tn_*``; the plain and fused edge MLP variants:
``test_torch_tensornet.py``), and the options the port does not cover."""

import pytest

from torch_parity import (TENSORNET_ARGS, one_torch_thread,
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model(dict(TENSORNET_ARGS, **{key: value}), device="cpu")
