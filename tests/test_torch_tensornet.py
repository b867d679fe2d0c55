"""The port's TensorNet (the dhfr path of ``bench.py::main``) against the
JAX package, given the same weights through ``params_from_jax``: energies
and forces of the plain and the fused edge MLP variants (the JAX kernels
in interpret mode) on a periodic lattice and an open molecule (helpers
``torch_parity.py::tn_*``; the tabulated filters and the fused embedding:
``test_torch_tensornet_tabulated.py``), and what ``create_model`` asks of
the device and of a blocked call.  ``test_torch_tensornet_md.py`` holds
the MD run."""

import pytest
import torch

from torch_parity import (TENSORNET_ARGS, lattice_system, one_torch_thread,
                          tn_check_against_jax, tn_setup)
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.utils.jax_params import params_from_jax

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def setup():
    return tn_setup()


def test_weights_load_strict(setup):
    _, flat, *_ = setup
    sd = params_from_jax(flat)
    fresh = create_model(TENSORNET_ARGS, device="cpu")
    result = fresh.module.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert set(sd) == set(fresh.module.state_dict()) and len(sd) == len(flat)
    assert "representation_model.layers.1.linears_tensor.5.weight" in sd


@pytest.mark.parametrize("system", ["lattice", "open"])
@pytest.mark.parametrize("variant", ["plain", "pallas_edge_mlp"])
def test_energy_and_forces_match_jax(setup, variant, system, monkeypatch):
    tn_check_against_jax(setup, variant, system, monkeypatch)


def test_create_model_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model(TENSORNET_ARGS)
    pot = create_model(dict(TENSORNET_ARGS, tabulated_edge_mlp=16),
                       device="cpu")
    assert all(p.device.type == "cpu" for p in pot.module.parameters())


def test_blocked_forward_raises():
    """``blocked=True`` needs a model built with a cell_block_spec."""
    z, pos, box = lattice_system(n_side=2)
    pot = create_model(TENSORNET_ARGS, device="cpu")
    with pytest.raises(ValueError, match="cell_block_spec"):
        pot.apply(z, pos, None, num_mols=1, box=box, blocked=True)
