"""The four ``Equivariant*`` heads on the port's Equivariant Transformer
against the JAX package's on the CPU.  ``create_model`` names them as
JAX does (``models/model.py:329-331``): ``output_model`` "Scalar",
"DipoleMoment", "ElectronicSpatialExtent" and "VectorOutput" on
``model="equivariant-transformer"`` build the heads of those names with
the "Equivariant" prefix.  Energies (the vector head's [num_mols, 3]
output) and forces (−∂Σy/∂pos) of ``torch_parity.py::attn_system``, the
same weights, rtol = 1e-4 and atol = 1e-4 of the largest value."""

import pytest

from torch_parity import ET_ARGS, attn_check, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("output_model", [
    "Scalar", "DipoleMoment", "ElectronicSpatialExtent", "VectorOutput"])
def test_equivariant_head_matches_jax(output_model):
    pot, _ = attn_check(dict(ET_ARGS, output_model=output_model))
    head = pot.module.output_model
    assert type(head).__name__ == "Equivariant" + output_model
