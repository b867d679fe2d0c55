"""What the port's ``create_model`` builds and refuses without running a
model: the JAX-to-torch key mapping of ``params_from_jax``, the
TensorNet2 options the port does not cover, and TensorNet with a
cell_block_spec (the parity runs: ``test_torch_tensornet2.py``,
``test_torch_tensornet.py``, ``test_torch_blocked_tensornet.py``)."""

import pytest

from torch_parity import SMALL_ARGS, TENSORNET_ARGS, one_torch_thread
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.ops.cell_blocks import make_cell_block_spec
from torchmdnet_tpu_torch.utils.jax_params import flax_path_to_torch_key

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_key_mapping():
    assert flax_path_to_torch_key(
        ("representation_model", "layers_1", "linears_scalar_2", "kernel")
    ) == "representation_model.layers.1.linears_scalar.2.weight"
    assert flax_path_to_torch_key(
        ("representation_model", "charge_predict_0", "q_norm", "scale")
    ) == "representation_model.charge_predict_0.q_norm.weight"
    assert flax_path_to_torch_key(
        ("representation_model", "tensor_embedding", "emb", "embedding")
    ) == "representation_model.tensor_embedding.emb.weight"


@pytest.mark.parametrize("key,value", [
    ("atom_filter", 3), ("remat", True),
    ("model", "equivariant-transformer"), ("output_model", "DipoleMoment"),
    ("precision", 16)])
def test_uncovered_options_raise(key, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model(dict(SMALL_ARGS, **{key: value}), device="cpu")


@pytest.mark.parametrize("grouped", [False, True])
def test_cell_block_spec_builds(grouped):
    """TensorNet takes a cell_block_spec, grouped or not (the blocked tiers
    of ``bench.py::main``); ``test_torch_blocked_tensornet.py`` runs it."""
    spec = make_cell_block_spec([20.0] * 3, 5.5, 64)
    if grouped:
        spec = spec._replace(col_slots=(16,) * 9)
    pot = create_model(dict(TENSORNET_ARGS, cell_block_spec=spec),
                       device="cpu")
    assert pot.module.representation_model.cell_block_spec == spec
