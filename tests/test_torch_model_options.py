"""What the port's ``create_model`` builds and refuses without running a
model: the JAX-to-torch key mapping of ``params_from_jax``, the
TensorNet2 options the port does not cover, the configurations it
refuses as invalid, the heads that drop the priors, and TensorNet with a
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
    ("remat", True), ("model", "equivariant-transformer"),
    ("precision", 16)])
def test_uncovered_options_raise(key, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model(dict(SMALL_ARGS, **{key: value}), device="cpu")


@pytest.mark.parametrize("args,match", [
    # JAX's own error (models/model.py:322-323)
    (dict(SMALL_ARGS, atom_filter=3), "atom filter"),
    # JAX builds these and fails at the first evaluation: TensorNet and
    # TensorNet2 produce no vector features, TensorNet no charges
    (dict(SMALL_ARGS, output_model="EquivariantScalar"), "equivariant"),
    (dict(SMALL_ARGS, output_model="EquivariantDipoleMoment"),
     "equivariant"),
    (dict(TENSORNET_ARGS, output_model="EquivariantVectorOutput"),
     "equivariant"),
    (dict(TENSORNET_ARGS, output_model="ScalarPlusWeightedCoulomb"),
     "charges"),
    (dict(SMALL_ARGS, output_model="Dipole"), "Unknown output model"),
    (dict(SMALL_ARGS, rbf_type="bessel"), "Unknown RBF type")])
def test_options_refused_with_value_error(args, match):
    with pytest.raises(ValueError, match=match):
        create_model(args, device="cpu")


@pytest.mark.parametrize("model_args", [SMALL_ARGS, TENSORNET_ARGS])
@pytest.mark.parametrize("head", ["DipoleMoment", "ElectronicSpatialExtent",
                                  "EquivariantElectronicSpatialExtent"])
def test_heads_without_priors_drop_them(model_args, head):
    """A head with ``allow_prior_model = False`` drops the priors, as JAX's
    ``create_model`` does (``models/model.py:365-366``); the Scalar head
    keeps them."""
    priors = dict(prior_model=["ZBL", "Atomref"],
                  prior_args=[{"atomic_number": list(range(10))},
                              {"max_z": 10}])
    args = dict(model_args, derivative=False, output_model=head, **priors)
    pot = create_model(args, device="cpu")
    assert len(pot.module.prior_model) == 0
    assert type(pot.module.output_model).__name__ == head
    kept = create_model(dict(args, output_model="Scalar"), device="cpu")
    assert len(kept.module.prior_model) == 2


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
