"""The priors' config forms, without a model run and without a JAX
compile: ``create_prior_models`` in its string, list and dict forms and
with a dataset against the JAX package's, and the key of a
LearnableAtomref's table (the parity runs: ``test_torch_priors.py``)."""

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    PRIOR_ARGS, TENSORNET_ARGS, one_torch_thread)
from torchmdnet_tpu.models.model import (
    create_prior_models as jax_create_prior_models)
from torchmdnet_tpu_torch.models.model import (
    create_model, create_prior_models)
from torchmdnet_tpu_torch.utils.jax_params import flax_path_to_torch_key
from utils_dummy import DummyDataset

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("form", ["string", "list", "dict"])
def test_create_prior_models_forms(form):
    """The three config forms give the JAX package's priors, in order and
    with the same arguments."""
    args = {
        "string": dict(prior_model="ZBL", prior_args=PRIOR_ARGS["ZBL"]),
        "list": dict(prior_model=["ZBL", "D2"],
                     prior_args=[PRIOR_ARGS["ZBL"], PRIOR_ARGS["D2"]]),
        "dict": dict(prior_model=[{"D2": PRIOR_ARGS["D2"]},
                                  {"Atomref": {"max_z": 7}}, "Coulomb"]),
    }[form]
    want = jax_create_prior_models(args)
    got = create_prior_models(args)
    assert [type(p).__name__ for p in got] == [type(p).__name__ for p in want]
    for g, w in zip(got, want):
        assert g.get_init_args() == w.get_init_args()
    assert create_prior_models({"prior_model": None}) == ()
    with pytest.raises(ValueError, match="Unknown prior model"):
        create_prior_models({"prior_model": "Nope"})


def test_create_prior_models_from_a_dataset():
    """A dataset supplies the element map, the unit scales and the atomref
    table that the arguments leave out."""
    ds = DummyDataset(num_samples=4)
    args = dict(prior_model=["ZBL", "D2", "Coulomb", "Atomref"])
    want = jax_create_prior_models(args, dataset=ds)
    got = create_prior_models(args, dataset=ds)
    for g, w in zip(got, want):
        assert g.get_init_args() == w.get_init_args()
    np.testing.assert_array_equal(got[3].table.numpy(), ds.get_atomref())


def test_learnable_atomref_key():
    """The JAX leaf of a LearnableAtomref maps onto upstream's key."""
    assert flax_path_to_torch_key(("prior_models_2", "atomref")) == (
        "prior_model.2.atomref.weight")
    pot = create_model(dict(TENSORNET_ARGS, prior_model=[
        "ZBL", {"LearnableAtomref": {"max_z": 9}}],
        prior_args=[PRIOR_ARGS["ZBL"], {"max_z": 9}]), device="cpu")
    keys = [k for k in pot.module.state_dict() if k.startswith("prior")]
    assert keys == ["prior_model.1.atomref.weight"]
    assert pot.module.prior_model[1].atomref.weight.shape == (9, 1)
