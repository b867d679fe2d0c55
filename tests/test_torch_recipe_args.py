"""``chip_smoke.py``'s copies of the recipes it runs on the card (the
card's machine has no ``yaml``) against the files in ``examples/``,
parsed with ``yaml``: every key of each file, those the model, the head,
the priors and the train step read among them, with its value.  And the
port's ``create_model`` builds each ET recipe at full width as it stands
(no ``equivariance_invariance_group``, which JAX reads for TensorNet
alone), with JAX's head name and the priors the recipe names.  Torch
only, no JAX."""

import importlib.util
from pathlib import Path

import pytest
import torch
import yaml

from torch_parity import one_torch_thread  # noqa: F401
from torchmdnet_tpu_torch.models.model import create_model

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
COPIES = {"TensorNet2-AceFF": "ACEFF_ARGS", "ET-SPICE": "ET_SPICE_ARGS",
          "ET-QM9": "ET_QM9_ARGS", "ET-MD17": "ET_MD17_ARGS"}
# what create_model, the heads, the priors and make_train_step read
READ = ("model", "embedding_dimension", "num_layers", "num_rbf", "rbf_type",
        "trainable_rbf", "activation", "cutoff_lower", "cutoff_upper",
        "max_num_neighbors", "max_z", "attn_activation", "num_heads",
        "distance_influence", "neighbor_embedding", "vector_cutoff",
        "equivariance_invariance_group", "q_dim", "q_weights",
        "coulomb_cutoff", "output_model", "reduce_op", "derivative",
        "precision", "atom_filter", "prior_model", "standardize", "charge",
        "lr", "y_weight", "neg_dy_weight", "ema_alpha_y", "ema_alpha_neg_dy",
        "weight_decay", "lr_warmup_steps", "batch_size",
        "inference_batch_size")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("recipe", list(COPIES))
def test_copy_matches_the_yaml(recipe):
    with open(ROOT / "examples" / f"{recipe}.yaml") as fh:
        want = yaml.safe_load(fh)
    got = getattr(_chip_smoke(), COPIES[recipe])
    assert sum(k in want for k in READ) >= 25
    for key in READ:
        assert (key in got) == (key in want), key
        if key in want:
            assert got[key] == want[key], key
    assert got == want


@pytest.mark.parametrize("recipe", ["ET-SPICE", "ET-QM9", "ET-MD17", "ET-ANI1"])
def test_et_recipe_builds_at_full_width(recipe):
    with open(ROOT / "examples" / f"{recipe}.yaml") as fh:
        args = yaml.safe_load(fh)
    assert "equivariance_invariance_group" not in args
    if args.get("prior_model") == "Atomref":
        args["prior_args"] = [{"max_z": args["max_z"]}]
    pot = create_model(args, device="cpu")
    rep = pot.module.representation_model
    assert type(rep).__name__ == "TorchMD_ET"
    assert len(rep.attention_layers) == args["num_layers"]
    assert rep.attention_layers[0].q_proj.in_features == \
        args["embedding_dimension"]
    assert rep.attention_layers[0].vector_cutoff == args["vector_cutoff"]
    assert rep.max_num_neighbors == args["max_num_neighbors"]
    assert type(pot.module.output_model).__name__ == "EquivariantScalar"
    assert len(pot.module.prior_model) == (args.get("prior_model") is not None)
    assert pot.derivative == args["derivative"]
    assert all(p.dtype == torch.float32 for p in pot.module.parameters())
