"""The port's matmul precision follows the JAX package's contract
(``ops/config.py`` of both): ``create_model`` sets it only when
``args["matmul_precision"]`` is given, and each name maps onto PyTorch's
TF32 switches — ``"highest"`` and ``"high"`` keep float32 matmuls in full
float32 (JAX's ``"high"`` is bf16_3x, ~1e-6 relative; TF32 would be
~5e-4), ``"default"`` allows TF32."""

import pytest
import torch

from torch_parity import TENSORNET_ARGS, one_torch_thread  # noqa: F401
from torchmdnet_tpu.models.model import create_model as jax_create_model
from torchmdnet_tpu.ops import config as jax_config
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.ops import config

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ("highest", "high", "default")


@pytest.fixture(autouse=True)
def restore_highest():
    yield
    config.set_matmul_precision("highest")
    jax_config.set_matmul_precision("highest")


def _tf32():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("name", NAMES)
def test_create_model_sets_the_given_precision(name):
    args = dict(TENSORNET_ARGS, matmul_precision=name)
    jax_create_model(args)
    create_model(args, device="cpu")
    assert jax_config.get_matmul_precision_name() == name
    assert _tf32() == ((name == "default"),) * 2


@pytest.mark.parametrize("name", NAMES)
def test_create_model_without_the_key_keeps_the_setting(name):
    jax_config.set_matmul_precision(name)
    config.set_matmul_precision(name)
    for key in (None, ""):  # absent, or empty as a CLI leaves it
        args = dict(TENSORNET_ARGS)
        if key is not None:
            args["matmul_precision"] = key
        jax_create_model(args)
        create_model(args, device="cpu")
        assert jax_config.get_matmul_precision_name() == name
        assert _tf32() == ((name == "default"),) * 2


def test_unknown_precision_raises():
    with pytest.raises(ValueError, match="matmul_precision"):
        create_model(dict(TENSORNET_ARGS, matmul_precision="tf32"),
                     device="cpu")
