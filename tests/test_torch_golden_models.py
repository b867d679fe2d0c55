"""The port's TorchMD-ET, TorchMD-T and TorchMD-GN against the JAX
package's stored outputs, ``tests/golden_outputs.npz``: the weights of
``tests/test_golden.py::_compute`` (JAX's init at its seed) carried into
the port, its batch of two molecules, energies and forces at rtol = atol
= 1e-4 (the file holds float32 values of size ~1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_golden import GOLDEN, _args, _example_batch
from torch_parity import ATOL, RTOL, flatten_params, one_torch_thread  # noqa: F401
from torchmdnet_tpu.models.model import create_model as jax_create_model
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.utils.jax_params import params_from_jax

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("model", ["equivariant-transformer", "transformer",
                                   "graph-network"])
def test_golden_outputs(model):
    data = np.load(GOLDEN)
    z, pos, batch = _example_batch()
    jpot = jax_create_model(_args(model))
    variables = jax.jit(lambda key: jpot.init(
        key, jnp.asarray(z), jnp.asarray(pos), jnp.asarray(batch),
        num_mols=2))(jax.random.PRNGKey(1234))
    pot = create_model(_args(model), device="cpu")
    pot.module.load_state_dict(
        params_from_jax(flatten_params(variables["params"])), strict=True)
    y, f = pot.apply(z, pos, batch, num_mols=2)
    np.testing.assert_allclose(y.numpy(), data[f"{model}_y"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(f.numpy(), data[f"{model}_f"], rtol=RTOL,
                               atol=ATOL)
