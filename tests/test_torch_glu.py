"""The port's ``GLU`` and ``SwiGLU`` (``models/common.py``) against the
JAX package's modules of the same names on the CPU: the same weights
(submodules ``W``/``V``, and ``glu`` around them), outputs at rtol =
atol = 1e-4.  Nothing in either package calls them; they are the last
pieces of JAX ``models/common.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import ATOL, RTOL, flatten_params, one_torch_thread  # noqa: F401
from torchmdnet_tpu.models import common as jax_common
from torchmdnet_tpu_torch.models.common import GLU, SwiGLU, reset_parameters
from torchmdnet_tpu_torch.utils.jax_params import params_from_jax

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("name", ["GLU", "SwiGLU"])
def test_matches_jax(name):
    x = np.random.RandomState(0).randn(5, 7, 12).astype(np.float32)
    if name == "GLU":
        jmod, mod = jax_common.GLU(16), GLU(12, 16)
    else:
        jmod, mod = jax_common.SwiGLU(16, beta=1.7), SwiGLU(12, 16, beta=1.7)
    variables = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    sd = params_from_jax(flatten_params(variables["params"]))
    assert sorted(sd) == sorted(mod.state_dict())
    mod.load_state_dict(sd, strict=True)
    got = mod(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (5, 7, 16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the torch-default initialisation: U(±1/√fan_in) for both linears
    reset_parameters(mod, torch.Generator().manual_seed(0))
    for lin in (mod.W, mod.V) if name == "GLU" else (mod.glu.W, mod.glu.V):
        assert float(lin.weight.detach().abs().max()) <= 1 / np.sqrt(12)
        assert float(lin.bias.detach().abs().max()) > 0
