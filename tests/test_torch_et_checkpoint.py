"""Checkpoints of the Equivariant Transformer and of TorchMD-GN, both
ways between the port and the JAX package, on the CPU.

A JAX-written file (``save_torch_checkpoint``) read by the port's
``load_model`` gives JAX's energies and forces for the same weights; a
port-written file (``save_checkpoint``) read by JAX's ``load_model`` gives
the port's.  ET carries an Atomref prior and a mean and std (the ET-QM9
recipe's prior); GN (``aggr="max"``) carries its filter network under
upstream's ``interactions.<i>.mlp.<j>``, which JAX keeps under
``conv/net_<j>``: both packages' files hold the ``mlp`` keys alone, and
upstream's second copy, ``conv.net.<j>``, loads as the same weights.
Tolerance: rtol = 1e-4, atol = 1e-4 of the largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (ET_ARGS, GN_ARGS, attn_system,
                          close_to_scale, one_torch_thread)  # noqa: F401
from torchmdnet_tpu.models.model import create_model as jax_create_model
from torchmdnet_tpu.models.model import load_model as jax_load_model
from torchmdnet_tpu.utils.torch_ckpt import save_torch_checkpoint
from torchmdnet_tpu_torch.models.model import create_model, load_model
from torchmdnet_tpu_torch.utils.checkpoint import save_checkpoint

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MEAN, STD = 0.5, 2.0
TABLE = np.linspace(-3.0, 3.0, 100).astype(np.float32)
CONFIGS = {
    "equivariant-transformer": dict(
        ET_ARGS, prior_model="Atomref",
        prior_args=[dict(max_z=100, initial_atomref=TABLE.tolist())]),
    "graph-network": dict(GN_ARGS, aggr="max"),
}


def _port_eval(pot):
    z, pos, batch, m = attn_system()
    y, f = pot.apply(z, pos, batch, num_mols=m)
    return y.numpy(), f.numpy()


def _jax_eval(jpot, variables):
    z, pos, batch, m = (jnp.asarray(a) if isinstance(a, np.ndarray) else a
                        for a in attn_system())
    y, f = jax.jit(lambda v: jpot.apply(v, z, pos, batch, num_mols=m))(
        variables)
    return np.asarray(y), np.asarray(f)


@pytest.mark.parametrize("model", list(CONFIGS))
def test_jax_checkpoint_serves_in_the_port(model, tmp_path):
    args = CONFIGS[model]
    system = attn_system()
    z, pos, batch, m = (jnp.asarray(a) if isinstance(a, np.ndarray) else a
                        for a in system)
    jpot = jax_create_model(args, mean=MEAN, std=STD)
    variables = jax.jit(lambda key: jpot.init(key, z, pos, batch,
                                              num_mols=m))(
        jax.random.PRNGKey(4))
    path = str(tmp_path / "jax.ckpt")
    save_torch_checkpoint(path, jpot, variables, hparams=args)
    keys = torch.load(path, weights_only=False)["state_dict"]
    if model == "graph-network":
        assert "model.representation_model.interactions.1.mlp.2.weight" in keys
        assert not any(".conv.net." in k for k in keys)
    pot = load_model(path, device="cpu")
    assert (pot.module.mean, pot.module.std) == pytest.approx((MEAN, STD))
    y_j, f_j = _jax_eval(jpot, variables)
    y_t, f_t = _port_eval(pot)
    close_to_scale(y_t, y_j)
    close_to_scale(f_t, f_j)
    if model == "graph-network":
        # upstream's files hold the filter network twice, as conv.net too
        ckpt = torch.load(path, weights_only=False)
        sd = ckpt["state_dict"]
        for k in [k for k in sd if ".mlp." in k]:
            sd[k.replace(".mlp.", ".conv.net.")] = sd[k].clone()
        torch.save(ckpt, tmp_path / "upstream.ckpt")
        y_u, f_u = _port_eval(load_model(str(tmp_path / "upstream.ckpt"),
                                         device="cpu"))
        np.testing.assert_array_equal(y_u, y_t)
        np.testing.assert_array_equal(f_u, f_t)


@pytest.mark.parametrize("model", list(CONFIGS))
def test_port_checkpoint_serves_in_jax(model, tmp_path):
    args = CONFIGS[model]
    pot = create_model(args, mean=MEAN, std=STD, device="cpu", seed=5)
    path = save_checkpoint(str(tmp_path / "port.ckpt"), pot)
    keys = torch.load(path, weights_only=False)["state_dict"]
    assert not any(".conv.net." in k for k in keys)
    jpot, variables = jax_load_model(path)
    assert (jpot.module.mean, jpot.module.std) == pytest.approx((MEAN, STD))
    y_j, f_j = _jax_eval(jpot, variables)
    y_t, f_t = _port_eval(pot)
    close_to_scale(y_t, y_j)
    close_to_scale(f_t, f_j)
    assert np.abs(f_t).max() > 1e-3
