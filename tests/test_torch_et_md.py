"""MD of the attention models and the graph network on the CPU: the
port's ``make_md_step`` against the JAX package's.

Ten NVE steps (no thermostat, so no random numbers to match) of the
Equivariant Transformer across neighbour rebuilds, the same weights: the
positions, velocities and forces at rtol = 1e-4 and atol = 1e-4 of the
largest value.  Then TorchMD-GN under the MD step's list: both packages'
``make_md_step`` build it with self loops (``loop=True``, JAX
``md/integrators.py:134-140``) for every model, and GN's ``CFConv`` does
not drop a self pair, so its MD energy and forces carry a self term that
its own evaluation (``loop=False``) lacks.  The port mirrors JAX there:
its MD energy equals JAX's MD energy, and both differ from the model's own
evaluation (ROADMAP Queue 3 item 6 records the numbers)."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import (ET_ARGS, GN_ARGS, attn_jax, close_to_scale,
                          one_torch_thread,  # noqa: F401
                          open_molecule)
from torchmdnet_tpu.md.integrators import make_md_step as jax_make_md_step
from torchmdnet_tpu.models.model import create_model as jax_create_model
from torchmdnet_tpu_torch.md.integrators import make_md_step
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.utils.jax_params import params_from_jax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_ATOMS = 14  # within K = 16 at the list's 4.5 + 1 Å, self included
KW = dict(dt=0.5, num_mols=1, rebuild_every=5, skin=1.0, temperature=None,
          neighbor_strategy="brute")


def _both(args, seed):
    """One molecule, and the JAX and port MD steps of ``args`` with the
    same weights: ``((z, pos, batch), (init, chunk, energy) of JAX, the
    same of the port, the port's potential)``."""
    z, pos, _ = open_molecule(N_ATOMS, seed=seed)
    batch = np.zeros(N_ATOMS, np.int32)
    masses = np.where(z == 1, 1.008, 12.011)
    flat, _, _ = attn_jax(args, (z, pos, batch, 1))
    jpot = jax_create_model(args)
    variables = {"params": _unflatten(flat)}
    pot = create_model(args, device="cpu")
    pot.module.load_state_dict(params_from_jax(flat), strict=True)
    jax_md = jax_make_md_step(jpot, variables, jnp.asarray(z),
                              jnp.asarray(batch), masses, **KW)
    return (z, pos, batch), jax_md, make_md_step(pot, z, batch, masses,
                                                 **KW), pot


def _unflatten(flat):
    tree = {}
    for name, value in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


def test_et_nve_steps_match_jax():
    (_, pos, _), (j_init, j_chunk, _), (t_init, t_chunk, _), _ = _both(
        ET_ARGS, 5)
    js, ts = j_init(pos), t_init(pos)
    close_to_scale(ts.force.numpy(), np.asarray(js.force))
    for _ in range(2):  # 2 chunks = 10 steps, a rebuild before each
        js, ts = j_chunk(js), t_chunk(ts)
    assert ts.step == int(js.step) == 10
    assert not bool(ts.overflow) and not bool(js.overflow)
    for name in ("pos", "vel", "force"):
        close_to_scale(getattr(ts, name).numpy(),
                       np.asarray(getattr(js, name)))
    assert np.abs(ts.pos.numpy() - pos).max() > 1e-3  # the atoms moved


def test_gn_md_list_has_self_loops_as_in_jax():
    (z, pos, batch), (j_init, _, j_energy), (t_init, _, _), pot = _both(
        dict(GN_ARGS, aggr="add"), 6)
    js, ts = j_init(pos), t_init(pos)
    e_j = j_energy(js.pos, js.nbr_idx, js.nbr_mask, js.nbr_rev)
    close_to_scale(ts.energy.numpy(), np.asarray(e_j))
    close_to_scale(ts.force.numpy(), np.asarray(js.force))
    y, f = pot.apply(z, pos, batch, num_mols=1)
    # the self term: the MD energy and forces are not the model's own
    print("GN energy: MD list", float(ts.energy.sum()), "own list",
          float(y.sum()), "max |ΔF|", float((ts.force - f).abs().max()),
          "max |F|", float(f.abs().max()))
    assert abs(float(ts.energy.sum()) - float(y.sum())) > 1e-2
    assert float((ts.force - f).abs().max()) > 1e-3
