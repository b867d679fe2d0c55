"""Shared helpers of the ``test_torch_*`` files: small TensorNet2 + Coulomb
and TensorNet systems, built by the JAX package and carried into the
PyTorch port with the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torchmdnet_tpu.models.model import create_model as jax_create_model
from torchmdnet_tpu_torch.models.model import create_model as port_create_model
from torchmdnet_tpu_torch.utils.jax_params import params_from_jax

RTOL = ATOL = 1e-4  # the upstream parity bar (f32, TF32 off)

SMALL_ARGS = dict(
    model="tensornet2", embedding_dimension=32, num_layers=2, num_rbf=16,
    rbf_type="expnorm", trainable_rbf=False, activation="silu",
    cutoff_lower=0.0, cutoff_upper=4.5, max_z=128, max_num_neighbors=48,
    derivative=True, prior_model=None, reduce_op="sum", precision=32,
    equivariance_invariance_group="O(3)", atom_filter=-1, remat=False,
    pallas_embedding=True, pallas_edge_mlp=True, q_dim=4,
    output_model="ScalarPlusWeightedCoulomb", q_weights=[[1.0] * 4] * 3,
    coulomb_cutoff=5.0)

# TensorNet (the dhfr path of ``bench.py::main``) at a small width; the
# variants switch ``tabulated_edge_mlp``, ``pallas_edge_mlp`` and
# ``pallas_embedding`` on top of it
TENSORNET_ARGS = dict(
    model="tensornet", embedding_dimension=32, num_layers=2, num_rbf=16,
    rbf_type="expnorm", trainable_rbf=False, activation="silu",
    cutoff_lower=0.0, cutoff_upper=4.5, max_z=128, max_num_neighbors=32,
    derivative=True, prior_model=None, output_model="Scalar",
    reduce_op="sum", precision=32, equivariance_invariance_group="O(3)",
    atom_filter=-1, remat=False)


def lattice_system(n_side=4, spacing=2.6, seed=0):
    """``n_side³`` atoms on a jittered cubic lattice in a periodic box
    (mixed H/C/N/O), as numpy arrays: ``(z, pos, box)``."""
    rng = np.random.RandomState(seed)
    g = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3) + 0.5
    L = n_side * spacing
    pos = (g * spacing + rng.uniform(-0.4, 0.4, g.shape)).astype(np.float32)
    z = rng.choice([1, 1, 6, 7, 8], len(pos)).astype(np.int32)
    box = np.diag([L, L, L]).astype(np.float32)
    return z, pos, box


def open_molecule(n_atoms=20, seed=0):
    """A small open (non-periodic) cluster of mixed H/C/N/O atoms at
    molecular spacing, as numpy arrays: ``(z, pos, None)``."""
    rng = np.random.RandomState(seed)
    pos = np.zeros((n_atoms, 3))
    for i in range(1, n_atoms):  # each atom 1.0-1.6 Å from an earlier one
        while True:
            v = rng.randn(3)
            p = pos[rng.randint(i)] + v / np.linalg.norm(v) * rng.uniform(1.0, 1.6)
            if np.min(np.linalg.norm(pos[:i] - p, axis=1)) > 0.9:
                break
        pos[i] = p
    z = rng.choice([1, 1, 6, 7, 8], n_atoms).astype(np.int32)
    return z, pos.astype(np.float32), None


def flatten_params(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(flatten_params(value, name))
        else:
            out[name] = np.asarray(value)
    return out


def jax_and_port(args, z, pos, box, seed=0):
    """The JAX potential with its variables and the port's potential
    (on the CPU) holding the same weights."""
    jpot = jax_create_model(args)
    init = jax.jit(lambda key, z_, p_, b_: jpot.init(
        key, z_, p_, jnp.zeros((z_.shape[0],), jnp.int32), num_mols=1,
        box=b_))
    variables = init(jax.random.PRNGKey(seed), jnp.asarray(z),
                     jnp.asarray(pos), _maybe(box))
    flat = flatten_params(variables["params"])
    tpot = port_create_model(args, device="cpu")
    tpot.module.load_state_dict(params_from_jax(flat), strict=True)
    return jpot, variables, tpot, flat


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_apply(jpot, variables, z, pos, box):
    """Jitted ``(energy, forces)`` of the JAX potential, as numpy arrays."""
    fn = jax.jit(lambda v, z_, p_, b_: jpot.apply(
        v, z_, p_, jnp.zeros((z_.shape[0],), jnp.int32), num_mols=1, box=b_))
    y, f = fn(variables, jnp.asarray(z), jnp.asarray(pos), _maybe(box))
    return np.asarray(y), np.asarray(f)


def _maybe(box):
    return None if box is None else jnp.asarray(box)
