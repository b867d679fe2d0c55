"""The port's TensorNet (the dhfr path of ``bench.py::main``) against the
JAX package, given the same weights through ``params_from_jax``: energies
and forces in four variants (plain, the fused edge MLP, the tabulated
filters, the fused embedding; the JAX kernels in interpret mode) on a
periodic lattice and an open molecule, and the options the port does not
cover.  ``test_torch_tensornet_md.py`` holds the MD run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (ATOL, RTOL, TENSORNET_ARGS, flatten_params,
                          lattice_system, open_molecule, to_np)
from torchmdnet_tpu.models.model import create_model as jax_create_model
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.ops import cheb_filter, edge_mlp, radial_embedding
from torchmdnet_tpu_torch.ops.cell_blocks import make_cell_block_spec
from torchmdnet_tpu_torch.utils.jax_params import params_from_jax

# variant → (args, the port op it must run through: module, attribute)
VARIANTS = {
    "plain": ({}, None),
    "pallas_edge_mlp": (dict(pallas_edge_mlp=True),
                        (edge_mlp, "edge_mlp_ref")),
    "tabulated": (dict(tabulated_edge_mlp=128),
                  (cheb_filter, "filter_fwd")),
    "pallas_embedding": (dict(pallas_embedding=True),
                         (radial_embedding, "radial_embedding_ref")),
}
N_ROWS = 64  # the lattice's atoms; the open molecule is padded to them
OPEN_BOX = 100.0


@pytest.fixture(scope="module")
def setup():
    """The JAX weights, and both systems as the JAX reference sees them:
    the open molecule padded with ghost rows (segment 1) to the lattice's
    rows, in a box so large that no periodic image comes within the
    cutoff, so that one compiled JAX function per variant serves both."""
    z, pos, box = lattice_system()
    zo, po, _ = open_molecule()
    n_open = len(zo)
    zp = np.concatenate([zo, np.ones(N_ROWS - n_open, np.int32)])
    ghost = 50.0 + np.random.RandomState(9).uniform(0, 30, (N_ROWS - n_open, 3))
    pp = np.concatenate([po, ghost]).astype(np.float32)
    segp = (np.arange(N_ROWS) >= n_open).astype(np.int32)
    systems = {
        "lattice": ((z, pos, np.zeros(N_ROWS, np.int32), box), (z, pos, box)),
        "open": ((zp, pp, segp, np.eye(3, dtype=np.float32) * OPEN_BOX),
                 (zo, po, None)),
    }
    jpot = jax_create_model(TENSORNET_ARGS)
    variables = jax.jit(lambda key, z_, p_, s_, b_: jpot.init(
        key, z_, p_, s_, num_mols=1, box=b_))(
        jax.random.PRNGKey(0), *map(jnp.asarray, systems["lattice"][0]))
    return variables, flatten_params(variables["params"]), systems, {}


def _jax_reference(setup, variant, system):
    variables, _, systems, fns = setup
    if variant not in fns:
        jpot = jax_create_model(dict(TENSORNET_ARGS, **VARIANTS[variant][0]))
        fns[variant] = jax.jit(lambda v, z_, p_, s_, b_: jpot.apply(
            v, z_, p_, s_, num_mols=1, box=b_))
    y, f = fns[variant](variables, *map(jnp.asarray, systems[system][0]))
    return np.asarray(y), np.asarray(f)


def _port(flat, **extra):
    pot = create_model(dict(TENSORNET_ARGS, **extra), device="cpu")
    pot.module.load_state_dict(params_from_jax(flat), strict=True)
    return pot


def test_weights_load_strict(setup):
    _, flat, *_ = setup
    sd = params_from_jax(flat)
    fresh = create_model(TENSORNET_ARGS, device="cpu")
    result = fresh.module.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert set(sd) == set(fresh.module.state_dict()) and len(sd) == len(flat)
    assert "representation_model.layers.1.linears_tensor.5.weight" in sd


@pytest.mark.parametrize("system", ["lattice", "open"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_energy_and_forces_match_jax(setup, variant, system, monkeypatch):
    _, flat, systems, _ = setup
    extra, spy = VARIANTS[variant]
    calls = []
    if spy is not None:  # the variant goes through its op
        fn = getattr(*spy)
        monkeypatch.setattr(*spy, lambda *a: calls.append(1) or fn(*a))
    y_j, f_j = _jax_reference(setup, variant, system)
    z, pos, box = systems[system][1]
    y_t, f_t = _port(flat, **extra).apply(z, pos, None, num_mols=1, box=box)
    assert y_t.shape == (1, 1) and f_t.shape == pos.shape
    assert bool(calls) == (spy is not None)
    np.testing.assert_allclose(to_np(y_t), y_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_np(f_t), f_j[:len(z)], rtol=RTOL,
                               atol=ATOL)
    assert not f_j[len(z):].any()  # the JAX ghost rows feel no force


def test_create_model_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model(TENSORNET_ARGS)
    pot = create_model(dict(TENSORNET_ARGS, tabulated_edge_mlp=16),
                       device="cpu")
    assert all(p.device.type == "cpu" for p in pot.module.parameters())


@pytest.mark.parametrize("key,value", [
    ("precision", 16), ("output_model", "ScalarPlusWeightedCoulomb"),
    ("remat", True)])
def test_uncovered_options_raise(key, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model(dict(TENSORNET_ARGS, **{key: value}), device="cpu")


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


def test_blocked_forward_raises():
    """``blocked=True`` needs a model built with a cell_block_spec."""
    z, pos, box = lattice_system(n_side=2)
    pot = create_model(TENSORNET_ARGS, device="cpu")
    with pytest.raises(ValueError, match="cell_block_spec"):
        pot.apply(z, pos, None, num_mols=1, box=box, blocked=True)
