"""The port's TensorNet2 + ScalarPlusWeightedCoulomb potential against the
JAX package with both Pallas kernels on (interpret mode), given the same
weights through ``params_from_jax``, and a grouped spec building the
blocked q-tier (the key mapping and the options the port does not cover:
``test_torch_model_options.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (ATOL, RTOL, SMALL_ARGS, jax_and_port, jax_apply,
                          lattice_system, one_torch_thread, to_np)
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.ops.cell_blocks import make_cell_block_spec
from torchmdnet_tpu_torch.utils.jax_params import params_from_jax

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def system():
    z, pos, box = lattice_system()
    jpot, variables, tpot, flat = jax_and_port(SMALL_ARGS, z, pos, box)
    return z, pos, box, jpot, variables, tpot, flat


def test_weights_load_strict(system):
    *_, tpot, flat = system
    sd = params_from_jax(flat)
    fresh = create_model(SMALL_ARGS, device="cpu")
    result = fresh.module.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert set(sd) == set(fresh.module.state_dict())
    assert len(sd) == len(flat)


def test_energy_and_forces_match_jax(system):
    z, pos, box, jpot, variables, tpot, _ = system
    y_j, f_j = jax_apply(jpot, variables, z, pos, box)
    y_t, f_t = tpot.apply(z, pos, None, num_mols=1, box=box)
    assert y_t.shape == (1, 1) and f_t.shape == pos.shape
    np.testing.assert_allclose(to_np(y_t), y_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_np(f_t), f_j, rtol=RTOL, atol=ATOL)


def test_plain_branches_match_the_kernel_ops(system):
    """pallas_* off runs the plain chains under autograd; on the CPU the
    kernel ops run their plain versions: both give the same numbers."""
    z, pos, box, *_, tpot, flat = system
    args = dict(SMALL_ARGS, pallas_embedding=False, pallas_edge_mlp=False)
    plain = create_model(args, device="cpu")
    plain.module.load_state_dict(params_from_jax(flat), strict=True)
    y_p, f_p = plain.apply(z, pos, None, num_mols=1, box=box)
    y_t, f_t = tpot.apply(z, pos, None, num_mols=1, box=box)
    np.testing.assert_allclose(to_np(y_p), to_np(y_t), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(f_p), to_np(f_t), rtol=1e-5, atol=1e-5)


# a grouped (col_slots) spec: the grouped q-tier is ported (its parity
# with JAX: tests/test_torch_grouped_tensornet2.py, _exact_q_tensornet2.py)
GROUPED_SPEC = make_cell_block_spec([20.0] * 3, 5.5, 64)._replace(
    col_slots=(8,) * 9)


@pytest.mark.parametrize("q_tab", [64, 0])
def test_grouped_spec_builds_the_blocked_q_tier(q_tab):
    """A grouped spec and ``q_tab=0`` build: every interaction runs the
    q-tier on the spec, with the series (``q_tab`` terms) or the rbf."""
    pot = create_model(dict(SMALL_ARGS, cell_block_spec=GROUPED_SPEC,
                            q_tab=q_tab), device="cpu")
    rep = pot.module.representation_model
    assert rep.q_tab == q_tab and rep.cell_block_spec == GROUPED_SPEC
    assert all(layer.q_tier for layer in rep.layers)
