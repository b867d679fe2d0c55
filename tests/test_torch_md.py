"""The port's MD loop against the JAX ``make_md_step``: ten NVE steps
(no thermostat, so no random numbers to match) across neighbor rebuilds,
with the same weights and the skin-cached model and Coulomb lists."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (ATOL, RTOL, SMALL_ARGS, jax_and_port,
                          lattice_system, one_torch_thread)
from torchmdnet_tpu.md.integrators import make_md_step as jax_make_md_step
from torchmdnet_tpu_torch.md.integrators import make_md_step
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.utils.jax_params import params_from_jax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the JAX reference runs its jnp chains here (numerically the Pallas ops'
# reference chains) so the jitted MD chunk compiles quickly
ARGS = dict(SMALL_ARGS, pallas_embedding=False, pallas_edge_mlp=False)


@pytest.fixture(scope="module")
def nve_system():
    """The NVE system and the JAX model with its weights, built once for
    both neighbor strategies."""
    z, pos, box = lattice_system(n_side=4, spacing=3.2, seed=1)
    return (z, pos, box), jax_and_port(ARGS, z, pos, box)


@pytest.mark.parametrize("strategy", ["brute", "cell"])
def test_nve_steps_match_jax(strategy, nve_system):
    (z, pos, box), (jpot, variables, _, flat) = nve_system
    masses = np.where(z == 1, 1.008, 12.011)
    # the port runs its kernel ops (plain versions on the CPU)
    tpot = create_model(SMALL_ARGS, device="cpu")
    tpot.module.load_state_dict(params_from_jax(flat), strict=True)

    kw = dict(dt=0.5, num_mols=1, rebuild_every=5, skin=1.0,
              temperature=None, neighbor_strategy=strategy)
    batch = np.zeros(len(z), np.int32)
    j_init, j_chunk, _ = jax_make_md_step(
        jpot, variables, jnp.asarray(z), jnp.asarray(batch), masses,
        box=jnp.asarray(box), **kw)
    t_init, t_chunk, t_energy = make_md_step(tpot, z, batch, masses,
                                             box=box, **kw)
    js, ts = j_init(pos), t_init(pos)
    np.testing.assert_allclose(ts.force.numpy(), np.asarray(js.force),
                               rtol=RTOL, atol=ATOL)
    for _ in range(2):  # 2 chunks = 10 steps, a rebuild before each
        js, ts = j_chunk(js), t_chunk(ts)
    assert ts.step == int(js.step) == 10
    assert not bool(ts.overflow) and not bool(js.overflow)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts.force.numpy(), np.asarray(js.force),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts.vel.numpy(), np.asarray(js.vel),
                               rtol=RTOL, atol=ATOL)
    e = t_energy(ts.pos, ts)
    np.testing.assert_allclose(e.numpy(), ts.energy.numpy(), rtol=1e-6)


def test_langevin_chunk_runs_and_overflow_is_sticky():
    z, pos, box = lattice_system(n_side=3, spacing=3.4, seed=2)
    tpot = create_model(SMALL_ARGS, device="cpu")
    masses = np.where(z == 1, 1.008, 12.011)
    init, chunk, _ = make_md_step(
        tpot, z, np.zeros(len(z)), masses, dt=0.5, box=box, rebuild_every=3,
        temperature=300.0, k_max=4)  # too few slots: overflow
    st = chunk(init(pos, seed=7))
    assert bool(st.overflow) and st.step == 3
    assert torch.isfinite(st.pos).all() and torch.isfinite(st.energy).all()
    # same seed, same trajectory
    st2 = chunk(init(pos, seed=7))
    assert torch.equal(st.pos, st2.pos)
