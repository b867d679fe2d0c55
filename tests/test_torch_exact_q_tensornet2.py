"""The port's TensorNet2 blocked tier with ``q_tab=0`` (the exact rbf
operand of rows 12x and 13x): the model on the ungrouped spec against the
JAX package's (precise spec, Pallas kernels in interpret mode), energy
and forces; the grouped layout (no dual list: the embedding on K′) and
the tabulated tier against it; and its MD on both layouts (helpers in
``torch_parity.py``)."""

import numpy as np
import pytest
import torch

from torch_parity import (ATOL, Q2_CUTOFF, Q2_N, Q2_SKIN, RTOL,
                          one_torch_thread, q2_jax, q2_port,
                          q2_port_blocked, q2_setup)
from torchmdnet_tpu_torch.md.integrators import make_md_step
from torchmdnet_tpu_torch.ops import cell_blocks as tcb

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def setup():
    return q2_setup()


@pytest.fixture(scope="module")
def exact(setup):
    """(JAX, port) energy and forces of the ungrouped q_tab=0 model."""
    return (q2_jax(setup, "exact_ungrouped"),
            q2_port_blocked(setup, "exact_ungrouped"))


@pytest.mark.parametrize("quantity", [0, 1], ids=["energy", "forces"])
def test_exact_q_model_matches_jax(exact, quantity):
    want, got = exact
    assert got[2] == {"q_fwd_rbf", "q_dq_rbf"}  # rows 12x and 13x
    assert np.abs(want[1]).max() > 1e-2  # non-vacuous
    np.testing.assert_allclose(got[quantity], want[quantity], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("variant", ["exact_grouped", "ungrouped"])
def test_other_q_tiers_match_the_exact_one(setup, exact, variant):
    """The grouped layout (the same pairs) and the tabulated base (a
    T=24 series of the same function) give the exact tier's energy and
    forces to 1e-4."""
    e, f, calls = q2_port_blocked(setup, variant)
    assert calls == ({"q_fwd_rbf", "q_dq_rbf"} if variant.startswith("exact")
                     else {"q_fwd", "q_dq"})
    np.testing.assert_allclose(e, exact[1][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(f, exact[1][1], rtol=RTOL, atol=ATOL)


def test_exact_q_md_on_both_layouts(setup):
    """``make_md_step`` with ``q_tab=0`` on the grouped and the ungrouped
    spec tuned at cutoff + skin: no dual list on the grouped one, and the
    t=0 forces and a 3-step NVE chunk agree within 1e-4 of max |F|."""
    z = setup["z"]
    states = {}
    for layout, grouped in (("exact_grouped", True),
                            ("exact_ungrouped", False)):
        spec = tcb.tune_cell_block_spec(setup["pos"], setup["bd"],
                                        Q2_CUTOFF + Q2_SKIN, cap=8,
                                        column_slots=grouped)
        pot, _ = q2_port(setup, layout)
        init, chunk, _ = make_md_step(
            pot, z, np.zeros(Q2_N), np.where(z == 1, 1.008, 12.011), dt=0.2,
            num_mols=1, box=setup["box"], q=torch.zeros(1), rebuild_every=3,
            skin=Q2_SKIN, temperature=None, cell_block_spec=spec,
            coulomb_window_spec="auto")
        st0 = init(setup["pos"])
        states[layout] = (st0, chunk(st0))
    (g0, g1), (u0, u1) = states["exact_grouped"], states["exact_ungrouped"]
    assert g0.enbr_idx is None and u0.enbr_idx is None
    assert g1.step == u1.step == 3
    assert not bool(g1.overflow) and not bool(u1.overflow)
    for a, b in ((g0.force, u0.force), (g1.force, u1.force)):
        scale = float(b.abs().max())
        assert scale > 1e-2
        assert float((a - b).abs().max()) <= 1e-4 * scale
