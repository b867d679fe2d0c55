"""The port's grouped TensorNet2 tier (``bench.py::bench_northstar`` with
``BENCH_MD_GROUPED=1``, small): the dual-list model — the embedding on a
compact K list, the interactions on the column-partitioned K′ list through
the θ-tabulated q-tier (rows 12g and 13g) — against the JAX package's
(precise spec, Pallas kernels in interpret mode), energy and forces; the
grouped MD integrator against the ungrouped one, and its compact list
against a direct build (helpers in ``torch_parity.py``)."""

import numpy as np
import pytest
import torch

from torch_parity import (ATOL, Q2_CUTOFF, Q2_K, Q2_N, Q2_SKIN, RTOL,
                          one_torch_thread, q2_jax, q2_port,
                          q2_port_blocked, q2_setup)
from torchmdnet_tpu_torch.md.integrators import make_md_step
from torchmdnet_tpu_torch.ops import cell_blocks as tcb
from torchmdnet_tpu_torch.ops.neighbors import build_neighbor_matrix

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def setup():
    # one interaction layer: the JAX grouped kernels' interpret-mode
    # compile is most of this file's time, one copy per layer
    return q2_setup(num_layers=1)


@pytest.fixture(scope="module")
def dual(setup):
    """(JAX, port) energy and forces of the dual-list grouped model."""
    return q2_jax(setup, "grouped_dual"), q2_port_blocked(setup,
                                                          "grouped_dual")


@pytest.mark.parametrize("quantity", [0, 1], ids=["energy", "forces"])
def test_dual_list_grouped_model_matches_jax(dual, quantity):
    want, got = dual
    assert got[2] == {"q_fwd", "q_dq"}  # the tabulated rows 12-13
    assert np.abs(want[1]).max() > 1e-2  # non-vacuous
    np.testing.assert_allclose(got[quantity], want[quantity], rtol=RTOL,
                               atol=ATOL)


def test_grouped_embedding_on_k_prime_matches_dual_list(setup, dual):
    """Without ``nbr_emb`` the embedding runs on the K′ list: the same
    pairs, so the same energy and forces to 1e-4."""
    e, f, calls = q2_port_blocked(setup, "grouped")
    assert calls == {"q_fwd", "q_dq"}
    np.testing.assert_allclose(e, dual[1][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(f, dual[1][1], rtol=RTOL, atol=ATOL)


def _md(setup, variant, spec):
    z = setup["z"]
    pot, _ = q2_port(setup, variant)
    return make_md_step(
        pot, z, np.zeros(Q2_N), np.where(z == 1, 1.008, 12.011), dt=0.2,
        num_mols=1, box=setup["box"], q=torch.zeros(1), rebuild_every=3,
        skin=Q2_SKIN, temperature=None, cell_block_spec=spec,
        coulomb_window_spec="auto")


@pytest.fixture(scope="module")
def md(setup):
    """NVE on the grouped (dual-list) and ungrouped specs tuned at
    cutoff + skin, from the same positions and velocities: the initial
    states and the states after one chunk."""
    vel = np.random.RandomState(2).randn(Q2_N, 3).astype(np.float32) * 0.01
    out = {}
    for layout, grouped in (("grouped", True), ("ungrouped", False)):
        spec = tcb.tune_cell_block_spec(setup["pos"], setup["bd"],
                                        Q2_CUTOFF + Q2_SKIN, cap=8,
                                        column_slots=grouped)
        init, chunk, energy = _md(setup, layout, spec)
        st0 = init(setup["pos"], vel=vel)
        out[layout] = (spec, st0, chunk(st0), energy)
    return out


def test_grouped_md_matches_ungrouped_md(md):
    """t=0 forces and, after a 3-step chunk, positions and forces within
    1e-4 of max |F| (positions: 1e-4 Å)."""
    _, g0, g1, _ = md["grouped"]
    _, u0, u1, _ = md["ungrouped"]
    assert g1.step == u1.step == 3
    assert not bool(g1.overflow) and not bool(u1.overflow)
    for a, b in ((g0.force, u0.force), (g1.force, u1.force)):
        scale = float(b.abs().max())
        assert scale > 1e-2
        assert float((a - b).abs().max()) <= 1e-4 * scale
    np.testing.assert_allclose(g1.pos.numpy(), u1.pos.numpy(), rtol=0,
                               atol=ATOL)


def test_grouped_md_carries_a_compact_list(md):
    """The grouped state carries the K′ list and the compact K list of the
    dual-list embedding; the ungrouped state no second list."""
    spec, g0, g1, energy = md["grouped"]
    _, u0, _, _ = md["ungrouped"]
    assert g0.nbr_idx.shape[1] == sum(spec.col_slots)
    assert g0.enbr_idx.shape == (spec.n_pad, Q2_K)
    assert g1.enbr_idx.shape == g0.enbr_idx.shape
    assert u0.enbr_idx is None
    np.testing.assert_allclose(energy(g1.pos, g1).numpy(),
                               g1.energy.numpy(), rtol=1e-6)


def test_grouped_md_compact_list_equals_a_direct_build(setup, md):
    """The rebuild's ``enbr_*`` equal a compact cell build on the spec's xy
    grid in the same sorted space (JAX ``integrators.py:282-289``)."""
    spec, g0, _, _ = md["grouped"]
    pos_s = torch.where(g0.mask_rows[:, None],
                        torch.from_numpy(setup["pos"])[g0.perm], 0.0)
    nz = max(int(setup["bd"][2] // (Q2_CUTOFF + Q2_SKIN)), 3)
    occ = Q2_N / (spec.nx * spec.ny * nz)
    want = build_neighbor_matrix(
        pos_s, g0.batchs, atom_mask=g0.mask_rows, strategy="cell",
        k_max=Q2_K, cutoff_upper=Q2_CUTOFF + Q2_SKIN, cutoff_lower=0.0,
        loop=True, box=torch.from_numpy(setup["box"]),
        cells_per_dim=(spec.nx, spec.ny, nz),
        cell_capacity=int(np.ceil(occ * 2.5)) + 8)
    assert not bool(want.overflow)
    assert torch.equal(g0.enbr_idx, want.idx)
    assert torch.equal(g0.enbr_mask, want.mask)
    assert torch.equal(g0.enbr_rev, want.rev_slot)
    assert int(want.mask.sum()) > 5 * Q2_N  # non-vacuous


def test_nbr_emb_needs_the_tabulated_q_tier(setup):
    """The dual list is the θ-tabulated tier's: with ``q_tab=0`` the
    interactions need the rbf array, and ``nbr_emb`` raises (JAX asserts,
    ``tensornet2.py:363-368``)."""
    pot, _ = q2_port(setup, "exact_grouped")
    z, pos, box = setup["z"], setup["pos"], setup["box"]
    nbr = build_neighbor_matrix(torch.from_numpy(pos), strategy="brute",
                                k_max=Q2_K, cutoff_upper=Q2_CUTOFF,
                                box=torch.from_numpy(box))
    with pytest.raises(ValueError, match="dual-list"):
        pot.energy(z, pos, box=box, nbr=nbr, nbr_emb=nbr)
