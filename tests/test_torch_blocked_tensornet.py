"""The port's blocked TensorNet (``bench.py::main`` with ``BENCH_BLOCKED=1``)
end to end: energies and forces in the original atom order against the
JAX package's blocked precise path (its Pallas kernels in interpret mode)
for the tabulated model on a grouped spec (the bench default) and the
exact one on an ungrouped spec; the port's blocked against its gather
path in the three variants ``chip_smoke.py`` runs; and a grouped-spec MD
run (helpers in ``torch_parity.py``)."""

import numpy as np
import pytest
import torch

from torch_parity import (ATOL, BT_CUTOFF, BT_SKIN, RTOL,
                          bt_check_against_jax, bt_port, bt_port_blocked,
                          bt_setup, bt_system, one_torch_thread)
from torchmdnet_tpu_torch.md.integrators import make_md_step
from torchmdnet_tpu_torch.ops import cell_blocks as tcb

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def setup():
    return bt_setup()


@pytest.mark.parametrize("variant", ["tabulated_grouped", "exact_ungrouped"])
def test_blocked_tensornet_matches_jax(setup, variant, monkeypatch):
    """The tabulated model on a grouped spec (the bench default) and the
    exact one (``pallas_edge_mlp``: rows 8, 9) on an ungrouped spec."""
    bt_check_against_jax(setup, variant, monkeypatch)


@pytest.mark.parametrize("variant", ["tabulated_grouped",
                                     "tabulated_ungrouped", "exact_grouped"])
def test_blocked_tensornet_matches_gather_path(setup, variant, monkeypatch):
    """The same function with the sums in another order: rtol = atol =
    1e-4 against the port's gather path on the same weights."""
    e_b, f_b, _ = bt_port_blocked(setup, variant, monkeypatch)
    y_g, f_g = bt_port(setup, variant).apply(
        setup["z"], setup["pos"], None, num_mols=1, box=setup["box"])
    np.testing.assert_allclose(e_b, float(y_g), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(f_b, f_g.numpy(), rtol=RTOL, atol=ATOL)


def test_grouped_md_matches_the_gather_integrator(setup):
    """``make_md_step`` with a grouped spec tuned at cutoff + skin: the
    t=0 forces equal the non-blocked integrator's to 1e-4 of max |F|, and
    a chunk runs clean on the column-partitioned list."""
    z, pos, box = bt_system(n=300, seed=1)
    masses = np.where(z == 1, 1.008, 12.011)
    spec = tcb.tune_cell_block_spec(pos, np.diag(box), BT_CUTOFF + BT_SKIN,
                                    cap=8, column_slots=True)
    gather = bt_port(setup, "tabulated_grouped")
    blocked = bt_port(setup, "tabulated_grouped", spec)
    kw = dict(dt=0.2, num_mols=1, box=box, rebuild_every=3, skin=BT_SKIN,
              temperature=None)
    init_a, _, _ = make_md_step(gather, z, np.zeros(300), masses, **kw)
    init_b, chunk_b, _ = make_md_step(blocked, z, np.zeros(300), masses,
                                      cell_block_spec=spec, **kw)
    sa, sb = init_a(pos, seed=1), init_b(pos, seed=1)
    assert sb.nbr_idx.shape[1] == sum(spec.col_slots)
    assert not bool(sb.overflow)
    fa, fb = sa.force.numpy(), sb.force.numpy()
    assert np.abs(fb - fa).max() <= 1e-4 * np.abs(fa).max()
    sb = chunk_b(sb)
    assert sb.step == 3 and not bool(sb.overflow)
    assert torch.isfinite(sb.pos).all() and torch.isfinite(sb.force).all()

