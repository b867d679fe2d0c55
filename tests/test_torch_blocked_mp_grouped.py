"""Rows 8-11 of the port on the grouped tier's column-partitioned K′ list
(plain versions on the CPU) against the JAX package's grouped blocked
TensorNet ops with a precise spec, their Pallas kernels in interpret mode:
the four ops and both differentiable wrappers; and the grouped tuner's
slot budgets against JAX's on the same positions."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import (ATOL, BLOCKED_QUANTITIES, RTOL, blocked_mp_case,
                          blocked_system, one_torch_thread)
from torchmdnet_tpu.ops import cell_blocks as jcb
from torchmdnet_tpu_torch.ops import cell_blocks as tcb


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def case():
    return blocked_mp_case("grouped")


@pytest.mark.parametrize("quantity", BLOCKED_QUANTITIES)
def test_grouped_blocked_op_matches_jax(case, quantity):
    """rtol = atol = 1e-4 (JAX's precise tier is ~2^-16 relative)."""
    want, got, _ = case
    assert np.abs(want[quantity]).max() > 1e-2  # non-vacuous
    np.testing.assert_allclose(got[quantity], want[quantity], rtol=RTOL,
                               atol=ATOL)


def test_grouped_blocked_contracts(case):
    """The K′ layout's empty group slots are exactly 0 in row 9 in both
    packages, and the series coefficients get a zero gradient."""
    want, got, mask = case
    assert (~mask).sum() > mask.sum()  # most K′ slots are empty
    assert not got["row9"][~mask].any() and not want["row9"][~mask].any()
    assert not got["cheb_dcoeffs"].any() and not want["cheb_dcoeffs"].any()


@pytest.mark.parametrize("cutoff,cap", [(3.2, 8), (3.7, 16)])
def test_tuned_column_slots_equal_jax(cutoff, cap):
    pos, bd = blocked_system(seed=5)
    want = jcb.tune_cell_block_spec(jnp.asarray(pos), jnp.asarray(bd),
                                    cutoff, cap=cap, column_slots=True)
    got = tcb.tune_cell_block_spec(pos, bd, cutoff, cap=cap,
                                   column_slots=True)
    assert got.col_slots == want.col_slots and len(got.col_slots) == 9
    for key in ("nx", "ny", "nzf", "cap", "n_pad", "cut_bins"):
        assert getattr(got, key) == getattr(want, key), key
    assert tcb.CellBlockSpec(**want._asdict()).col_slots == want.col_slots
