"""Rows 8-11 of the port on the grouped tier's column-partitioned K′ list
(plain versions on the CPU) against the JAX package's grouped blocked
TensorNet ops with a precise spec, their Pallas kernels in interpret mode:
the four ops and both differentiable wrappers (the grouped tuner's slot
budgets: ``test_torch_column_slots.py``)."""

import numpy as np
import pytest

from torch_parity import (ATOL, BLOCKED_QUANTITIES, RTOL, blocked_mp_case,
                          one_torch_thread)

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
