"""Kernels A and B of the port (``ops/blocked_q.py``, plain versions on the
CPU) against the JAX package's ``blocked_neighbor_sum_asym_q_tab`` with a
precise spec, its Pallas kernels in interpret mode: the forward output,
the cotangents of d, cwfm, u_i, u_j and feats9, and zero weight
gradients (helper ``torch_parity.py::q_op_case``, the ungrouped list)."""

import numpy as np
import pytest

from torch_parity import ATOL, RTOL, one_torch_thread, q_names, q_op_case

pytestmark = pytest.mark.usefixtures("one_torch_thread")
DIFF, WEIGHTS = q_names(exact=False)


@pytest.fixture(scope="module")
def case():
    return q_op_case("ungrouped", exact=False)


@pytest.mark.parametrize("name", ("out",) + DIFF)
def test_blocked_q_matches_jax(case, name):
    want, got, _ = case
    assert np.abs(want[name]).max() > 1e-2  # non-vacuous
    np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=ATOL)


def test_blocked_q_weights_get_zero_gradients(case):
    want, got, _ = case
    for name in WEIGHTS:
        assert not np.any(want[name]) and not np.any(got[name]), name
