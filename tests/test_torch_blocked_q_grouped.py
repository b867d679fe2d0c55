"""Kernels A and B of the port (``ops/blocked_q.py``, plain versions on the
CPU) on the grouped tier's column-partitioned K′ list, θ-tabulated base
(rows 12g and 13g), against the JAX package's
``blocked_neighbor_sum_asym_q_tab`` with a precise grouped spec, its
``_mp_kernel_q_grouped`` and ``_dq_kernel_grouped`` in interpret mode: the
forward output, the cotangents of d, cwfm, u_i, u_j and feats9, and zero
weight gradients (helper ``torch_parity.py::q_op_case``)."""

import numpy as np
import pytest

from torch_parity import ATOL, RTOL, one_torch_thread, q_names, q_op_case

pytestmark = pytest.mark.usefixtures("one_torch_thread")
DIFF, WEIGHTS = q_names(exact=False)


@pytest.fixture(scope="module")
def case():
    return q_op_case("grouped", exact=False)


@pytest.mark.parametrize("name", ("out",) + DIFF)
def test_grouped_blocked_q_matches_jax(case, name):
    want, got, _ = case
    assert np.abs(want[name]).max() > 1e-2  # non-vacuous
    np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=ATOL)


def test_grouped_blocked_q_contracts(case):
    """Most K′ slots are empty; their d and cwfm cotangents are exactly 0
    in both packages, and every weight gets a zero gradient."""
    want, got, mask = case
    assert (~mask).sum() > mask.sum()
    for name in ("d", "cwfm"):
        assert not got[name][~mask].any() and not want[name][~mask].any()
    for name in WEIGHTS:
        assert not np.any(want[name]) and not np.any(got[name]), name
