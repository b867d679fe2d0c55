"""Kernels A and B of the port with the exact rbf base (``q_tab=0``; rows
12x and 13x) on the grouped tier's column-partitioned K′ list against the
JAX package's ``blocked_neighbor_sum_asym_q`` with a precise spec (its
Pallas kernels, ``tab=False``, in interpret mode): the cases of
``test_torch_blocked_q_exact.py`` on the other layout, in a file of their
own so that each file builds one JAX case."""

import numpy as np
import pytest

from torch_parity import ATOL, RTOL, one_torch_thread, q_names, q_op_case

pytestmark = pytest.mark.usefixtures("one_torch_thread")
LAYOUTS = ("grouped",)
DIFF, WEIGHTS = q_names(exact=True)


@pytest.fixture(scope="module")
def cases():
    return {layout: q_op_case(layout, exact=True) for layout in LAYOUTS}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", ("out",) + DIFF)
def test_exact_blocked_q_matches_jax(cases, layout, name):
    want, got, _ = cases[layout]
    assert np.abs(want[name]).max() > 1e-2  # non-vacuous
    np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_exact_blocked_q_contracts(cases, layout):
    """The rbf cotangent is exactly 0 on invalid slots in both packages,
    and every weight (W1a included) gets a zero gradient."""
    want, got, mask = cases[layout]
    assert not got["edge_attr"][~mask].any()
    assert not want["edge_attr"][~mask].any()
    for name in WEIGHTS:
        assert not np.any(want[name]) and not np.any(got[name]), name
