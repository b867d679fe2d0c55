"""Kernels 5 and 7 and row 6 of the port (their plain versions): the
Chebyshev-tabulated filter ops against the JAX ``pallas_cheb`` ops, both
in Pallas interpret mode and through their jnp fallback, forward and the
analytic backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from torchmdnet_tpu.ops import pallas_cheb
from torchmdnet_tpu_torch.ops.cheb import cheb_deriv_coeffs, cheb_fit_matrix, cheb_nodes
from torchmdnet_tpu_torch.ops.cheb_filter import (
    cheb_filter, cheb_filter_cuda, cheb_filter_dot, cheb_filter_dot_cuda,
    cheb_filter_dot_ref, cheb_filter_ref, cheb_project, cheb_project_ref,
    image_floats, launch_plan)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = ATOL = 1e-4
T, C, N, K = 32, 24, 16, 8
HI = 4.5


def _inputs(seed=0):
    """A smooth [T, C] series fitted at the nodes, distances in [0, 1.1·hi]
    (some above hi) with a ragged mask that is 0 at and above hi, a row
    with fm = 0 throughout, and a cotangent."""
    rng = np.random.RandomState(seed)
    dk = cheb_nodes(T, 0.0, HI).double().numpy()
    target = np.stack([np.exp(-dk) * np.cos(c * dk) for c in range(C)], -1)
    coeffs = (cheb_fit_matrix(T).double().numpy() @ target).astype(np.float32)
    d = rng.uniform(0, HI * 1.1, (N, K)).astype(np.float32)
    d[0, :3] = (0.0, HI, HI * 1.05)
    fm = ((rng.rand(N, K) > 0.2) & (d < HI)).astype(np.float32)
    fm[3] = 0.0
    ct = rng.randn(N, K, C).astype(np.float32)
    return coeffs, d, fm, ct


@pytest.mark.parametrize("interpret", [True, False])
def test_ops_match_jax(interpret):
    coeffs, d, fm, ct = _inputs()
    jc, jd, jf, jct = map(jnp.asarray, (coeffs, d, fm, ct))
    tc, td, tf, tct = map(torch.from_numpy, (coeffs, d, fm, ct))
    want = pallas_cheb.cheb_filter(jc, jd, jf, 0.0, HI, interpret)
    got = cheb_filter(tc, td, tf, 0.0, HI)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got.numpy(),
                                  cheb_filter_ref(tc, td, tf, 0.0, HI).numpy())
    assert not got[3].any() and not got[0, 1:3].any()

    want = pallas_cheb.cheb_filter_dot(jc, jd, jf, jct, 0.0, HI, interpret)
    got = cheb_filter_dot(tc, td, tf, tct, 0.0, HI)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(
        got.numpy(), cheb_filter_dot_ref(tc, td, tf, tct, 0.0, HI).numpy())

    # the port's projection takes fm and ct apart; JAX's their product
    ctw = ct * fm[..., None]
    want = pallas_cheb.cheb_project(jd, jnp.asarray(ctw), T, 0.0, HI,
                                    interpret)
    got = cheb_project(td, tf, tct, T, 0.0, HI)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(
        got.numpy(), cheb_project_ref(td, tf, tct, T, 0.0, HI).numpy())


@pytest.mark.parametrize("interpret", [True, False])
def test_backward_matches_jax(interpret):
    """∂d through the filter-dot of the derivative series, ∂coeffs through
    the projection; fm gets no gradient."""
    coeffs, d, fm, ct = _inputs(seed=1)

    def loss(c, dd):
        return jnp.sum(pallas_cheb.cheb_filter(c, dd, jnp.asarray(fm), 0.0,
                                               HI, interpret) * ct)

    gc_j, gd_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(coeffs),
                                                 jnp.asarray(d))
    tc = torch.from_numpy(coeffs).requires_grad_(True)
    td = torch.from_numpy(d).requires_grad_(True)
    tf = torch.from_numpy(fm).requires_grad_(True)
    (cheb_filter(tc, td, tf, 0.0, HI) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(gd_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc_j), rtol=RTOL,
                               atol=ATOL)
    assert tf.grad is None
    # ∂d alone is the filter-dot of the derivative series, scaled
    dser = cheb_deriv_coeffs(torch.from_numpy(coeffs))
    dd = cheb_filter_dot(dser, torch.from_numpy(d), torch.from_numpy(fm),
                         torch.from_numpy(ct), 0.0, HI) * (2.0 / HI)
    np.testing.assert_allclose(td.grad.numpy(), dd.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_deriv_coeffs_match_jax():
    coeffs = _inputs()[0]
    want = pallas_cheb.cheb_deriv_coeffs(jnp.asarray(coeffs))
    got = cheb_deriv_coeffs(torch.from_numpy(coeffs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cuda_wrappers_refuse_cpu_tensors():
    coeffs, d, fm, ct = map(torch.from_numpy, _inputs())
    with pytest.raises(ValueError, match="CUDA"):
        cheb_filter_cuda(coeffs, d, fm, 0.0, HI)
    with pytest.raises(ValueError, match="CUDA"):
        cheb_filter_dot_cuda(coeffs, d, fm, ct, 0.0, HI)


# (n, K, T, F) of chip_smoke.py: the dhfr brute K = 64 list, the training
# batch's K = 40 list, and the ragged shapes of dhfr_shape_errors
TC_PLAN_SHAPES = [(2560, 64, 128, 128), (1664, 40, 128, 128),
                  (37, 8, 16, 8), (50, 33, 64, 32), (29, 96, 128, 128),
                  (41, 64, 100, 64), (23, 360, 128, 128), (45, 40, 128, 128),
                  (31, 64, 128, 68)]


@pytest.mark.parametrize("n,k,t,f", TC_PLAN_SHAPES)
def test_tc_launch_plan_fits_shared_memory(n, k, t, f):
    """Kernels 5 and 7 at E = n·K slots: every launch fits a Hopper block's
    232,448 B and leaves room for three blocks an SM (228 KB, 1 KB of it
    reserved per block; their registers allow two); the split
    series image holds a hi and a lo copy of every entry in whole 16 KB
    stages; block ``b``'s span ``[b·span, b·span + span)`` gives each slot
    one block and leaves no block empty."""
    e, c = n * k, 3 * f
    plan = launch_plan(e)
    assert set(plan) == {"cheb_filter", "cheb_filter_dot"}
    for name, (blocks, span, smem) in plan.items():
        assert 0 < smem <= 232448, name
        assert 233472 // (smem + 1024) >= 3, name
        owned = [range(b * span, min(e, b * span + span))
                 for b in range(blocks)]
        assert [s for slots in owned for s in slots] == list(range(e))
        assert all(len(slots) > 0 for slots in owned)
    assert image_floats(t, c) >= 2 * t * c
    assert image_floats(t, c) % (2 * 128 * 16) == 0
