"""Second order through the port's differentiable ops of the training
path: ``gradcheck`` and ``gradgradcheck`` in float64 of the Chebyshev
filter, filter-dot and projection Functions, the symmetric packed
neighbor sum, its weight gradient and the node gather; and the gradient
of a force-like loss (a function of ∂E/∂d) against ``jax.grad`` through
``pallas_cheb.cheb_filter``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

from torch_parity import ATOL, RTOL, one_torch_thread  # noqa: F401
from torchmdnet_tpu.ops import pallas_cheb
from torchmdnet_tpu_torch.ops.cheb import cheb_fit_matrix, cheb_nodes
from torchmdnet_tpu_torch.ops.cheb_filter import (
    cheb_filter, cheb_filter_dot, cheb_project)
from torchmdnet_tpu_torch.ops.message_passing import (
    _PnsDattr, gather_nodes, packed_neighbor_sum, packed_neighbor_sum_sym)
from torchmdnet_tpu_torch.ops.neighbors import (
    build_neighbor_matrix, neighbor_geometry)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HI = 4.5


def _cheb_inputs(T=8, C=4, N=5, K=4, seed=0, dtype=torch.float64):
    """A smooth fitted series, distances inside (0, hi) away from the clip
    (so that finite differences see no kink), a ragged 0/1 ``fm`` with a
    row of zeros, and a cotangent."""
    rng = np.random.RandomState(seed)
    dk = cheb_nodes(T, 0.0, HI, dtype=torch.float64).numpy()
    target = np.stack([np.exp(-dk) * np.cos(0.7 * c * dk) for c in range(C)],
                      -1)
    coeffs = cheb_fit_matrix(T, dtype=torch.float64).numpy() @ target
    d = rng.uniform(0.3, HI - 0.3, (N, K))
    fm = (rng.rand(N, K) > 0.25).astype(np.float64)
    fm[1] = 0.0
    ct = rng.randn(N, K, C)
    return [torch.tensor(a, dtype=dtype) for a in (coeffs, d, fm, ct)]


def _leaf(t):
    return t.clone().requires_grad_(True)


# each case: the argument positions that require a gradient.  The
# projection gives d no gradient (as in JAX), so d and the coefficients
# are checked apart wherever the projection appears in a backward.
@pytest.mark.parametrize("wrt", [("coeffs",), ("d",)])
def test_cheb_filter_gradgradcheck(wrt):
    coeffs, d, fm, _ = _cheb_inputs()
    c = _leaf(coeffs) if "coeffs" in wrt else coeffs
    dd = _leaf(d) if "d" in wrt else d
    inputs = tuple(t for t in (c, dd) if t.requires_grad)

    def fn(*args):
        it = iter(args)
        a = next(it) if c.requires_grad else c
        b = next(it) if dd.requires_grad else dd
        return cheb_filter(a, b, fm, 0.0, HI)

    assert gradcheck(fn, inputs)
    assert gradgradcheck(fn, inputs)


@pytest.mark.parametrize("wrt", [("coeffs", "ct"), ("d", "ct")])
def test_cheb_filter_dot_gradgradcheck(wrt):
    coeffs, d, fm, ct = _cheb_inputs(seed=1)
    c = _leaf(coeffs) if "coeffs" in wrt else coeffs
    dd = _leaf(d) if "d" in wrt else d
    cc = _leaf(ct)
    inputs = tuple(t for t in (c, dd, cc) if t.requires_grad)

    def fn(*args):
        it = iter(args)
        a = next(it) if c.requires_grad else c
        b = next(it) if dd.requires_grad else dd
        return cheb_filter_dot(a, b, fm, next(it), 0.0, HI)

    assert gradcheck(fn, inputs)
    assert gradgradcheck(fn, inputs)


def test_cheb_project_gradgradcheck():
    coeffs, d, fm, ct = _cheb_inputs(seed=2)
    cc = _leaf(ct)

    def fn(x):
        return cheb_project(d, fm, x, coeffs.shape[0], 0.0, HI)

    assert gradcheck(fn, (cc,))
    assert gradgradcheck(fn, (cc,))


def test_force_loss_second_order_matches_jax():
    """``L = Σ(∂E/∂d · w)²`` with ``E = Σ h·cheb_filter(coeffs, d, fm)``:
    its gradient in ``coeffs`` and ``d`` runs rows 5, 6 and 7 through
    their backwards (the force-training pattern), against ``jax.grad``."""
    coeffs, d, fm, h = _cheb_inputs(T=32, C=24, N=16, K=8, seed=3,
                                     dtype=torch.float32)
    # ∂E/∂d carries the derivative series (terms up to 2·(T − 1)²/hi), so
    # w is scaled to keep the loss's gradients O(1), where the f32 bar
    # means what it says
    w = torch.from_numpy(
        0.01 * np.random.RandomState(4).randn(16, 8).astype(np.float32))

    def jloss(c, dd):
        energy = lambda x: jnp.sum(pallas_cheb.cheb_filter(  # noqa: E731
            c, x, jnp.asarray(fm.numpy()), 0.0, HI) * jnp.asarray(h.numpy()))
        return jnp.sum((jax.grad(energy)(dd) * jnp.asarray(w.numpy())) ** 2)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(coeffs.numpy()),
                                            jnp.asarray(d.numpy()))
    c, dd = _leaf(coeffs), _leaf(d)
    energy = (cheb_filter(c, dd, fm, 0.0, HI) * h).sum()
    (de,) = torch.autograd.grad(energy, dd, create_graph=True)
    loss = ((de * w) ** 2).sum()
    got = torch.autograd.grad(loss, (c, dd))
    for g, ref in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


def _graph(seed=0, n=10, k=8, f=2):
    """A small open cluster's full neighbor matrix (a symmetric edge set,
    self slot included), weights that are a function of the distance
    (edge-symmetric), and random features, in float64."""
    rng = np.random.RandomState(seed)
    pos = torch.from_numpy(rng.uniform(0, 6.0, (n, 3)))
    nbr = build_neighbor_matrix(pos, strategy="brute", k_max=k,
                                cutoff_upper=3.2, loop=True)
    assert not bool(nbr.overflow) and not bool(nbr.mask.all())
    _, dist = neighbor_geometry(pos, nbr)
    attr = torch.sin(dist[..., None] * torch.arange(1, 3 * f + 1) * 0.7)
    attr = attr * nbr.mask[..., None]
    feats = torch.from_numpy(rng.randn(n, 9 * f))
    return nbr, attr, feats


def test_packed_neighbor_sum_sym_gradgradcheck():
    nbr, attr, feats = _graph()
    m = nbr.mask[..., None].double()

    def fn(a, x):
        return packed_neighbor_sum_sym(a * m, x, nbr.idx, nbr.rev_slot,
                                       nbr.mask)

    inputs = (_leaf(attr), _leaf(feats))
    assert gradcheck(fn, inputs)
    assert gradgradcheck(fn, inputs)


def test_pns_dattr_gradgradcheck():
    """The weight gradient of the sum, whose VJP is two general packed
    sums (one over the reverse gather)."""
    nbr, _, feats = _graph(seed=1)
    g9 = torch.from_numpy(np.random.RandomState(5).randn(*feats.shape))

    def fn(g, x):
        return _PnsDattr.apply(g, x, nbr.idx, nbr.rev_slot, nbr.mask)

    inputs = (_leaf(g9), _leaf(feats))
    assert gradcheck(fn, inputs)
    assert gradgradcheck(fn, inputs)


def test_packed_neighbor_sum_gradgradcheck():
    """The general sum (direction-dependent weights), whose backward is
    the scatter-free pair of ``_PnsBwdPair``."""
    nbr, attr, feats = _graph(seed=2)
    m = nbr.mask[..., None].double()
    asym = attr * (1.0 + torch.from_numpy(
        np.random.RandomState(6).rand(*attr.shape)))

    def fn(a, x):
        return packed_neighbor_sum(a * m, x, nbr.idx, nbr.rev_slot, nbr.mask)

    inputs = (_leaf(asym), _leaf(feats))
    assert gradcheck(fn, inputs)
    assert gradgradcheck(fn, inputs)


def test_gather_nodes_gradgradcheck():
    nbr, _, feats = _graph(seed=3)

    def fn(x):
        return gather_nodes(x, nbr.idx, nbr.rev_slot, nbr.mask)

    inputs = (_leaf(feats),)
    assert gradcheck(fn, inputs)
    assert gradgradcheck(fn, inputs)


def test_project_wrapper_refuses_cpu_tensors():
    from torchmdnet_tpu_torch.ops.cheb_filter import cheb_project_cuda

    coeffs, d, fm, ct = _cheb_inputs(dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        cheb_project_cuda(d, fm, ct, coeffs.shape[0], 0.0, HI)


@pytest.mark.parametrize("e, t, c", [(66560, 128, 384), (296, 16, 24),
                                     (1, 130, 8), (10 ** 7, 128, 384),
                                     (23 * 256 + 5, 128, 384), (0, 64, 8)])
def test_project_grid_covers_every_slot(e, t, c):
    """Row 6's chunks of 256-slot spans cover every slot once, each
    chunk at least one span, in about two blocks an SM over the ⌈C/128⌉ ×
    ⌈T/64⌉ output tiles (no more blocks than two an SM plus one chunk of
    tiles, and every SM's two busy when there are spans enough); a block's
    shared memory, with a window of 3,072 slots, fits a Hopper SM twice, and
    the partial scratch is a few chunks of [T, C] whatever the slot
    count (none with one chunk)."""
    from torchmdnet_tpu_torch.ops.cheb_filter import (
        project_chunks, project_plan)

    spans = -(-e // 256)
    chunks = project_chunks(e, t, c)
    assert [s for a, b in chunks for s in range(a, b)] == list(range(spans))
    assert all(b > a for a, b in chunks)
    tiles = -(-c // 128) * -(-t // 64)
    plan = project_plan(e, t, c)
    assert plan["grid"] == (-(-c // 128), -(-t // 64), len(chunks))
    assert tiles * len(chunks) < 264 + tiles
    if spans * tiles >= 264:
        assert tiles * len(chunks) >= 264
    assert 2 * (plan["smem"] + 1024) <= 233472
    assert plan["partial_floats"] == (len(chunks) * t * c
                                      if len(chunks) > 1 else 0)
    assert plan["partial_floats"] <= -(-264 // tiles) * t * c
