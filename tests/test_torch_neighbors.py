"""The port's neighbor matrices, slot involution and minimum image against
the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from torchmdnet_tpu.ops import neighbors as jnb
from torchmdnet_tpu_torch.ops import neighbors as tnb
from torchmdnet_tpu_torch.ops.message_passing import reverse_slots

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _gas(n=120, L=14.0, seed=0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0.0, L, (n, 3)).astype(np.float32)
    return pos, np.diag([L, L, L]).astype(np.float32)


def _rows(idx, mask):
    idx, mask = np.asarray(idx), np.asarray(mask)
    return [sorted(int(j) for j in r[m]) for r, m in zip(idx, mask)]


def _check_layout(nbr):
    """Valid slots first; padded slots point at their own row."""
    idx, mask = nbr.idx.numpy(), nbr.mask.numpy()
    assert np.all(np.diff(mask.astype(int), axis=1) <= 0)
    rows = np.broadcast_to(np.arange(len(idx))[:, None], idx.shape)
    assert np.all(idx[~mask] == rows[~mask])


@pytest.mark.parametrize("strategy,kw", [
    ("brute", {}),
    ("cell", dict(cells_per_dim=(3, 3, 3), cell_capacity=32, stencil=1)),
    ("cell", dict(cells_per_dim=(7, 7, 7), cell_capacity=16, stencil=2)),
])
@pytest.mark.parametrize("loop,lower", [(True, 0.0), (False, 0.8)])
def test_neighbor_sets_match_jax(strategy, kw, loop, lower):
    pos, box = _gas()
    batch = np.zeros(len(pos), np.int32)
    batch[100:] = 1  # a second molecule: no cross-molecule pairs
    common = dict(k_max=64, cutoff_upper=4.5, cutoff_lower=lower, loop=loop)
    want = jnb.build_neighbor_matrix(
        jnp.asarray(pos), jnp.asarray(batch), strategy=strategy,
        box=jnp.asarray(box), **common, **kw)
    got = tnb.build_neighbor_matrix(
        torch.from_numpy(pos), torch.from_numpy(batch).long(),
        strategy=strategy, box=torch.from_numpy(box), **common, **kw)
    assert _rows(got.idx, got.mask) == _rows(want.idx, want.mask)
    np.testing.assert_array_equal(got.num_neighbors.numpy(),
                                  np.asarray(want.num_neighbors))
    assert not bool(got.overflow) and not bool(want.overflow)
    _check_layout(got)


@pytest.mark.parametrize("strategy,kw", [
    ("brute", {}),
    ("cell", dict(cells_per_dim=(3, 3, 3), cell_capacity=64)),
])
def test_overflow_flag(strategy, kw):
    pos, box = _gas()
    got = tnb.build_neighbor_matrix(
        torch.from_numpy(pos), strategy=strategy, box=torch.from_numpy(box),
        k_max=4, cutoff_upper=4.5, **kw)
    want = jnb.build_neighbor_matrix(
        jnp.asarray(pos), strategy=strategy, box=jnp.asarray(box), k_max=4,
        cutoff_upper=4.5, **kw)
    assert bool(got.overflow) and bool(want.overflow)
    assert int(got.mask.sum(1).max()) == 4


def test_cell_capacity_overflow():
    pos, box = _gas()
    got = tnb.cell_neighbor_matrix(
        torch.from_numpy(pos), box=torch.from_numpy(box), k_max=64,
        cutoff_upper=4.5, cells_per_dim=(3, 3, 3), cell_capacity=2)
    assert bool(got.overflow)


def test_reverse_slots_is_an_involution():
    pos, box = _gas(seed=3)
    nbr = tnb.brute_neighbor_matrix(
        torch.from_numpy(pos), box=torch.from_numpy(box), k_max=64,
        cutoff_upper=4.5, loop=True)
    rev = reverse_slots(nbr.idx, nbr.mask)
    np.testing.assert_array_equal(rev.numpy(), nbr.rev_slot.numpy())
    n, k = nbr.idx.shape
    rows = torch.arange(n)[:, None].expand(n, k)
    j, s = nbr.idx[nbr.mask], rev[nbr.mask]
    assert bool(nbr.mask[j, s].all())
    np.testing.assert_array_equal(nbr.idx[j, s].numpy(),
                                  rows[nbr.mask].numpy())
    np.testing.assert_array_equal(rev[j, s].numpy(),
                                  torch.arange(k).expand(n, k)[nbr.mask].numpy())
    want = jnb.brute_neighbor_matrix(
        jnp.asarray(pos), box=jnp.asarray(box), k_max=64, cutoff_upper=4.5,
        loop=True)
    np.testing.assert_array_equal(rev.numpy(), np.asarray(want.rev_slot))


def test_wrap_deltas_matches_jax():
    rng = np.random.RandomState(5)
    box = np.array([[9.0, 0.0, 0.0], [2.5, 8.0, 0.0], [-1.5, 3.0, 10.0]],
                   np.float32)
    delta = rng.uniform(-20.0, 20.0, (64, 3)).astype(np.float32)
    want = np.asarray(jnb.wrap_deltas(jnp.asarray(delta), jnp.asarray(box)))
    got = tnb.wrap_deltas(torch.from_numpy(delta), torch.from_numpy(box))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_neighbor_geometry_matches_jax():
    pos, box = _gas(n=60, L=10.0, seed=6)
    nbr = tnb.brute_neighbor_matrix(
        torch.from_numpy(pos), box=torch.from_numpy(box), k_max=48,
        cutoff_upper=4.5, loop=True)
    jn = jnb.NeighborMatrix(jnp.asarray(nbr.idx.int().numpy()),
                            jnp.asarray(nbr.mask.numpy()), None, None, None)
    wd, wdist = jnb.neighbor_geometry(jnp.asarray(pos), jn,
                                      box=jnp.asarray(box))
    gd, gdist = tnb.neighbor_geometry(torch.from_numpy(pos), nbr,
                                      box=torch.from_numpy(box))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-5)
    np.testing.assert_allclose(gdist.numpy(), np.asarray(wdist), atol=1e-5)


def test_pick_cell_grid_matches_jax():
    for bd, rc, n in (([63.07] * 3, 11.0, 25088), ([20.0, 25.0, 30.0], 5.5,
                                                   900), ([9.0] * 3, 5.0, 64)):
        assert tnb.pick_cell_grid(bd, rc, n) == jnb.pick_cell_grid(bd, rc, n)
