"""The port's cell-blocked sort and stencil-window pieces against the JAX
package's ``ops/cell_blocks.py``, and the exact pieces against a
brute-force pair list."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from torchmdnet_tpu.ops import cell_blocks as jcb
from torchmdnet_tpu_torch.ops import cell_blocks as tcb

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _system(n=216, density=0.08, seed=0):
    rng = np.random.RandomState(seed)
    L = (n / density) ** (1.0 / 3.0)
    pos = rng.uniform(0, L, (n, 3)).astype(np.float32)
    return pos, np.array([L, L, L], np.float32)


@pytest.mark.parametrize("cap", [8, 16])
def test_spec_fields_equal_jax(cap):
    pos, bd = _system()
    want = jcb.make_cell_block_spec(bd, 3.5, len(pos), cap=cap)
    got = tcb.make_cell_block_spec(bd, 3.5, len(pos), cap=cap)
    assert got._asdict() == want._asdict()
    tuned = jcb.tune_cell_block_spec(jnp.asarray(pos), jnp.asarray(bd), 3.5,
                                     cap=cap)
    port = tcb.tune_cell_block_spec(torch.from_numpy(pos), bd, 3.5, cap=cap)
    for key in ("nx", "ny", "nzf", "cap", "n_pad", "cut_bins"):
        assert getattr(port, key) == getattr(tuned, key), key
    assert tcb.CellBlockSpec(**tuned._asdict()) == tuned  # converts as is
    wj = jcb.tune_stencil_window_spec(jnp.asarray(pos), jnp.asarray(bd),
                                      tuned, 4.5)
    wt = tcb.tune_stencil_window_spec(pos, bd, port, 4.5)
    assert (wt.s, wt.cut_bins) == (wj.s, wj.cut_bins)


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_is_identical_to_jax(seed):
    pos, bd = _system(seed=seed)
    spec = tcb.make_cell_block_spec(bd, 3.5, len(pos), cap=8)
    jb = jcb.plan_cell_blocks(jnp.asarray(pos), jnp.asarray(bd),
                              jcb.CellBlockSpec(**spec._asdict()))
    tb = tcb.plan_cell_blocks(torch.from_numpy(pos), bd, spec)
    np.testing.assert_array_equal(tb.perm.numpy(), np.asarray(jb.perm))
    np.testing.assert_array_equal(tb.inv_perm.numpy(), np.asarray(jb.inv_perm))
    np.testing.assert_array_equal(tb.mask_rows.numpy(),
                                  np.asarray(jb.mask_rows))


def _window_sets(win, spec, mask_rows):
    """Per block, the multiset of real rows its pieces cover."""
    out = []
    a1, e1, a2, e2 = (t.numpy() for t in win)
    for b in range(spec.n_blocks):
        rows = np.concatenate([np.arange(a1[b, s], e1[b, s])
                               for s in range(a1.shape[1])]
                              + [np.arange(a2[b, s], e2[b, s])
                                 for s in range(a1.shape[1])])
        out.append(rows[mask_rows[rows]])
    return out


@pytest.mark.parametrize("n,rc,cap", [(216, 4.5, 8), (400, 4.0, 16)])
def test_exact_pieces_cover_every_pair_once(n, rc, cap):
    pos, bd = _system(n=n, seed=3)
    spec = tcb.make_cell_block_spec(bd, 3.5, n, cap=cap)
    wspec = tcb.tune_stencil_window_spec(pos, bd, spec, rc)
    pt = torch.from_numpy(pos)
    blocks = tcb.plan_cell_blocks(pt, bd, spec)
    win = tcb.plan_stencil_windows(pt, bd, spec, wspec)
    # the exact pieces are the JAX planner's before its 8-row floor; away
    # from the floor and the run merge they are the same bounds
    jw = jcb.plan_stencil_windows(
        jnp.asarray(pos), jnp.asarray(bd), jcb.CellBlockSpec(**spec._asdict()),
        jcb.StencilWindowSpec(**wspec._asdict()))
    np.testing.assert_array_equal(win.e1.numpy(), np.asarray(jw.e1))

    mask_rows = blocks.mask_rows.numpy()
    perm = blocks.perm.numpy()
    pos_s = np.where(mask_rows[:, None], pos[np.minimum(perm, n - 1)], 0.0)
    delta = pos_s[:, None, :] - pos_s[None, :, :]
    delta -= bd * np.round(delta / bd)
    d2 = (delta ** 2).sum(-1)
    inside = (d2 < rc * rc) & (d2 > 0)
    inside &= mask_rows[:, None] & mask_rows[None, :]
    sets = _window_sets(win, spec, mask_rows)
    n_pairs = 0
    for b, rows in enumerate(sets):
        assert len(np.unique(rows)) == len(rows), f"block {b}: a row twice"
        covered = np.zeros(spec.n_pad, bool)
        covered[rows] = True
        for r in range(b * spec.cap, (b + 1) * spec.cap):
            partners = np.nonzero(inside[r])[0]
            n_pairs += len(partners)
            assert covered[partners].all(), f"row {r}: a partner missed"
    assert n_pairs > 10 * n  # non-vacuous


def test_permute_rows_backward_is_a_gather():
    pos, bd = _system(seed=4)
    spec = tcb.make_cell_block_spec(bd, 3.5, len(pos), cap=8)
    blocks = tcb.plan_cell_blocks(torch.from_numpy(pos), bd, spec)
    perm_safe = torch.clamp(blocks.perm, max=len(pos) - 1)
    x = torch.randn(len(pos), 3, dtype=torch.float32, requires_grad=True)
    y = tcb.permute_rows(x, perm_safe, blocks.mask_rows, blocks.inv_perm)
    assert torch.equal(y[blocks.inv_perm], x.detach())
    assert (y[~blocks.mask_rows] == 0).all()
    g = torch.randn(spec.n_pad, 3)
    (dx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(dx, g[blocks.inv_perm])
    # the gather backward equals autograd's scatter through plain indexing
    x2 = x.detach().clone().requires_grad_(True)
    y2 = torch.where(blocks.mask_rows[:, None], x2[perm_safe], 0.0)
    (dx2,) = torch.autograd.grad(y2, x2, g)
    torch.testing.assert_close(dx, dx2, rtol=0, atol=1e-6)


def test_blocks_and_windows_share_one_sort(monkeypatch):
    pos, bd = _system(seed=5)
    spec = tcb.make_cell_block_spec(bd, 3.5, len(pos), cap=8)
    wspec = tcb.tune_stencil_window_spec(pos, bd, spec, 4.5)
    pt = torch.from_numpy(pos)
    want_b = tcb.plan_cell_blocks(pt, bd, spec)
    want_w = tcb.plan_stencil_windows(pt, bd, spec, wspec)
    sorts = []
    real_sort = tcb._sort
    monkeypatch.setattr(tcb, "_sort",
                        lambda *a: sorts.append(1) or real_sort(*a))
    blocks, win = tcb.plan_cell_blocks_and_windows(pt, bd, spec, wspec)
    assert len(sorts) == 1
    for got, want in zip(blocks + win, want_b + want_w):
        assert torch.equal(got, want)
    assert tcb.plan_cell_blocks_and_windows(pt, bd, spec)[1] is None
