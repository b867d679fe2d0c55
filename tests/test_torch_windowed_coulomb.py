"""Kernels C and D of the port (``ops/windowed_coulomb.py``, plain versions
on the CPU) against the JAX package's ``windowed_coulomb_energy`` (its
Pallas kernels in interpret mode) and against the port's list-path
``coulomb_cutoff_energy_w`` on a complete neighbor list: the per-row
energy and the gradients for pos, qw and b, with ghost rows silent; and
the CUDA kernels' launch plan and operand checks, which take every
channel count and stencil radius."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import ATOL, RTOL, one_torch_thread  # noqa: F401
from torchmdnet_tpu.ops import cell_blocks as jcb
from torchmdnet_tpu.ops.pallas_coulomb import (
    make_coulomb_windows as jax_make_windows)
from torchmdnet_tpu.ops.pallas_coulomb import (
    windowed_coulomb_energy as jax_energy)
from torchmdnet_tpu_torch.ops import cell_blocks as tcb
from torchmdnet_tpu_torch.ops.coulomb import coulomb_cutoff_energy_w
from torchmdnet_tpu_torch.ops.neighbors import build_neighbor_matrix
from torchmdnet_tpu_torch.ops.tc_tile import SMEM_LIMIT
from torchmdnet_tpu_torch.ops.windowed_coulomb import (
    CoulombWindows, check_operands, make_coulomb_windows, rows_floats,
    wc_bwd_cuda, wc_fwd_cuda, wc_plan, wc_plan_error, window_partners,
    windowed_coulomb_energy)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, C = 400, 8
RC, EPS, FACTOR = 4.0, 78.3, 7.199822
NAMES = ("e", "pos", "qw", "b")


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(5)
    bd = np.array([(N / 0.08) ** (1.0 / 3.0)] * 3, np.float32)
    bd[2] *= 0.9  # non-cubic; the z-cut wraps for blocks near the faces
    pos = (rng.uniform(0, 1, (N, 3)) * bd).astype(np.float32)
    pj, bj = jnp.asarray(pos), jnp.asarray(bd)
    spec = jcb.tune_cell_block_spec(pj, bj, 3.5, cap=8)
    wspec = jcb.tune_stencil_window_spec(pj, bj, spec, RC)
    assert wspec.s == 1 and min(spec.nx, spec.ny) > 3  # a partial stencil
    blocks = jcb.plan_cell_blocks(pj, bj, spec)
    jwin = jcb.plan_stencil_windows(pj, bj, spec, wspec)
    assert not bool(jwin.overflow)
    mask_rows = np.array(blocks.mask_rows)
    perm = np.asarray(blocks.perm)
    pos_s = np.where(mask_rows[:, None], pos[np.minimum(perm, N - 1)], 0.0)
    pos_s = pos_s.astype(np.float32)
    b = rng.randn(spec.n_pad, C).astype(np.float32)  # ghost rows: garbage
    qw = rng.randn(C).astype(np.float32)
    ct = rng.randn(spec.n_pad).astype(np.float32)
    x = dict(pos=pos_s, qw=qw, b=b)

    cwin_j = jax_make_windows(jwin, wspec, blocks.mask_rows, bj, spec=spec)

    def f_jax(p, w, bb):
        return jax_energy(p, w, bb, cwin_j, spec, wspec, RC, EPS, FACTOR,
                          True)

    e, vjp = jax.vjp(f_jax, *(jnp.asarray(x[k]) for k in NAMES[1:]))
    want = dict(zip(NAMES, [np.asarray(e)]
                    + [np.asarray(v) for v in vjp(jnp.asarray(ct))]))

    tspec = tcb.CellBlockSpec(**spec._asdict())
    twspec = tcb.StencilWindowSpec(**wspec._asdict())
    win = tcb.plan_stencil_windows(torch.from_numpy(pos), bd, tspec, twspec)
    cwin = make_coulomb_windows(win, torch.from_numpy(mask_rows), bd)
    t = {k: torch.tensor(v, requires_grad=True) for k, v in x.items()}
    e_t = windowed_coulomb_energy(t["pos"], t["qw"], t["b"], cwin, RC, EPS,
                                  FACTOR)
    grads = torch.autograd.grad(e_t, [t[k] for k in NAMES[1:]],
                                torch.from_numpy(ct))
    got = dict(zip(NAMES, [e_t.detach().numpy()]
                   + [g.numpy() for g in grads]))

    # the list path on a complete list in the same row space
    pl = {k: torch.tensor(v, requires_grad=True) for k, v in x.items()}
    nbr = build_neighbor_matrix(
        pl["pos"].detach(), strategy="brute", k_max=96, cutoff_upper=RC,
        loop=False, box=torch.diag(torch.from_numpy(bd)),
        atom_mask=torch.from_numpy(mask_rows))
    assert not bool(nbr.overflow)
    e_l = coulomb_cutoff_energy_w(pl["pos"], pl["qw"], pl["b"], nbr.idx,
                                  nbr.mask, RC, EPS, FACTOR,
                                  torch.diag(torch.from_numpy(bd)))
    e_l = e_l * torch.from_numpy(mask_rows)
    grads_l = torch.autograd.grad(e_l, [pl[k] for k in NAMES[1:]],
                                  torch.from_numpy(ct))
    listed = dict(zip(NAMES, [e_l.detach().numpy()]
                      + [g.numpy() for g in grads_l]))
    return want, got, listed, mask_rows, cwin


@pytest.mark.parametrize("name", NAMES)
def test_windowed_coulomb_matches_jax(case, name):
    want, got, _, _, _ = case
    assert np.abs(want[name]).max() > 1e-2  # non-vacuous
    np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_windowed_coulomb_matches_list_path(case, name):
    _, got, listed, _, _ = case
    np.testing.assert_allclose(got[name], listed[name], rtol=RTOL, atol=ATOL)


def test_ghost_rows_are_silent(case):
    _, got, _, mask_rows, cwin = case
    ghost = ~mask_rows
    assert ghost.sum() > 0
    for name in ("e", "pos", "b"):
        assert not np.any(got[name][ghost]), name
    rows, live = window_partners(cwin)
    assert live.any() and not live[~cwin.row_valid[rows]].any()


# ------------------------------------------------------------------------
# launch plan of the CUDA kernels (pure Python; no kernel runs here)

PLAN_CAPS, PLAN_CHANNELS, PLAN_STENCILS = (8, 16, 32), (1, 8, 20, 48, 132,
                                                        200), (1, 2, 5, 6)


@pytest.mark.parametrize("cap", PLAN_CAPS)
@pytest.mark.parametrize("c", PLAN_CHANNELS)
def test_wc_plan_fits_every_width(cap, c):
    """Every (cap, C, S) of the grid launches: rows in one or two 16-row
    tiles a pass, channels in the fewest chunks of at most 64 (a multiple
    of 8 each), and a block's whole working set in its shared memory (the
    three-stage ring, D's split (qw⊙b_i) rows, the pair scratch, the piece
    table): no tile goes to device memory; the only scratch there is the
    rows the ring stages."""
    for s in PLAN_STENCILS:
        nsc = (2 * s + 1) ** 2
        assert wc_plan_error(cap, c, nsc) is None
        for bwd in (False, True):
            p = wc_plan(cap, c, nsc, bwd)
            assert p.mt == (2 if cap > 16 else 1)
            assert 16 * p.mt * (p.passes - 1) < cap <= 16 * p.mt * p.passes
            assert 1 <= p.nt <= 8 and p.chunks == -(-c // 64)
            assert 8 * p.nt * (p.chunks - 1) < c <= 8 * p.nt * p.chunks
            ring = 3 * 128 * (4 + 8 * p.nt) * 4
            wb = 2 * 16 * p.mt * (8 * p.nt + 4) * 4 if bwd else 0
            pairs = (2 if bwd else 1) * 128 * 8 * 4
            table = (2 * (2 * nsc) + 1 + 8) * 4
            assert p.smem == ring + wb + pairs + table <= SMEM_LIMIT
            # the staged rows: a 128-row stage of no atom after each chunk
            assert rows_floats(1000, p) == p.chunks * 1128 * (4 + 8 * p.nt)


def test_wc_plan_error_names_what_cannot_launch():
    assert "must be >= 1" in wc_plan_error(0, 48, 25)
    assert "must be >= 1" in wc_plan_error(16, 0, 25)
    assert wc_plan_error(32, 64, 79 ** 2) is None  # S = 39
    assert "shared memory" in wc_plan_error(32, 64, 81 ** 2)  # S = 40


def _operands(c, s, cap=16, nb=3):
    """CPU operands of a kernel C/D launch with ``c`` channels and a ±s
    stencil (their values do not matter to the checks)."""
    n, nsc = nb * cap, (2 * s + 1) ** 2
    bounds = [torch.zeros((nb, nsc), dtype=torch.int64) for _ in range(4)]
    cwin = CoulombWindows(*bounds, torch.ones(n, dtype=torch.bool),
                          torch.full((3,), 30.0), (30.0,) * 3)
    return (torch.zeros((n, 3)), torch.zeros((n, c)), torch.zeros(n),
            torch.ones(c), cwin)


@pytest.mark.parametrize("c,s", [(132, 6), (37, 2)])
def test_wrapper_takes_wide_channels_and_stencils(c, s):
    """C > 128, C not a multiple of 4 and S > 5 pass the wrappers'
    checks (the old kernels refused C > 128 and S > 5)."""
    pos, b, ct, qw, cwin = _operands(c, s)
    check_operands("windowed_coulomb_bwd", pos, b, cwin, dict(ct=ct, qw=qw))
    with pytest.raises(ValueError, match="shape"):
        check_operands("windowed_coulomb_fwd", pos[1:], b, cwin, {})


@pytest.mark.parametrize("bwd", [False, True])
def test_cuda_wrappers_refuse_cpu_tensors(bwd):
    pos, b, ct, qw, cwin = _operands(48, 2)
    with pytest.raises(ValueError, match="expects CUDA tensors"):
        if bwd:
            wc_bwd_cuda(pos, b, ct, qw, cwin, RC, EPS, FACTOR)
        else:
            wc_fwd_cuda(pos, b, cwin, RC, EPS, FACTOR)
