"""The port's blocked path end to end: TensorNet2 with the q-tier (kernels
A and B) and the windowed Coulomb head (kernels C and D), energy and
forces in the original atom order against the JAX package's blocked
precise path (its Pallas kernels in interpret mode); and a blocked MD
chunk with Coulomb windows against the same chunk with the skin-cached
Coulomb list."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import ATOL, RTOL, flatten_params, one_torch_thread
from torchmdnet_tpu.models.model import create_model as jax_create_model
from torchmdnet_tpu.ops import cell_blocks as jcb
from torchmdnet_tpu.ops.neighbors import (
    build_neighbor_matrix as jax_build_neighbors)
from torchmdnet_tpu.ops.pallas_coulomb import (
    make_coulomb_windows as jax_make_windows)
from torchmdnet_tpu_torch.md.integrators import make_md_step
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.ops import cell_blocks as tcb
from torchmdnet_tpu_torch.ops.neighbors import build_neighbor_matrix
from torchmdnet_tpu_torch.ops.windowed_coulomb import make_coulomb_windows
from torchmdnet_tpu_torch.utils.jax_params import params_from_jax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, CUTOFF, SKIN, K, RC = 216, 3.0, 0.5, 32, 4.0
ARGS = dict(
    model="tensornet2", embedding_dimension=16, num_layers=2, num_rbf=8,
    rbf_type="expnorm", trainable_rbf=False, activation="silu",
    cutoff_lower=0.0, cutoff_upper=CUTOFF, max_z=100, max_num_neighbors=K,
    derivative=True, prior_model=None, reduce_op="sum", precision=32,
    equivariance_invariance_group="O(3)", atom_filter=-1, remat=False,
    pallas_embedding=True, pallas_edge_mlp=True, q_dim=4, q_tab=24,
    output_model="ScalarPlusWeightedCoulomb", q_weights=[[1.0] * 4] * 3,
    coulomb_cutoff=RC)


def _system(seed=7):
    rng = np.random.RandomState(seed)
    L = (N / 0.08) ** (1.0 / 3.0)
    pos = rng.uniform(0, L, (N, 3)).astype(np.float32)
    z = rng.choice([1, 6, 8], N).astype(np.int32)
    return z, pos, np.diag([L, L, L]).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    z, pos, box = _system()
    bd = np.diag(box).copy()
    zj, pj, bj = jnp.asarray(z), jnp.asarray(pos), jnp.asarray(box)
    batch = jnp.zeros((N,), jnp.int32)
    q = jnp.zeros((1,), jnp.float32)
    # the MD geometry: the sort and the model list at cutoff + skin
    spec = jcb.tune_cell_block_spec(pj, jnp.diag(bj), CUTOFF + SKIN, cap=8,
                                    precise=True)
    wspec = jcb.tune_stencil_window_spec(pj, jnp.diag(bj), spec, RC + SKIN)
    jpot = jax_create_model(dict(ARGS, cell_block_spec=spec))
    variables = jpot.init(jax.random.PRNGKey(0), zj, pj, batch, num_mols=1,
                          box=bj, q=q)

    blocks = jcb.plan_cell_blocks(pj, jnp.diag(bj), spec)
    perm_safe = jnp.minimum(blocks.perm, N - 1)
    am_s = blocks.mask_rows
    pos_s = jnp.where(am_s[:, None], pj[perm_safe], 0.0)
    zs = jnp.where(am_s, zj[perm_safe], 0)
    batchs = jnp.where(am_s, 0, 1)
    nbr = jax_build_neighbors(pos_s, batchs, strategy="brute", k_max=K,
                              cutoff_upper=CUTOFF + SKIN, loop=True, box=bj,
                              atom_mask=am_s)
    assert not bool(nbr.overflow)
    rel, eov = jcb.edge_rel(blocks, nbr.idx, nbr.mask, pos_s, jnp.diag(bj))
    assert not bool(eov)
    jwin = jcb.plan_stencil_windows(pj, jnp.diag(bj), spec, wspec)
    assert not bool(jwin.overflow)
    cwin_j = jax_make_windows(jwin, wspec, am_s, jnp.diag(bj), spec=spec)

    def e_jax(p):
        p_s = jcb.permute_rows(p, perm_safe, am_s, blocks.inv_perm)
        return jnp.sum(jpot.energy(
            variables, zs, p_s, batchs, num_mols=1, box=bj, q=q, nbr=nbr,
            blocked=jcb.BlockedMP(rel, blocks.run_starts),
            coulomb_win=(cwin_j, spec, wspec)))

    e_j, g_j = jax.jit(jax.value_and_grad(e_jax))(pj)

    tspec = tcb.CellBlockSpec(**spec._asdict())
    tpot = create_model(dict(ARGS, cell_block_spec=tspec), device="cpu")
    tpot.module.load_state_dict(
        params_from_jax(flatten_params(variables["params"])), strict=True)
    return dict(z=z, pos=pos, box=box, bd=bd, tpot=tpot, tspec=tspec,
                twspec=tcb.StencilWindowSpec(**wspec._asdict()),
                e_jax=float(e_j), f_jax=-np.asarray(g_j))


def test_blocked_energy_and_forces_match_jax(case):
    pos, bd, tspec = case["pos"], case["bd"], case["tspec"]
    pt = torch.from_numpy(pos)
    blocks = tcb.plan_cell_blocks(pt, bd, tspec)
    perm_safe = torch.clamp(blocks.perm, max=N - 1)
    am_s = blocks.mask_rows
    box = torch.from_numpy(case["box"])
    pos_s = torch.where(am_s[:, None], pt[perm_safe], 0.0)
    zs = torch.where(am_s, torch.from_numpy(case["z"]).long()[perm_safe], 0)
    batchs = (~am_s).long()
    nbr = build_neighbor_matrix(pos_s, batchs, strategy="brute", k_max=K,
                                cutoff_upper=CUTOFF + SKIN, loop=True,
                                box=box, atom_mask=am_s)
    win = tcb.plan_stencil_windows(pt, bd, tspec, case["twspec"])
    cwin = make_coulomb_windows(win, am_s, bd)
    p = pt.clone().requires_grad_(True)
    y = case["tpot"].module(
        zs, tcb.permute_rows(p, perm_safe, am_s, blocks.inv_perm), batchs,
        num_mols=1, box=box, q=torch.zeros(1), nbr=nbr, blocked=True,
        coulomb_win=cwin)
    (g,) = torch.autograd.grad(y.sum(), p)
    f = -g.numpy()
    assert np.abs(case["f_jax"]).max() > 1e-2  # non-vacuous
    np.testing.assert_allclose(float(y.detach()), case["e_jax"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(f, case["f_jax"], rtol=RTOL, atol=ATOL)


def test_md_windowed_coulomb_matches_list_path(case):
    z, pos, tpot, tspec = case["z"], case["pos"], case["tpot"], case["tspec"]
    masses = np.where(z == 1, 1.008, 12.011)
    kw = dict(dt=0.2, num_mols=1, box=case["box"], q=torch.zeros(1),
              rebuild_every=3, skin=SKIN, temperature=None,
              cell_block_spec=tspec)
    init_l, chunk_l, _ = make_md_step(tpot, z, np.zeros(N), masses, **kw)
    init_w, chunk_w, energy_w = make_md_step(
        tpot, z, np.zeros(N), masses, coulomb_window_spec="auto", **kw)
    sl, sw = init_l(pos, seed=1), init_w(pos, seed=1)
    assert sl.cnbr_idx is not None and sw.cnbr_idx is None
    assert sw.cwin is not None and sl.cwin is None
    np.testing.assert_allclose(sw.force.numpy(), sl.force.numpy(),
                               rtol=RTOL, atol=ATOL)
    # the blocked MD forces are the model's forces in the original order
    np.testing.assert_allclose(sw.force.numpy(), case["f_jax"],
                               rtol=RTOL, atol=ATOL)
    sl, sw = chunk_l(sl), chunk_w(sw)
    assert sw.step == sl.step == 3
    assert not bool(sw.overflow) and not bool(sl.overflow)
    assert torch.isfinite(sw.pos).all()
    np.testing.assert_allclose(sw.pos.numpy(), sl.pos.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(sw.force.numpy(), sl.force.numpy(),
                               rtol=RTOL, atol=ATOL)
    e = energy_w(sw.pos, sw)
    np.testing.assert_allclose(e.numpy(), sw.energy.numpy(), rtol=1e-6)


def test_blocked_md_overflow_is_sticky():
    z, pos, box = _system(seed=3)
    spec = tcb.make_cell_block_spec(np.diag(box), CUTOFF + SKIN, N, cap=8)
    pot = create_model(dict(ARGS, cell_block_spec=spec), device="cpu")
    init, chunk, _ = make_md_step(
        pot, z, np.zeros(N), np.ones(N) * 12.0, dt=0.2, box=box,
        rebuild_every=2, skin=SKIN, k_max=4, cell_block_spec=spec,
        coulomb_window_spec="auto")  # too few slots: overflow
    st = chunk(init(pos, seed=2))
    assert bool(st.overflow) and st.step == 2
    st = chunk(st)
    assert bool(st.overflow) and st.step == 4
    assert torch.isfinite(st.pos).all() and torch.isfinite(st.energy).all()
