"""Kernels A and B of the port (``ops/blocked_q.py``, plain versions on the
CPU) against the JAX package's ``blocked_neighbor_sum_asym_q_tab`` with a
precise spec, its Pallas kernels in interpret mode: the forward output,
the cotangents of d, cwfm, u_i, u_j and feats9, and zero weight
gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import ATOL, RTOL
from torchmdnet_tpu.ops.cell_blocks import (
    edge_rel, plan_cell_blocks, tune_cell_block_spec)
from torchmdnet_tpu.ops.neighbors import build_neighbor_matrix
from torchmdnet_tpu.ops.pallas_blocked_mp import (
    blocked_neighbor_sum_asym_q_tab as jax_op)
from torchmdnet_tpu_torch.ops import blocked_q

N, F, K, T = 180, 16, 32, 24
CUTOFF, SKIN = 3.0, 0.5
DIFF = ("d", "cwfm", "u_i", "u_j", "feats9")
WEIGHTS = ("coeffs", "w2", "b2", "w3", "b3")


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(11)
    L = (N / 0.08) ** (1.0 / 3.0)
    pos = rng.uniform(0, L, (N, 3)).astype(np.float32)
    bd = np.array([L, L, L], np.float32)
    spec = tune_cell_block_spec(jnp.asarray(pos), jnp.asarray(bd),
                                CUTOFF + SKIN, cap=8, precise=True)
    blocks = plan_cell_blocks(jnp.asarray(pos), jnp.asarray(bd), spec)
    perm = np.asarray(blocks.perm)
    am = np.asarray(blocks.mask_rows)
    pos_s = np.where(am[:, None], pos[np.minimum(perm, N - 1)], 0.0)
    nbr = build_neighbor_matrix(
        jnp.asarray(pos_s), jnp.where(jnp.asarray(am), 0, 1),
        strategy="brute", k_max=K, cutoff_upper=CUTOFF + SKIN, loop=True,
        box=jnp.diag(jnp.asarray(bd)), atom_mask=jnp.asarray(am))
    assert not bool(nbr.overflow)
    rel, eov = edge_rel(blocks, nbr.idx, nbr.mask, jnp.asarray(pos_s),
                        jnp.asarray(bd))
    assert not bool(eov)
    idx, mask = np.array(nbr.idx), np.array(nbr.mask)
    delta = pos_s[:, None, :] - pos_s[idx]
    delta -= bd * np.round(delta / bd)
    d = np.where(mask, np.sqrt((delta ** 2).sum(-1)), 0.0).astype(np.float32)
    cw = np.where(d < CUTOFF, 0.5 * (np.cos(d * np.pi / CUTOFF) + 1.0), 0.0)
    n_pad = spec.n_pad
    x = dict(
        d=d, cwfm=(cw * mask).astype(np.float32),
        u_i=rng.randn(n_pad, F).astype(np.float32) * 0.5,
        u_j=rng.randn(n_pad, F).astype(np.float32) * 0.5,
        feats9=rng.randn(n_pad, 9 * F).astype(np.float32),
        # a decaying series, as the fit of a smooth base(d) is
        coeffs=(rng.randn(T, F) * 0.7 ** np.arange(T)[:, None]).astype(np.float32),
        w2=(rng.randn(F, 2 * F) / np.sqrt(F)).astype(np.float32),
        b2=rng.randn(2 * F).astype(np.float32) * 0.1,
        w3=(rng.randn(2 * F, 3 * F) / np.sqrt(2 * F)).astype(np.float32),
        b3=rng.randn(3 * F).astype(np.float32) * 0.1)
    g = rng.randn(n_pad, 9 * F).astype(np.float32)
    assert 0 < (mask & (cw == 0)).sum() and (cw > 0).sum() > 10 * N

    def f_jax(*args):
        return jax_op(*args[:5], nbr.mask, nbr.idx, nbr.rev_slot, rel,
                      blocks.run_starts, *args[5:], spec, 0.0, CUTOFF,
                      interpret=True)

    args = [jnp.asarray(x[k]) for k in DIFF + WEIGHTS]
    out, vjp = jax.vjp(f_jax, *args)
    grads = vjp(jnp.asarray(g))
    want = {"out": np.asarray(out)}
    want.update({k: np.asarray(v) for k, v in zip(DIFF + WEIGHTS, grads)})

    t = {k: torch.tensor(v, requires_grad=True) for k, v in x.items()}
    out_t = blocked_q.blocked_neighbor_sum_asym_q_tab(
        *(t[k] for k in DIFF), torch.from_numpy(mask), torch.from_numpy(idx),
        torch.tensor(np.array(nbr.rev_slot)),
        *(t[k] for k in WEIGHTS), 0.0, CUTOFF)
    grads_t = torch.autograd.grad(out_t, [t[k] for k in DIFF + WEIGHTS],
                                  torch.from_numpy(g))
    got = {"out": out_t.detach().numpy()}
    got.update({k: v.numpy() for k, v in zip(DIFF + WEIGHTS, grads_t)})
    return want, got


@pytest.mark.parametrize("name", ("out",) + DIFF)
def test_blocked_q_matches_jax(case, name):
    want, got = case
    assert np.abs(want[name]).max() > 1e-2  # non-vacuous
    np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=ATOL)


def test_blocked_q_weights_get_zero_gradients(case):
    want, got = case
    for name in WEIGHTS:
        assert not np.any(want[name]) and not np.any(got[name]), name
