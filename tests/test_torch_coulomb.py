"""The port's cutoff Coulomb energy (list path, row-chunked, gather-only
backward) against ``coulomb_cutoff_energy_w`` of the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from torchmdnet_tpu.ops.coulomb import coulomb_cutoff_energy_w as jax_ccew
from torchmdnet_tpu.ops.neighbors import brute_neighbor_matrix
from torchmdnet_tpu_torch.ops import message_passing
from torchmdnet_tpu_torch.ops.coulomb import coulomb_cutoff_energy_w

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = ATOL = 1e-4
FACTOR = 0.5 * 27.211386024367243 * 0.5291772105638411 / 12.0


def _system(n=80, L=13.0, c=12, seed=0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0.0, L, (n, 3)).astype(np.float32)
    box = np.diag([L, L, L]).astype(np.float32)
    b = (rng.randn(n, c) * 0.3).astype(np.float32)
    w = rng.uniform(0.5, 1.5, c).astype(np.float32)
    # a skin-padded list (6 Å) for a 5 Å cutoff, as MD passes
    nbr = brute_neighbor_matrix(jnp.asarray(pos), box=jnp.asarray(box),
                                k_max=128, cutoff_upper=6.0)
    assert not bool(nbr.overflow)
    return pos, box, b, w, np.array(nbr.idx), np.array(nbr.mask)


@pytest.mark.parametrize("chunked", [False, True])
def test_energy_and_gradients_match_jax(chunked, monkeypatch):
    if chunked:  # force several row chunks at this small size
        monkeypatch.setattr(message_passing, "CHUNK_BUDGET_BYTES", 8 * 128 * 16 * 4)
    pos, box, b, w, idx, mask = _system()
    ct = np.random.RandomState(1).randn(len(pos)).astype(np.float32)

    def jf(p, w_, b_):
        return jax_ccew(p, w_, b_, jnp.asarray(idx), jnp.asarray(mask), 5.0,
                        78.3, FACTOR, jnp.asarray(box))

    e_want, vjp = jax.vjp(jf, jnp.asarray(pos), jnp.asarray(w), jnp.asarray(b))
    dpos_w, dw_w, db_w = vjp(jnp.asarray(ct))

    p_t, w_t, b_t = (torch.from_numpy(a).requires_grad_(True)
                     for a in (pos, w, b))
    e_got = coulomb_cutoff_energy_w(p_t, w_t, b_t, torch.from_numpy(idx).long(),
                                    torch.from_numpy(mask), 5.0, 78.3, FACTOR,
                                    torch.from_numpy(box))
    e_got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(e_got.detach().numpy(), np.asarray(e_want),
                               rtol=RTOL, atol=ATOL)
    for got, want, name in ((p_t.grad, dpos_w, "pos"), (w_t.grad, dw_w, "w"),
                            (b_t.grad, db_w, "b")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_position_gradient_matches_autograd_of_the_plain_sum():
    """The hand-derived backward against autograd through an unchunked
    pair sum (small enough to hold here)."""
    from torchmdnet_tpu_torch.ops.coulomb import g_kernel
    from torchmdnet_tpu_torch.ops.neighbors import wrap_deltas

    pos, box, b, w, idx, mask = _system(n=48, L=11.0, seed=2)
    p = torch.from_numpy(pos).requires_grad_(True)
    bt, wt = torch.from_numpy(b), torch.from_numpy(w)
    it, mt = torch.from_numpy(idx).long(), torch.from_numpy(mask)
    delta = wrap_deltas(p[:, None, :] - p[it], torch.from_numpy(box))
    d2 = (delta * delta).sum(-1)
    valid = mt & (d2 > 0)
    d = torch.sqrt(torch.where(valid, d2, 1.0))
    valid = valid & (d < 5.0)
    g = torch.where(valid, g_kernel(d, 5.0, 78.3, FACTOR), 0.0)
    e_ref = (g * ((wt * bt)[:, None, :] * bt[it]).sum(-1)).sum()
    (want,) = torch.autograd.grad(e_ref, p)
    p2 = torch.from_numpy(pos).requires_grad_(True)
    e = coulomb_cutoff_energy_w(p2, wt, bt, it, mt, 5.0, 78.3, FACTOR,
                                torch.from_numpy(box)).sum()
    (got,) = torch.autograd.grad(e, p2)
    np.testing.assert_allclose(float(e.detach()), float(e_ref.detach()),
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
