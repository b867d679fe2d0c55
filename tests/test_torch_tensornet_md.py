"""The port's TensorNet pieces around the model against the JAX package:
the symmetric packed neighbor sum of its interactions, and a short NVE
run of ``make_md_step`` on the tabulated model (the dhfr default)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import (ATOL, RTOL, TENSORNET_ARGS, jax_and_port,
                          lattice_system, one_torch_thread, to_np)
from torchmdnet_tpu.md.integrators import make_md_step as jax_make_md_step
from torchmdnet_tpu.ops.message_passing import (
    packed_neighbor_sum_sym as jax_pns_sym)
from torchmdnet_tpu_torch.md.integrators import make_md_step
from torchmdnet_tpu_torch.ops.message_passing import packed_neighbor_sum_sym
from torchmdnet_tpu_torch.ops.neighbors import (
    build_neighbor_matrix, neighbor_geometry)
import pytest

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_packed_neighbor_sum_sym_matches_jax():
    """Forward and both cotangents on edge-symmetric weights (a function
    of the distance) over the lattice's neighbor matrix."""
    z, pos, box = lattice_system(n_side=3, spacing=2.2, seed=4)
    p, b = torch.from_numpy(pos), torch.from_numpy(box)
    nbr = build_neighbor_matrix(p, strategy="brute", k_max=32,
                                cutoff_upper=4.0, loop=True, box=b)
    assert not bool(nbr.overflow)
    _, dist = neighbor_geometry(p, nbr, box=b)
    f = 4
    attr = torch.sin(dist[..., None] * torch.arange(1, 3 * f + 1) * 0.7)
    attr = attr * nbr.mask[..., None]
    rng = np.random.RandomState(2)
    feats = rng.randn(len(z), 9 * f).astype(np.float32)
    g = rng.randn(len(z), 9 * f).astype(np.float32)
    a_t = attr.detach().clone().requires_grad_(True)
    f_t = torch.from_numpy(feats).requires_grad_(True)
    out = packed_neighbor_sum_sym(a_t, f_t, nbr.idx, nbr.rev_slot,
                                  nbr.mask)
    out.backward(torch.from_numpy(g))
    idx, rev, mask = (jnp.asarray(t.numpy()) for t in
                      (nbr.idx, nbr.rev_slot, nbr.mask))
    want, vjp = jax.vjp(lambda a, x: jax_pns_sym(a, x, idx, rev, mask),
                        jnp.asarray(attr.numpy()), jnp.asarray(feats))
    da, dx = vjp(jnp.asarray(g))
    for got, ref in ((out, want), (a_t.grad, da), (f_t.grad, dx)):
        np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


def test_nve_steps_match_jax():
    """Six NVE steps of the tabulated model (the dhfr default), brute
    neighbors rebuilt every 3 steps with a 1 Å skin."""
    z, pos, box = lattice_system(n_side=4, spacing=3.2, seed=1)
    masses = np.where(z == 1, 1.008, 12.011)
    args = dict(TENSORNET_ARGS, tabulated_edge_mlp=128)
    jpot, variables, tpot, _ = jax_and_port(args, z, pos, box)
    kw = dict(dt=0.5, num_mols=1, rebuild_every=3, skin=1.0,
              temperature=None, neighbor_strategy="brute")
    batch = np.zeros(len(z), np.int32)
    j_init, j_chunk, _ = jax_make_md_step(
        jpot, variables, jnp.asarray(z), jnp.asarray(batch), masses,
        box=jnp.asarray(box), **kw)
    t_init, t_chunk, _ = make_md_step(tpot, z, batch, masses, box=box, **kw)
    js, ts = j_init(pos), t_init(pos)
    for _ in range(2):
        js, ts = j_chunk(js), t_chunk(ts)
    assert ts.step == int(js.step) == 6
    assert not bool(ts.overflow) and not bool(js.overflow)
    for got, want in ((ts.pos, js.pos), (ts.vel, js.vel),
                      (ts.force, js.force)):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
