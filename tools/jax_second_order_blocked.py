"""What the JAX package does for a second derivative through each blocked
``custom_vjp`` (rows 8-15 of PERF.md §6): the cell-blocked neighbour sums,
the q-tier (both bases) and the windowed Coulomb, on the CPU with the
Pallas kernels in interpret mode at small sizes (120 atoms for the sums,
400 for the Coulomb).

For each op it differentiates ``<vjp_g(x), v>`` once more in ``x`` (what
force training does) and prints either the exception JAX raises and where,
or the numbers beside the port's plain PyTorch chains differentiated twice
in float64 (the plain neighbour sums and q-tier bodies; for the Coulomb,
the list path ``coulomb_cutoff_energy_w`` on a complete list).

    JAX_PLATFORMS=cpu python tools/jax_second_order_blocked.py
"""

import traceback

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torchmdnet_tpu.ops import cell_blocks as jcb
from torchmdnet_tpu.ops import pallas_blocked_mp as pbm
from torchmdnet_tpu.ops.neighbors import build_neighbor_matrix
from torchmdnet_tpu.ops.pallas_coulomb import (
    make_coulomb_windows, windowed_coulomb_energy)
from torchmdnet_tpu_torch.ops import blocked_mp as bm
from torchmdnet_tpu_torch.ops import blocked_q as bq
from torchmdnet_tpu_torch.ops import neighbors as tnb
from torchmdnet_tpu_torch.ops.coulomb import coulomb_cutoff_energy_w

N, RC, HI, K, F, T, R = 120, 3.7, 3.2, 40, 8, 24, 8


def second_order(name, fn_jax, fn_torch, xs, g, rng, mask=None):
    """Print what ``d/dx <vjp_g(x), v>`` gives in JAX, and against the
    plain chain ``fn_torch`` in float64 where JAX gives a number."""
    vs = [rng.randn(*x.shape).astype(np.float32) for x in xs]

    def inner(*a):
        _, vjp = jax.vjp(fn_jax, *a)
        return sum(jnp.vdot(p, jnp.asarray(v)) for p, v in
                   zip(vjp(jnp.asarray(g)), vs))

    try:
        want = jax.jit(jax.grad(inner, argnums=tuple(range(len(xs)))))(
            *map(jnp.asarray, xs))
    except Exception as exc:  # the finding is the exception itself
        frame = traceback.extract_tb(exc.__traceback__)[-1]
        where = frame.filename.split("site-packages/")[-1]
        msg = (str(exc).splitlines() or ["(no message)"])[0][:160]
        print(f"{name}: raises {type(exc).__name__}: {msg} "
              f"(at {where}:{frame.lineno})", flush=True)
        return
    leaves = [torch.tensor(x.astype(np.float64), requires_grad=True)
              for x in xs]
    first = torch.autograd.grad(fn_torch(*leaves), leaves,
                                torch.from_numpy(g).double(),
                                create_graph=True, allow_unused=True)
    s = sum((p * torch.from_numpy(v).double()).sum()
            for p, v in zip(first, vs) if p is not None)
    got = torch.autograd.grad(s, leaves, allow_unused=True)
    for i, (w, t) in enumerate(zip(want, got)):
        w = np.asarray(w)
        t = np.zeros_like(w) if t is None else t.numpy()
        if mask is not None and w.ndim == 2:
            w, t = w * mask[:, None], t * mask[:, None]
        err = np.abs(w - t).max() / max(np.abs(t).max(), 1e-30)
        print(f"{name}: a number; input {i}: max |jax| {np.abs(w).max():.3g}"
              f", max |plain| {np.abs(t).max():.3g}, error / max {err:.2e}",
              flush=True)


def blocked_sums():
    rng = np.random.RandomState(0)
    bd = np.full(3, (N / 0.08) ** (1 / 3), np.float32)
    pos = rng.uniform(0, bd[0], (N, 3)).astype(np.float32)
    spec = jcb.tune_cell_block_spec(jnp.asarray(pos), jnp.asarray(bd), RC,
                                    cap=8, rlh=64, precise=True)
    blocks = jcb.plan_cell_blocks(jnp.asarray(pos), jnp.asarray(bd), spec)
    am = np.asarray(blocks.mask_rows)
    pos_s = np.where(am[:, None], pos[np.minimum(np.asarray(blocks.perm),
                                                 N - 1)], 0.0)
    pos_s = pos_s.astype(np.float32)
    nbr = build_neighbor_matrix(
        jnp.asarray(pos_s), jnp.asarray((~am).astype(np.int32)),
        cutoff_upper=RC, loop=True, box=jnp.diag(jnp.asarray(bd)),
        atom_mask=jnp.asarray(am), strategy="brute", k_max=K)
    rel, _ = jcb.edge_rel(blocks, nbr.idx, nbr.mask, jnp.asarray(pos_s),
                          jnp.asarray(bd))
    idx, mask = np.array(nbr.idx), np.array(nbr.mask)
    delta = pos_s[:, None, :] - pos_s[idx]
    delta -= bd * np.round(delta / bd)
    d = np.where(mask, np.sqrt((delta ** 2).sum(-1)), 0.0).astype(np.float32)
    fm = ((d < HI) & mask).astype(np.float32)
    cw = (np.where(d < HI, 0.5 * (np.cos(d * np.pi / HI) + 1.0), 0.0)
          * mask).astype(np.float32)
    n_pad = idx.shape[0]

    def rnd(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    attr = rnd(n_pad, K, 3 * F) * mask[..., None]
    feats, g = rnd(n_pad, 9 * F), rnd(n_pad, 9 * F, scale=0.1)
    decay = 0.5 ** np.arange(T)[:, None]
    coeffs = (rng.randn(T, 3 * F) * decay).astype(np.float32)
    qco = (rng.randn(T, F) * 0.7 ** np.arange(T)[:, None]).astype(np.float32)
    u_i, u_j = rnd(n_pad, F, scale=0.5), rnd(n_pad, F, scale=0.5)
    w2, b2 = rnd(F, 2 * F, scale=F ** -0.5), rnd(2 * F, scale=0.1)
    w3, b3 = rnd(2 * F, 3 * F, scale=(2 * F) ** -0.5), rnd(3 * F, scale=0.1)
    ea = (np.cos(d[..., None] * rng.uniform(0.3, 1.5, R)
                 + rng.uniform(0, 3, R)) * mask[..., None]).astype(np.float32)
    w1a = rnd(R, F, scale=R ** -0.5)
    ti, tm = torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(mask)

    def t64(a):
        return torch.from_numpy(a).double()

    q_args = (nbr.mask, nbr.idx, nbr.rev_slot, rel, blocks.run_starts)
    tail = tuple(jnp.asarray(a) for a in (b2, w3, b3))
    second_order(
        "blocked_neighbor_sum_sym (rows 8-9)",
        lambda a, fe: pbm.blocked_neighbor_sum_sym(
            a, fe, rel, blocks.run_starts, spec, True),
        lambda a, fe: bm.neighbor_sum_ref(a, fe, ti, tm), [attr, feats], g,
        rng)
    second_order(
        "blocked_neighbor_sum_sym_cheb (rows 10-11)",
        lambda dd, fe: pbm.blocked_neighbor_sum_sym_cheb(
            jnp.asarray(coeffs), dd, jnp.asarray(fm), fe, rel,
            blocks.run_starts, spec, 0.0, HI, True),
        lambda dd, fe: bm.neighbor_sum_cheb_ref(t64(coeffs), dd, t64(fm), fe,
                                                ti, 0.0, HI), [d, feats], g,
        rng)
    second_order(
        "blocked_neighbor_sum_asym_q_tab (kernels A-B)",
        lambda dd, c, ui, uj, fe, w: pbm.blocked_neighbor_sum_asym_q_tab(
            dd, c, ui, uj, fe, *q_args, jnp.asarray(qco), w, *tail, spec,
            0.0, HI, True),
        lambda dd, c, ui, uj, fe, w: bq.q_fwd_ref(
            dd, c, tm, ti, ui, uj, fe, t64(qco), w, t64(b2), t64(w3),
            t64(b3), 0.0, HI), [d, cw, u_i, u_j, feats, w2], g, rng)
    second_order(
        "blocked_neighbor_sum_asym_q (kernels A-B, exact base)",
        lambda e, c, ui, uj, fe, w: pbm.blocked_neighbor_sum_asym_q(
            e, c, ui, uj, fe, *q_args, jnp.asarray(w1a), w, *tail, spec,
            True),
        lambda e, c, ui, uj, fe, w: bq.q_fwd_rbf_ref(
            e, c, tm, ti, ui, uj, fe, t64(w1a), w, t64(b2), t64(w3),
            t64(b3)), [ea, cw, u_i, u_j, feats, w2], g, rng)


def windowed_coulomb():
    n, c, rc, eps, factor = 400, 8, 4.0, 78.3, 7.199822
    rng = np.random.RandomState(5)
    bd = np.full(3, (n / 0.08) ** (1 / 3), np.float32)
    bd[2] *= 0.9
    pos = (rng.uniform(0, 1, (n, 3)) * bd).astype(np.float32)
    pj, bj = jnp.asarray(pos), jnp.asarray(bd)
    spec = jcb.tune_cell_block_spec(pj, bj, 3.5, cap=8)
    wspec = jcb.tune_stencil_window_spec(pj, bj, spec, rc)
    blocks = jcb.plan_cell_blocks(pj, bj, spec)
    win = jcb.plan_stencil_windows(pj, bj, spec, wspec)
    rows = np.array(blocks.mask_rows)
    pos_s = np.where(rows[:, None], pos[np.minimum(
        np.asarray(blocks.perm), n - 1)], 0.0).astype(np.float32)
    b = (rng.randn(spec.n_pad, c) * rows[:, None]).astype(np.float32)
    qw = rng.randn(c).astype(np.float32)
    ct = (rng.randn(spec.n_pad) * rows).astype(np.float32)
    cwin = make_coulomb_windows(win, wspec, blocks.mask_rows, bj, spec=spec)
    box = torch.diag(torch.from_numpy(bd)).double()
    nbr = tnb.build_neighbor_matrix(
        torch.from_numpy(pos_s), strategy="brute", k_max=96, cutoff_upper=rc,
        loop=False, box=box.float(), atom_mask=torch.from_numpy(rows))

    def plain(p, w, bb):
        e = coulomb_cutoff_energy_w(p, w, bb, nbr.idx, nbr.mask, rc, eps,
                                    factor, box)
        return e * torch.from_numpy(rows).double()

    second_order(
        "windowed_coulomb_energy (kernels C-D)",
        lambda p, w, bb: windowed_coulomb_energy(
            p, w, bb, cwin, spec, wspec, rc, eps, factor, True),
        plain, [pos_s, qw, b], ct, rng, mask=rows)


if __name__ == "__main__":
    torch.set_num_threads(2)
    blocked_sums()
    windowed_coulomb()
