"""The scatter-free force transpose of the port against the JAX package:
``gather_pair_deltas`` (forward, VJP and second order) on a brute list
with ghost rows, on a triclinic periodic list and on a column-partitioned
list in cell-blocked order; the reverse gather and the asymmetric packed
sum at the second order, which the port lacked before (its reverse
gather transposed to an ``index_put`` scatter, and the asymmetric sum's
backward was not differentiable); and a TensorNet2 whose forces are the
same with and without ``rev_slot`` and whose force-loss gradient matches
central differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    RTOL, SMALL_ARGS, blocked_system, grouped_list_kwargs, lattice_system,
    one_torch_thread, open_molecule)
from torchmdnet_tpu.ops import message_passing as jmp
from torchmdnet_tpu.ops import neighbors as jnb
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.models.tensornet import (
    edge_message_passing, pack9, split9)
from torchmdnet_tpu_torch.ops import message_passing as tmp
from torchmdnet_tpu_torch.ops import neighbors as tnb
from torchmdnet_tpu_torch.ops.cell_blocks import (
    plan_cell_blocks, tune_cell_block_spec)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TRICLINIC = np.array([[9.0, 0.0, 0.0], [2.5, 8.0, 0.0], [-1.5, 3.0, 10.0]],
                     np.float32)


def _close(got, want, tol=RTOL):
    """Within ``tol`` of the largest entry of ``want``."""
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _graph_names(t):
    """The autograd node names of ``t``'s graph."""
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def _scatters(t):
    return sorted(n for n in _graph_names(t)
                  if "IndexPut" in n or "Scatter" in n or "IndexAdd" in n)


def _layout(name):
    """``(pos, box, batch, nbr)``: positions (float32), the box or None,
    the molecule of each row (ghost rows in molecule 1) and the port's
    list, its ``rev_slot`` filled."""
    if name == "brute_open":
        _, pos, _ = open_molecule(n_atoms=20, seed=4)
        ghost = 40.0 + np.random.RandomState(2).uniform(0, 5, (4, 3))
        pos = np.concatenate([pos, ghost]).astype(np.float32)
        batch = (np.arange(len(pos)) >= 20).astype(np.int64)
        box = None
        nbr = tnb.build_neighbor_matrix(
            torch.from_numpy(pos), torch.from_numpy(batch), k_max=24,
            cutoff_upper=4.0, loop=True,
            atom_mask=torch.from_numpy(batch == 0))
    elif name == "brute_triclinic":
        rng = np.random.RandomState(3)
        frac = rng.uniform(0, 1, (48, 3))
        pos = (frac @ TRICLINIC).astype(np.float32)
        batch = np.zeros(len(pos), np.int64)
        box = TRICLINIC
        nbr = tnb.build_neighbor_matrix(
            torch.from_numpy(pos), k_max=48, cutoff_upper=4.0, loop=False,
            box=torch.from_numpy(box))
    else:  # column_partitioned, in cell-blocked order with ghost rows
        p0, bd = blocked_system(n=120, seed=7)
        cutoff = 3.7
        spec = tune_cell_block_spec(p0, bd, cutoff, cap=8, column_slots=True)
        bd_t = torch.from_numpy(bd)
        blocks = plan_cell_blocks(torch.from_numpy(p0), bd_t, spec)
        am = blocks.mask_rows
        perm = torch.clamp(blocks.perm, max=len(p0) - 1)
        pos_s = torch.where(am[:, None], torch.from_numpy(p0)[perm], 0.0)
        batch = np.where(am.numpy(), 0, 1).astype(np.int64)
        box = np.diag(bd).astype(np.float32)
        nbr = tnb.build_neighbor_matrix(
            pos_s, torch.from_numpy(batch), atom_mask=am, loop=True,
            cutoff_upper=cutoff, box=torch.from_numpy(box),
            **grouped_list_kwargs(spec, bd, cutoff, len(p0)))
        pos = pos_s.numpy()
        # padding before a valid self slot: the layout reverse_slots masks
        valid = nbr.mask.numpy()
        assert (~valid[:, :-1] & valid[:, 1:]).any()
    assert not bool(nbr.overflow)
    return pos, box, batch, nbr


def _jax_nbr(nbr, rev=True):
    return jnb.NeighborMatrix(
        jnp.asarray(nbr.idx.numpy().astype(np.int32)),
        jnp.asarray(nbr.mask.numpy()), None, None,
        jnp.asarray(nbr.rev_slot.numpy().astype(np.int32)) if rev else None)


@pytest.mark.parametrize("layout", ["brute_open", "brute_triclinic",
                                    "column_partitioned"])
def test_gather_pair_deltas_matches_jax(layout):
    """Forward, VJP (a cotangent on every slot, invalid ones included) and
    the second order through ``neighbor_geometry`` with its periodic wrap;
    the port's gradient graph holds no scatter, and its forces equal those
    of plain indexing (``rev_slot=None``)."""
    pos, box, batch, nbr = _layout(layout)
    n, k = nbr.idx.shape
    rng = np.random.RandomState(11)
    ct = rng.randn(n, k, 3).astype(np.float32)
    w = rng.uniform(-0.2, 0.2, (n, k)).astype(np.float32)
    u = rng.randn(n, k, 3).astype(np.float32) * 0.1
    v = rng.randn(n, 3).astype(np.float32)
    jn = _jax_nbr(nbr)
    jbox = None if box is None else jnp.asarray(box)
    jbatch = jnp.asarray(batch.astype(np.int32))

    # the op alone
    want, vjp = jax.vjp(lambda p: jmp.gather_pair_deltas(
        p, jn.idx, jn.rev_slot, jn.mask), jnp.asarray(pos))
    (want_dpos,) = vjp(jnp.asarray(ct))
    p = torch.from_numpy(pos).requires_grad_(True)
    got = tmp.gather_pair_deltas(p, nbr.idx, nbr.rev_slot, nbr.mask)
    (got_dpos,) = torch.autograd.grad(got, p, torch.from_numpy(ct))
    _close(got.detach(), want)
    _close(got_dpos, want_dpos)

    # the geometry: gradient and a Hessian-vector product
    def jax_energy(q):
        d, dist = jnb.neighbor_geometry(q, jn, box=jbox, batch=jbatch)
        return jnp.sum(w * dist ** 2 * jnp.sin(dist)) + jnp.sum(u * d)

    jg = jax.grad(jax_energy)(jnp.asarray(pos))
    jhv = jax.grad(lambda q: jnp.vdot(jax.grad(jax_energy)(q),
                                      jnp.asarray(v)))(jnp.asarray(pos))

    def port_grads(nb):
        q = torch.from_numpy(pos).requires_grad_(True)
        d, dist = tnb.neighbor_geometry(
            q, nb, box=None if box is None else torch.from_numpy(box),
            batch=torch.from_numpy(batch))
        e = ((torch.from_numpy(w) * dist ** 2 * torch.sin(dist)).sum()
             + (torch.from_numpy(u) * d).sum())
        (g,) = torch.autograd.grad(e, q, create_graph=True)
        (hv,) = torch.autograd.grad((g * torch.from_numpy(v)).sum(), q)
        return g, hv

    g, hv = port_grads(nbr)
    assert not _scatters(g), _scatters(g)
    _close(g.detach(), jg)
    _close(hv, jhv)
    g0, hv0 = port_grads(nbr._replace(rev_slot=None))
    assert _scatters(g0)  # plain indexing transposes to a scatter
    _close(g.detach(), g0.detach(), tol=1e-5)
    _close(hv, hv0, tol=1e-5)


def test_gather_rev_second_order_matches_jax():
    """``gather_rev`` is its own transpose at every order: the gradient
    graph of a first derivative holds no scatter (before, plain indexing
    transposed to ``index_put``), and the second-order cotangent matches
    JAX's ``custom_vjp``."""
    pos, box, batch, nbr = _layout("brute_open")
    n, k = nbr.idx.shape
    rng = np.random.RandomState(5)
    g0 = rng.randn(n, k, 4).astype(np.float32)
    c0 = rng.randn(n, k, 4).astype(np.float32)
    v = rng.randn(n, k, 4).astype(np.float32)
    jn = _jax_nbr(nbr)

    def jax_first(g, c):
        return jax.grad(lambda h: jnp.sum(
            c * jmp.gather_rev(h * h, jn.idx, jn.rev_slot, jn.mask)))(g)

    jd_g, jd_c = jax.grad(lambda g, c: jnp.sum(jax_first(g, c) * v),
                          argnums=(0, 1))(jnp.asarray(g0), jnp.asarray(c0))

    g = torch.from_numpy(g0).requires_grad_(True)
    c = torch.from_numpy(c0).requires_grad_(True)
    out = (c * tmp.gather_rev(g * g, nbr.idx, nbr.rev_slot, nbr.mask)).sum()
    (first,) = torch.autograd.grad(out, g, create_graph=True)
    assert not _scatters(first), _scatters(first)
    d_g, d_c = torch.autograd.grad((first * torch.from_numpy(v)).sum(),
                                   (g, c))
    _close(first.detach(), jax_first(jnp.asarray(g0), jnp.asarray(c0)))
    _close(d_g, jd_g)
    _close(d_c, jd_c)


def test_asym_sum_second_order_matches_jax():
    """TensorNet2's asymmetric packed sum differentiates twice (force
    training; before, its backward was ``once_differentiable`` and this
    raised), and matches JAX's ``jax.grad`` of its VJP.  The mirrored
    quirk: ``attr_rev`` gets a zero first-order cotangent, in both."""
    _, pos, box = lattice_system(n_side=3, seed=2)
    nbr = tnb.build_neighbor_matrix(torch.from_numpy(pos), k_max=32,
                                    cutoff_upper=4.0, loop=True,
                                    box=torch.from_numpy(box))
    n, k = nbr.idx.shape
    f = 4
    rng = np.random.RandomState(8)
    mask = nbr.mask.numpy()[..., None]
    a0 = (rng.randn(n, k, 3 * f) * mask).astype(np.float32)
    b0 = (rng.randn(n, k, 3 * f) * mask).astype(np.float32)
    x0 = rng.randn(n, 9 * f).astype(np.float32)
    w = rng.randn(n, 9 * f).astype(np.float32)
    v = rng.randn(n, 9 * f).astype(np.float32)
    jn = _jax_nbr(nbr)

    def jax_loss(a, b, x):
        msg = jmp.packed_neighbor_sum_asym(a, b, x, jn.idx, jn.rev_slot,
                                           jn.mask)
        return jnp.sum(w * msg * msg)

    ja, jb, jx = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (a0, b0, x0)))
    second = jax.grad(lambda a, b, x: jnp.sum(
        jax.grad(jax_loss, argnums=2)(a, b, x) * v), argnums=(0, 1, 2))(
        *map(jnp.asarray, (a0, b0, x0)))

    a, b, x = (torch.from_numpy(t).requires_grad_(True) for t in (a0, b0, x0))
    msg = pack9(edge_message_passing(a, split9(x, n, f), nbr, attr_rev=b))
    loss = (torch.from_numpy(w) * msg * msg).sum()
    da, db, dx = torch.autograd.grad(loss, (a, b, x), create_graph=True,
                                     allow_unused=True)
    assert db is None and not np.abs(np.asarray(jb)).any()
    _close(da.detach(), ja)
    _close(dx.detach(), jx)
    got = torch.autograd.grad((dx * torch.from_numpy(v)).sum(), (a, b, x))
    for g_, j_ in zip(got, second):
        _close(g_, j_)
    assert np.abs(np.asarray(second[1])).max() > 0  # attr_rev at order 2


def test_tensornet2_forces_equal_with_and_without_rev_slot():
    """A TensorNet2 (Scalar head, plain ops) on the port: the forces
    through ``gather_pair_deltas`` (the list's ``rev_slot``) equal those
    through plain indexing; and the gradient of a force loss to the
    interaction's weights equals central differences in float64.  Before,
    it silently lost the asymmetric sum's second-order terms (its backward
    was ``once_differentiable`` and the reverse-edge weights had no graph):
    ``linears_scalar.1`` read −1.07e-5 where the differences give
    −1.65e-5."""
    z, pos, box = lattice_system(n_side=3, seed=1)
    args = dict(SMALL_ARGS, output_model="Scalar", num_layers=1,
                embedding_dimension=8, num_rbf=8, pallas_embedding=False,
                pallas_edge_mlp=False)
    pot = create_model(args, device="cpu", seed=3)
    nbr = tnb.build_neighbor_matrix(
        torch.from_numpy(pos), k_max=48, cutoff_upper=4.5, loop=True,
        box=torch.from_numpy(box))
    kw = dict(num_mols=1, box=box, q=torch.zeros(1))
    y1, f1 = pot.apply(z, pos, **kw, nbr=nbr)
    y0, f0 = pot.apply(z, pos, **kw, nbr=nbr._replace(rev_slot=None))
    _close(y1, y0, tol=1e-6)
    _close(f1, f0, tol=1e-5)

    pot.module.double()
    zt = torch.from_numpy(z).long()
    p64 = torch.from_numpy(pos.astype(np.float64))
    b64 = torch.from_numpy(box.astype(np.float64))
    seg = torch.zeros(len(z), dtype=torch.long)

    def force_loss():
        p = p64.clone().requires_grad_(True)
        y = pot.module(zt, p, seg, num_mols=1, box=b64,
                       q=torch.zeros(1, dtype=torch.float64), nbr=nbr)
        (f,) = torch.autograd.grad(y.sum(), p, create_graph=True)
        return (f * f).sum()

    layer = pot.module.representation_model.layers[0]
    weights = [layer.linears_scalar[0].weight, layer.linears_scalar[1].weight,
               layer.linears_tensor[3].weight]
    pot.module.requires_grad_(True)
    grads = torch.autograd.grad(force_loss(), weights)
    pot.module.requires_grad_(False)
    eps = 1e-5
    for w, g in zip(weights, grads):
        for ij in ((0, 0), (1, 2), (3, 1)):
            w0 = float(w[ij])
            w.data[ij] = w0 + eps
            lp = float(force_loss().detach())
            w.data[ij] = w0 - eps
            lm = float(force_loss().detach())
            w.data[ij] = w0
            fd = (lp - lm) / (2 * eps)
            assert abs(float(g[ij]) - fd) <= 1e-5 * abs(fd) + 1e-12, (
                ij, float(g[ij]), fd)
