"""Force training through the port's kernel ops, torch only (no JAX
compile): the gradient in the weights of a force loss (the loss
``train/step.py::compute_losses(..., create_graph=True)`` trains on) is
held against central differences in float64 (``precision=64``).

Along a seeded random direction ``v`` in all the weights, the analytic
derivative ``Σ ∂L/∂θ · v`` must equal ``(L(θ + h·v) − L(θ − h·v)) / 2h``
(h = 1e-5) to 1e-4 relative.  The ops that a force pass differentiates
twice are the radial embedding (kernels 1-2, ``pallas_embedding``), the
edge MLPs (kernels 3-4, ``pallas_edge_mlp``) and the list Coulomb
(``coulomb_cutoff``).  Their backwards were ``once_differentiable``, and
``torch.autograd.grad`` to a weight pruned the error node that hangs on
their outputs: the second-order terms vanished without a word (relative
errors of 1.26, 4.6e-4 and 5.7 then).  The models send float64 to the
plain chains (the kernels take float32), so here the fused branches are
opened to float64, whose plain versions the ops run on the CPU, and each
case checks that its op's second order ran.  ``gradgradcheck`` holds
each op's second order on its own.  The same check holds ``remat`` and
``trainable_rbf``, and the Equivariant Transformer, TorchMD-T and
TorchMD-GN (plain PyTorch ops, whose second order is autograd's: a
``once_differentiable`` on ET's attention fails its case); and the
blocked ops, which stay first order, must raise under ``create_graph``
rather than drop terms.
"""

import collections

import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread, open_molecule  # noqa: F401
from torchmdnet_tpu_torch.models import tensornet, tensornet2
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.ops import message_passing
from torchmdnet_tpu_torch.ops.blocked_mp import (
    blocked_neighbor_sum_sym, blocked_neighbor_sum_sym_cheb)
from torchmdnet_tpu_torch.ops.blocked_q import (
    blocked_neighbor_sum_asym_q, blocked_neighbor_sum_asym_q_tab)
from torchmdnet_tpu_torch.ops.coulomb import (
    _CoulombW, coulomb_cutoff_energy, coulomb_cutoff_energy_w)
from torchmdnet_tpu_torch.ops.edge_mlp import (
    _EdgeMlp, _EdgeMlpPre, edge_mlp_pre, fused_edge_mlp)
from torchmdnet_tpu_torch.ops.radial_embedding import (
    _RadialEmbeddingBwd, radial_embedding)
from torchmdnet_tpu_torch.ops.windowed_coulomb import (
    CoulombWindows, windowed_coulomb_energy)
from torchmdnet_tpu_torch.train.step import compute_losses

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-4
H = 1e-5
# TensorNet2 as the AceFF recipe, cut down: 1 layer x 16 channels, 8
# expnorm rbf, 5 Å, K = 16, q_dim 4, the charge-aware Coulomb head
TN2 = dict(
    model="tensornet2", embedding_dimension=16, num_layers=1, num_rbf=8,
    rbf_type="expnorm", trainable_rbf=False, activation="silu",
    cutoff_lower=0.0, cutoff_upper=5.0, max_z=128, max_num_neighbors=16,
    derivative=True, prior_model=None, reduce_op="sum", precision=64,
    equivariance_invariance_group="O(3)", atom_filter=-1, q_dim=4,
    output_model="ScalarPlusWeightedCoulomb", q_weights=[[1.0] * 4] * 2,
    coulomb_cutoff=None, pallas_embedding=False, pallas_edge_mlp=False)
TN = dict(TN2, model="tensornet", output_model="Scalar")
# the attention models and the graph network: plain PyTorch ops only
ATTN = dict(TN, attn_activation="silu", num_heads=4, neighbor_embedding=True,
            distance_influence="both", vector_cutoff=True, aggr="add")
# the ops whose second order each case must run: the embedding's
# (kernels 1-2), the edge MLPs' (kernel 3 in TensorNet2, kernel 4 in
# TensorNet) and the list Coulomb's
EMB, PRE, MLP, COUL = _RadialEmbeddingBwd, _EdgeMlpPre, _EdgeMlp, _CoulombW
CASES = {
    "tensornet2-pallas_embedding": (dict(TN2, pallas_embedding=True), [EMB]),
    "tensornet2-pallas_edge_mlp": (dict(TN2, pallas_edge_mlp=True), [PRE]),
    "tensornet2-list_coulomb": (dict(TN2, coulomb_cutoff=8.0), [COUL]),
    "tensornet-pallas_embedding": (dict(TN, pallas_embedding=True), [EMB]),
    "tensornet-pallas_edge_mlp": (dict(TN, pallas_edge_mlp=True), [MLP]),
    "tensornet2-remat": (dict(TN2, remat=True, pallas_embedding=True,
                              pallas_edge_mlp=True), [EMB, PRE]),
    "tensornet-remat": (dict(TN, remat=True, tabulated_edge_mlp=16), []),
    "tensornet2-trainable_rbf": (dict(TN2, trainable_rbf=True,
                                      pallas_embedding=True), [EMB]),
    "tensornet-trainable_rbf_gauss": (dict(TN, trainable_rbf=True,
                                           rbf_type="gauss",
                                           pallas_edge_mlp=True), [MLP]),
    "equivariant-transformer": (dict(ATTN, model="equivariant-transformer"),
                                []),
    "transformer": (dict(ATTN, model="transformer",
                         distance_influence="keys"), []),
    "graph-network-max": (dict(ATTN, model="graph-network", aggr="max"), []),
}


@pytest.fixture
def op_calls(monkeypatch):
    """The models' fused branches open to float64 (the ops run their
    plain versions on CPU tensors), and a count of each op's backward
    calls."""
    for mod in (tensornet, tensornet2):
        monkeypatch.setattr(mod, "kernel_dtype",
                            lambda dt: dt in (torch.float32, torch.float64))
    calls = collections.Counter()
    for op in (EMB, PRE, MLP, COUL):
        def counted(ctx, *grads, _op=op, _backward=op.backward):
            calls[_op] += 1
            return _backward(ctx, *grads)
        monkeypatch.setattr(op, "backward", staticmethod(counted))
    return calls


def _batch():
    """12 seeded atoms, one molecule of total charge 1, random force
    targets, in float64."""
    z, pos, _ = open_molecule(12, seed=5)
    rng = np.random.RandomState(6)
    return dict(z=torch.from_numpy(z).long(),
                pos=torch.from_numpy(pos.astype(np.float64)),
                batch=torch.zeros(12, dtype=torch.long),
                q=torch.ones(1, dtype=torch.float64),
                neg_dy=torch.from_numpy(rng.randn(12, 3)),
                mol_mask=torch.ones(1, dtype=torch.bool))


def _force_loss(pot, batch):
    return compute_losses(pot, batch, 1, create_graph=True)[1]


def _directional(args):
    """(analytic, central-difference) derivative of the force loss along
    a seeded direction in every weight."""
    pot = create_model(args, device="cpu", seed=7)
    batch = _batch()
    params = list(pot.module.parameters())
    gen = torch.Generator().manual_seed(8)
    direction = [torch.randn(p.shape, generator=gen, dtype=p.dtype)
                 for p in params]
    pot.module.requires_grad_(True)
    grads = torch.autograd.grad(_force_loss(pot, batch), params,
                                allow_unused=True)
    analytic = sum(float((g * v).sum()) for g, v in zip(grads, direction)
                   if g is not None)
    pot.module.requires_grad_(False)
    losses = []
    with torch.no_grad():
        base = [p.clone() for p in params]
    for sign in (1.0, -1.0):
        with torch.no_grad():
            for p, p0, v in zip(params, base, direction):
                p.copy_(p0 + sign * H * v)
        losses.append(float(_force_loss(pot, batch).detach()))
    with torch.no_grad():
        for p, p0 in zip(params, base):
            p.copy_(p0)
    return analytic, (losses[0] - losses[1]) / (2 * H)


@pytest.mark.parametrize("case", list(CASES))
def test_force_loss_gradient_matches_central_differences(case, op_calls):
    args, ops = CASES[case]
    analytic, numeric = _directional(args)
    # the case's ops ran their second order (the weight gradient went
    # through each op's backward, and through no other)
    assert {op for op, n in op_calls.items() if n} == set(ops)
    assert abs(numeric) > 1e-3
    assert abs(analytic - numeric) <= REL * abs(numeric), (analytic, numeric)


def test_graph_network_max_on_an_isolated_atom_is_finite():
    """TorchMD-GN with ``aggr="max"``: an atom with no neighbour takes 0
    from the max over its empty row (−inf on every slot); the force loss,
    its weight gradient (the second order) and the forces stay finite, and
    that atom feels no force."""
    batch = _batch()
    batch["z"] = torch.cat([batch["z"], torch.tensor([8])])
    batch["pos"] = torch.cat([batch["pos"], torch.tensor(
        [[40.0, 0.0, 0.0]], dtype=torch.float64)])
    batch["batch"] = torch.zeros(13, dtype=torch.long)
    batch["neg_dy"] = torch.cat([batch["neg_dy"],
                                 torch.ones(1, 3, dtype=torch.float64)])
    pot = create_model(dict(ATTN, model="graph-network", aggr="max"),
                       device="cpu", seed=7)
    pot.module.requires_grad_(True)
    params = list(pot.module.parameters())
    loss = _force_loss(pot, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads if g is not None)
    assert sum(float(g.abs().sum()) for g in grads if g is not None) > 0
    _, forces = pot.apply(batch["z"], batch["pos"], batch["batch"])
    assert bool(torch.isfinite(forces).all())
    assert not forces[12].any()


def _op_operands():
    """Each twice-differentiable kernel op on small float64 CPU operands:
    name → (function, operands; the float operands that take gradients
    are marked)."""
    gen = torch.Generator().manual_seed(11)
    n, k, r, f = 3, 4, 3, 2

    def rnd(*shape, grad=True):
        return torch.randn(shape, generator=gen,
                           dtype=torch.float64).requires_grad_(grad)

    mask = torch.ones(n, k, dtype=torch.float64)
    mask[0, 3] = 0.0
    emb = (rnd(n, k, r), rnd(n, k), rnd(n, k), rnd(n, k), rnd(n, k),
           rnd(n, f), rnd(n, k, f), mask, rnd(r, 3 * f), rnd(3 * f))
    mlp = (rnd(n, k, r), rnd(n, k), rnd(r, f), rnd(f), rnd(f, 2 * f),
           rnd(2 * f), rnd(2 * f, 3 * f), rnd(3 * f))
    # the list Coulomb on a complete symmetric list of 4 atoms
    m = 4
    pos = (torch.arange(m, dtype=torch.float64)[:, None] * torch.tensor(
        [1.3, 0.4, -0.2], dtype=torch.float64) + 0.3 * torch.randn(
        m, 3, generator=gen, dtype=torch.float64)).requires_grad_(True)
    idx = torch.tensor([[j for j in range(m) if j != i] for i in range(m)])
    cmask = torch.ones(m, m - 1, dtype=torch.bool)
    consts = (8.0, 78.4, 1.0)
    return {
        "radial_embedding": (radial_embedding, emb),
        "edge_mlp_pre": (edge_mlp_pre, (rnd(n, k, f),) + mlp[1:2] + mlp[4:]),
        "fused_edge_mlp": (fused_edge_mlp, mlp),
        "coulomb_w": (coulomb_cutoff_energy_w,
                      (pos, rnd(2), rnd(m, 2), idx, cmask) + consts),
        "coulomb_ab": (coulomb_cutoff_energy,
                       (pos, rnd(m, 2), rnd(m, 2), idx, cmask) + consts),
    }


@pytest.mark.parametrize("op", ["radial_embedding", "edge_mlp_pre",
                                "fused_edge_mlp", "coulomb_w", "coulomb_ab"])
def test_op_second_order_matches_finite_differences(op):
    """Each op's backward differentiated again (its Hessian-vector
    products in every float operand and in the cotangent) against
    finite differences of its backward, in float64
    (``torch.autograd.gradgradcheck``).  The radial embedding's mask
    takes no gradient: its cotangent is zero by the kernel's contract."""
    fn, operands = _op_operands()[op]
    assert torch.autograd.gradgradcheck(fn, operands, eps=1e-6, atol=1e-5,
                                        rtol=1e-4)


def test_remat_matches_no_remat(monkeypatch):
    """``remat=True`` recomputes the edge pipeline in the backward, not
    the neighbour sum: the same loss and weight gradients as without it,
    and as many packed sums (float32, the fused ops)."""
    args = dict(TN2, precision=32, pallas_embedding=True,
                pallas_edge_mlp=True)
    batch = {k: v.float() if v.is_floating_point() else v
             for k, v in _batch().items()}
    sums = []
    impl = message_passing._pns_impl
    monkeypatch.setattr(message_passing, "_pns_impl",
                        lambda *a: sums.append(1) or impl(*a))
    out, counts = [], []
    for remat in (False, True):
        sums.clear()
        pot = create_model(dict(args, remat=remat), device="cpu", seed=7)
        pot.module.requires_grad_(True)
        loss = _force_loss(pot, batch)
        out.append((loss, torch.autograd.grad(
            loss, list(pot.module.parameters()), allow_unused=True)))
        counts.append(len(sums))
    assert counts[0] == counts[1] > 0
    assert float(out[0][0].detach()) == pytest.approx(
        float(out[1][0].detach()), rel=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        assert (a is None) == (b is None)
        if a is None:
            continue
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-12)


def _blocked_calls():
    """One call of each first-order-only blocked op on small CPU
    operands, with its inputs taking gradients: name → (output, inputs)."""
    gen = torch.Generator().manual_seed(9)
    n, k, f, t, r = 8, 4, 4, 6, 5

    def rnd(*shape):
        return torch.randn(shape, generator=gen).requires_grad_(True)

    idx = torch.randint(0, n, (n, k), generator=gen)
    mask = torch.ones(n, k, dtype=torch.bool)
    d = (torch.rand(n, k, generator=gen) * 4 + 0.5).requires_grad_(True)
    cw, feats = rnd(n, k), rnd(n, 9 * f)
    u_i, u_j = rnd(n, f), rnd(n, f)
    w2, b2, w3, b3 = rnd(f, 2 * f), rnd(2 * f), rnd(2 * f, 3 * f), rnd(3 * f)
    attr = rnd(n, k, 3 * f)
    out = {
        "rows 8-9": (blocked_neighbor_sum_sym(attr, feats, idx, mask),
                     (attr, feats)),
        "rows 10-11": (blocked_neighbor_sum_sym_cheb(
            rnd(t, 3 * f), d, mask.float(), feats, idx, 0.0, 5.0),
            (d, feats)),
        "kernels A-B": (blocked_neighbor_sum_asym_q_tab(
            d, cw, u_i, u_j, feats, mask, idx, None, rnd(t, f), w2, b2, w3,
            b3, 0.0, 5.0), (d, u_i, feats)),
        "kernels A-B, exact base": (blocked_neighbor_sum_asym_q(
            rnd(n, k, r), cw, u_i, u_j, feats, mask, idx, None, rnd(r, f),
            w2, b2, w3, b3), (cw, u_j, feats)),
    }
    nb, cap, nsc = 2, 4, 9
    bounds = [torch.zeros((nb, nsc), dtype=torch.int64) for _ in range(4)]
    cwin = CoulombWindows(*bounds, torch.ones(nb * cap, dtype=torch.bool),
                          torch.full((3,), 30.0), (30.0,) * 3)
    pos, qw, b = rnd(nb * cap, 3), rnd(3), rnd(nb * cap, 3)
    out["kernels C-D"] = (windowed_coulomb_energy(pos, qw, b, cwin, 10.0,
                                                  78.4, 1.0), (pos, b))
    return out


@pytest.mark.parametrize("op", ["rows 8-9", "rows 10-11", "kernels A-B",
                                "kernels A-B, exact base", "kernels C-D"])
def test_blocked_ops_raise_under_create_graph(op):
    """The blocked ops have no second order (ROADMAP Queue 1 [17]): under
    ``create_graph`` their backward raises ``NotImplementedError``; a
    first-order backward (MD) runs."""
    out, inputs = _blocked_calls()[op]
    with pytest.raises(NotImplementedError, match="item 17"):
        torch.autograd.grad(out.sum(), inputs, create_graph=True)
    out, inputs = _blocked_calls()[op]
    grads = torch.autograd.grad(out.sum(), inputs)
    assert all(g is not None and not g.requires_grad for g in grads)
