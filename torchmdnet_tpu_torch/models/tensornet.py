"""TensorNet — Cartesian rank-2 tensor NNP (Simeon & de Fabritiis,
NeurIPS'23), and the trunk pieces TensorNet2 shares with it.

Counterpart of ``torchmdnet_tpu/models/tensornet.py``: ``PairLinear``,
``TensorEmbedding`` (``:201-325``), ``linear_irreps``, the gather and
symmetric branches of ``edge_message_passing`` (``:142-153``),
``Interaction`` (``:328-444``) and ``TensorNet`` (``:447-605``).  The
embedding's fused branch runs kernels 1 and 2
(``ops/radial_embedding.py``).  The interaction's edge weights come from
one of three branches: the Chebyshev-tabulated filter
(``tabulated_edge_mlp = T``, kernels 5 and 7, ``ops/cheb_filter.py``), the
fused edge MLP (``pallas_edge_mlp``, kernel 4, ``ops/edge_mlp.py``) or the
plain chain.  With a ``cell_block_spec`` and ``blocked=True`` (rows in a
cell-blocked sort, the list grouped or not) the neighbor sum runs the
blocked tier (``ops/blocked_mp.py``, rows 8-11): with tabulated filters
the series is evaluated inside the sum (rows 10, 11) and the ``[N, K,
3F]`` edge weights never reach memory; otherwise the weights go to rows 8
and 9.

``dtype`` (``precision=16``: bfloat16) is the compute dtype of the
layers (JAX's ``dtype=``, the weights stay float32).  The kernels take
float32 only, and the fused branches give way to the plain chains where
JAX's do: the embedding's under another compute dtype or float64 inputs
(``tensornet.py:246-247``), kernel 4 wherever the rbf is not float32
(``:351-355``; under ``precision=16`` the rbf stays float32, so it
runs).  ``remat`` recomputes each layer's edge pipeline in the
backward and keeps its neighbour-sum output, so the sum is not run again
(:func:`remat_call`).
"""

import contextlib

import torch
import torch.nn.functional as F_
from torch import nn
from torch.utils.checkpoint import checkpoint

from torchmdnet_tpu_torch.models.common import (
    Embedding, LayerNorm, Linear, get_activation, make_rbf,
    set_compute_dtype)
from torchmdnet_tpu_torch.ops import rbf as rbf_ops
from torchmdnet_tpu_torch.ops.blocked_mp import (
    blocked_neighbor_sum_asym, blocked_neighbor_sum_sym,
    blocked_neighbor_sum_sym_cheb)
from torchmdnet_tpu_torch.ops.cheb import cheb_fit_matrix, cheb_nodes
from torchmdnet_tpu_torch.ops.cheb_filter import cheb_filter
from torchmdnet_tpu_torch.ops.edge_mlp import fused_edge_mlp
from torchmdnet_tpu_torch.ops.kernels import kernel_dtype, remat_recompute
from torchmdnet_tpu_torch.ops.message_passing import (
    gather_nodes, packed_neighbor_sum_asym, packed_neighbor_sum_sym,
    reverse_slots)
from torchmdnet_tpu_torch.ops.neighbors import (
    NeighborMatrix, build_neighbor_matrix, neighbor_geometry)
from torchmdnet_tpu_torch.ops.radial_embedding import (
    radial_embedding, radial_embedding_ref)
from torchmdnet_tpu_torch.ops.tensor_algebra import (
    Irreps, compose_tensor, decompose_tensor, irreps_norm3,
    tensor_frobenius_norm2, tensor_matmul_o3, tensor_matmul_so3)


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, under ``remat`` (and grad mode) as a non-reentrant
    ``torch.utils.checkpoint``: what ``fn`` saves for the backward is
    recomputed there, its output kept.  The layers call it on their
    message (edge pipeline and neighbour sum) and on their update, so the
    sum's ``[N, 9F]`` output is what stays between them, as JAX's
    selective policy ``save_only_these_names("pns_out")`` keeps it
    (``models/tensornet.py:563-570``, ``tensornet2.py:404-411``).  The
    recompute runs under ``ops/kernels.py::remat_recompute``, where the
    neighbour sum skips its work: the edge pipeline (kernels 1-4) runs
    twice a step, the sum once, as in JAX.  It works under the force
    pass's ``create_graph``."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=_remat_contexts)
    return fn(*args)


def _remat_contexts():
    return contextlib.nullcontext(), remat_recompute()


def linear_irreps(irr: Irreps, linears) -> Irreps:
    """Three bias-free channel-mixing linears, one per irrep part."""
    return Irreps(linears[0](irr.I), linears[1](irr.A), linears[2](irr.S))


def pack9(irr: Irreps):
    """``(I, A×3, S×5)`` rows ``[N, 9F]``, the inverse of :func:`split9`."""
    n, f = irr.I.shape
    return torch.cat([irr.I, irr.A.reshape(n, 3 * f),
                      irr.S.reshape(n, 5 * f)], dim=-1)


def split9(msg, n, f) -> Irreps:
    return Irreps(msg[:, :f], msg[:, f:4 * f].reshape(n, 3, f),
                  msg[:, 4 * f:].reshape(n, 5, f))


def divide_irreps(irr: Irreps, s) -> Irreps:
    """Divide every irrep part by the per-(node, channel) ``s [N, F]``."""
    return Irreps(irr.I / s, irr.A / s[:, None, :], irr.S / s[:, None, :])


def edge_message_passing(attr3f, irr: Irreps, nbr: NeighborMatrix,
                         attr_rev=None, blocked=False) -> Irreps:
    """TensorNet message pass over the neighbor matrix with edge weights
    ``attr3f [N, K, 3F]`` (cutoff- and pad-masked; block 0 weights I, 1
    weights A, 2 weights S).  Direction-dependent weights come with their
    recomputed reverse ``attr_rev``; without it the weights must be
    edge-symmetric (functions of the distance alone) and the sum's
    backward is the sum itself (it needs ``nbr.rev_slot`` for its second
    order).

    ``blocked`` (sorted rows, JAX ``:110-141``) runs the blocked tier:
    ``attr3f`` is either the weights (rows 8, 9) or the tuple ``("cheb",
    coeffs, d, fm, lo, hi)`` of a tabulated filter, evaluated inside the
    sum (rows 10, 11)."""
    n, f = irr.I.shape
    if blocked and isinstance(attr3f, tuple):
        _, coeffs, d, fm, lo, hi = attr3f
        msg = blocked_neighbor_sum_sym_cheb(coeffs, d, fm, pack9(irr),
                                            nbr.idx, lo, hi)
    elif blocked and attr_rev is None:
        msg = blocked_neighbor_sum_sym(attr3f, pack9(irr), nbr.idx, nbr.mask)
    elif blocked:
        msg = blocked_neighbor_sum_asym(attr3f, attr_rev, pack9(irr),
                                        nbr.idx, nbr.mask)
    elif attr_rev is None:
        msg = packed_neighbor_sum_sym(attr3f, pack9(irr), nbr.idx,
                                      nbr.rev_slot, nbr.mask)
    else:
        msg = packed_neighbor_sum_asym(attr3f, attr_rev, pack9(irr), nbr.idx,
                                       nbr.rev_slot, nbr.mask)
    return split9(msg, n, f)


def interaction_update(X: Irreps, Y: Irreps, M: Irreps, linears, group,
                       qfac=None) -> Irreps:
    """The tail of an interaction layer: the ``O(3)`` (``Y·M + M·Y``) or
    ``SO(3)`` (``2·Y·M``) product, normalised, mixed by ``linears`` (the
    layer's ``linears_tensor[3:]``), and ``X + dX + dX²``.  ``qfac [N]``
    (TensorNet's ``1 + 0.1·q``) scales the O(3) product and ``dX²``."""
    Yf, Mf = compose_tensor(Y), compose_tensor(M)
    q4 = None if qfac is None else qfac.to(Yf.dtype)[:, None, None, None]
    if group == "O(3)":
        Cf = tensor_matmul_o3(Yf, Mf)
        if q4 is not None:
            Cf = q4 * Cf
    else:
        Cf = 2.0 * tensor_matmul_so3(Yf, Mf)
    B = decompose_tensor(Cf)
    B = divide_irreps(B, tensor_frobenius_norm2(B) + 1.0)
    dX = linear_irreps(B, linears)
    dXf = compose_tensor(dX)
    sq = tensor_matmul_so3(dXf, dXf)
    dX2 = decompose_tensor(sq if q4 is None else q4 * sq)
    return Irreps(X.I + dX.I + dX2.I, X.A + dX.A + dX2.A,
                  X.S + dX.S + dX2.S)


def atom_charges(q, batch, like):
    """Per-atom total charge from the per-molecule ``q``; ghost atoms
    (``batch == len(q)``) and ``q=None`` give 0 (reference
    ``tensornet.py:531-537``)."""
    if q is None:
        return torch.zeros(batch.shape, dtype=like.dtype, device=like.device)
    q = torch.as_tensor(q, dtype=like.dtype, device=like.device)
    return torch.cat([q, q.new_zeros(1)])[torch.clamp(batch, max=q.shape[0])]


def unit_vectors(delta, dist):
    """``delta / dist``; self pairs and padded slots (``dist == 0``) keep a
    zero vector (reference ``tensornet.py:558-561``)."""
    return delta / torch.where(dist > 0, dist, 1.0)[..., None]


def build_neighbors(model, pos, batch, box=None, atom_mask=None):
    """The representation model's own neighbor list (``loop=True``, its
    strategy, cutoffs and ``max_num_neighbors``)."""
    kwargs = {}
    if model.neighbor_strategy == "cell":
        kwargs = dict(cells_per_dim=model.cells_per_dim,
                      cell_capacity=model.cell_capacity)
    return build_neighbor_matrix(
        pos, batch, strategy=model.neighbor_strategy,
        k_max=model.max_num_neighbors, cutoff_upper=model.cutoff_upper,
        cutoff_lower=model.cutoff_lower, loop=True, box=box,
        atom_mask=atom_mask, **kwargs)


class PairLinear(nn.Linear):
    """Upstream ``nn.Linear(2F, F)`` on ``cat(Z_i, Z_j)``, lifted to node
    level: returns ``(Z·W₁ᵀ + b, Z·W₂ᵀ)`` — a 64× saving over applying it
    on the edge axis."""

    compute_dtype = None

    def __init__(self, features):
        super().__init__(2 * features, features)

    def reset_parameters(self, generator=None):
        bound = 1.0 / (self.in_features ** 0.5)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, Z):
        f = Z.shape[-1]
        dt = self.compute_dtype or Z.dtype
        Z, w = Z.to(dt), self.weight.to(dt)
        zw1 = Z @ w[:, :f].t() + self.bias.to(dt)
        zw2 = Z @ w[:, f:].t()
        return zw1, zw2


class TensorEmbedding(nn.Module):
    """Edge-wise tensor embedding (reference ``tensornet.py:448-619``)."""

    def __init__(self, hidden_channels, num_rbf, activation="silu",
                 cutoff_lower=0.0, cutoff_upper=4.5, max_z=128,
                 pallas_embedding=False, remat=False):
        super().__init__()
        F = hidden_channels
        self.hidden_channels = F
        self.remat = remat
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.act = get_activation(activation)
        self.fused = pallas_embedding
        self.emb = Embedding(max_z, F)
        self.emb2 = PairLinear(F)
        self.distance_proj1 = Linear(num_rbf, F)
        self.distance_proj2 = Linear(num_rbf, F)
        self.distance_proj3 = Linear(num_rbf, F)
        self.init_norm = LayerNorm(F)
        self.linears_scalar = nn.ModuleList([Linear(F, 2 * F),
                                             Linear(2 * F, 3 * F)])
        self.linears_tensor = nn.ModuleList(
            [Linear(F, F, bias=False) for _ in range(3)])

    def radial(self, z, nbr: NeighborMatrix, edge_weight, edge_vec_norm,
               edge_attr, rev_slot):
        """The ``[N, 9F]`` radial embedding ``(I, A×3, S×5)``."""
        idx, emask = nbr.idx, nbr.mask
        zw1, zw2 = self.emb2(self.emb(z))
        zw2g = gather_nodes(zw2, idx, rev_slot, emask)
        projs = (self.distance_proj1, self.distance_proj2, self.distance_proj3)
        kall = torch.cat([p.weight.t() for p in projs], dim=1)
        ball = torch.cat([p.bias for p in projs])
        C = rbf_ops.cosine_cutoff(edge_weight, self.cutoff_upper,
                                  self.cutoff_lower)
        dtype = self.emb.compute_dtype or edge_attr.dtype
        em = emask.to(edge_attr.dtype)
        v = edge_vec_norm
        args = (edge_attr.to(dtype).contiguous(), C.contiguous(),
                v[..., 0].contiguous(), v[..., 1].contiguous(),
                v[..., 2].contiguous(), zw1.contiguous(), zw2g.contiguous(),
                em, kall.to(dtype), ball.to(dtype))
        # kernels 1/2 (float32 only, JAX :243-248): the dp/cz/w chain stays
        # on chip, only [N, 9F] is written; otherwise the plain chain under
        # autograd
        fused = self.fused and kernel_dtype(dtype)
        return (radial_embedding if fused else radial_embedding_ref)(*args)

    def update(self, out9):
        F = self.hidden_channels
        X = split9(out9, out9.shape[0], F)
        norm = self.init_norm(tensor_frobenius_norm2(X))
        norm = self.act(self.linears_scalar[0](norm))
        norm = self.act(self.linears_scalar[1](norm)).reshape(-1, 3, F)
        X = linear_irreps(X, self.linears_tensor)
        return Irreps(X.I * norm[:, 0, :], X.A * norm[:, 1, None, :],
                      X.S * norm[:, 2, None, :])

    def forward(self, z, nbr: NeighborMatrix, edge_weight, edge_vec_norm,
                edge_attr, rev_slot):
        out9 = remat_call(self.remat, self.radial, z, nbr, edge_weight,
                          edge_vec_norm, edge_attr, rev_slot)
        return remat_call(self.remat, self.update, out9)


class Interaction(nn.Module):
    """TensorNet interaction layer (reference ``tensornet.py:682-814``).

    Edge weights ``attr [N, K, 3F]``, functions of the edge distance alone:
    with ``tabulated_edge_mlp = T`` and the node table ``tab = (dk,
    rbf(dk))`` the MLP runs at the ``T`` Chebyshev nodes and ``cheb_filter``
    evaluates the fitted series per slot (JAX ``:356-390``); with
    ``pallas_edge_mlp`` the fused edge MLP runs per slot (``:391-402``);
    otherwise the plain chain (``:403-408``).  The same parameters serve
    all three.  Under ``blocked`` the tabulated branch hands the series
    to the blocked sum as ``("cheb", coeffs, d, fm, lo, hi)`` (JAX
    ``:380-385``)."""

    def __init__(self, hidden_channels, num_rbf, activation="silu",
                 cutoff_lower=0.0, cutoff_upper=4.5,
                 equivariance_invariance_group="O(3)", pallas_edge_mlp=False,
                 tabulated_edge_mlp=0, remat=False):
        super().__init__()
        F = hidden_channels
        self.remat = remat
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.group = equivariance_invariance_group
        self.tabulated = int(tabulated_edge_mlp)
        self.fused = pallas_edge_mlp and activation == "silu"
        self.act = get_activation(activation)
        self.linears_scalar = nn.ModuleList([
            Linear(num_rbf, F), Linear(F, 2 * F), Linear(2 * F, 3 * F)])
        self.linears_tensor = nn.ModuleList(
            [Linear(F, F, bias=False) for _ in range(6)])

    def _mlp(self, x):
        for lin in self.linears_scalar:
            x = self.act(lin(x))
        return x

    def edge_weights(self, nbr: NeighborMatrix, edge_weight, edge_attr,
                     tab=None, blocked=False):
        if self.tabulated and tab is not None:
            dk, node_attr = tab
            Ck = rbf_ops.cosine_cutoff(dk, self.cutoff_upper,
                                       self.cutoff_lower)
            # the node MLP in the rbf's dtype, whatever the compute dtype
            # (JAX's Linear without dtype=, :370-372)
            h = node_attr
            for lin in self.linears_scalar:
                h = self.act(F_.linear(h, lin.weight.to(h.dtype),
                                       lin.bias.to(h.dtype)))
            coeffs = cheb_fit_matrix(dk.shape[0], dtype=h.dtype,
                                     device=dk.device) @ (h * Ck[:, None])
            fm = ((edge_weight < self.cutoff_upper) & nbr.mask).to(
                edge_weight.dtype)
            compute = self.linears_scalar[0].compute_dtype
            if blocked and compute is None:
                return ("cheb", coeffs, edge_weight, fm, 0.0,
                        self.cutoff_upper)
            attr = cheb_filter(coeffs, edge_weight, fm, 0.0,
                               self.cutoff_upper)
            return attr if compute is None else attr.to(compute)
        cw = rbf_ops.cosine_cutoff(edge_weight, self.cutoff_upper,
                                   self.cutoff_lower) * nbr.mask
        # kernel 4 wherever the rbf is float32, as JAX's (:351-355)
        if self.fused and kernel_dtype(edge_attr.dtype):
            l1, l2, l3 = self.linears_scalar
            return fused_edge_mlp(
                edge_attr.contiguous(), cw.contiguous(),
                l1.weight.t().contiguous(), l1.bias,
                l2.weight.t().contiguous(), l2.bias,
                l3.weight.t().contiguous(), l3.bias)
        return self._mlp(edge_attr) * cw[..., None]

    def message(self, Y: Irreps, nbr: NeighborMatrix, edge_weight, edge_attr,
                tab=None, blocked=False):
        """The neighbour sum ``[N, 9F]`` of the layer's edge weights and
        the normalised, mixed features ``Y``."""
        attr = self.edge_weights(nbr, edge_weight, edge_attr, tab, blocked)
        # the weights depend on the edge distance only: symmetric under
        # edge reversal, so the sum's backward is the sum itself
        return pack9(edge_message_passing(attr, Y, nbr, blocked=blocked))

    def update(self, X: Irreps, Y: Irreps, msg9, q_atom):
        return interaction_update(X, Y, split9(msg9, *Y.I.shape),
                                  self.linears_tensor[3:], self.group,
                                  qfac=1.0 + 0.1 * q_atom)

    def forward(self, X: Irreps, nbr: NeighborMatrix, edge_weight, edge_attr,
                q_atom, tab=None, blocked=False):
        X = divide_irreps(X, tensor_frobenius_norm2(X) + 1.0)
        Y = linear_irreps(X, self.linears_tensor[:3])
        msg9 = remat_call(self.remat, self.message, Y, nbr, edge_weight,
                          edge_attr, tab, blocked)
        return remat_call(self.remat, self.update, X, Y, msg9, q_atom)


class TensorNet(nn.Module):
    """Representation model (reference ``tensornet.py:149-402``); returns
    ``(x [N, F], None)``.  ``forward(..., blocked=True)`` needs the model
    built with a ``cell_block_spec`` and the rows in its sort.
    ``rbf_initial``: a checkpoint's frozen rbf buffers (JAX's
    ``rbf_initial``), in place of the defaults."""

    def __init__(self, hidden_channels=128, num_layers=2, num_rbf=32,
                 rbf_type="expnorm", trainable_rbf=False, activation="silu",
                 cutoff_lower=0.0, cutoff_upper=4.5, max_num_neighbors=64,
                 max_z=128, equivariance_invariance_group="O(3)",
                 neighbor_strategy="brute", cells_per_dim=None,
                 cell_capacity=64, pallas_edge_mlp=False,
                 tabulated_edge_mlp=0, pallas_embedding=False,
                 cell_block_spec=None, rbf_initial=None, remat=False,
                 dtype=None):
        super().__init__()
        if equivariance_invariance_group not in ("O(3)", "SO(3)"):
            raise ValueError(f'Unknown group "{equivariance_invariance_group}". '
                             "Choose O(3) or SO(3).")
        F = hidden_channels
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.max_num_neighbors = max_num_neighbors
        self.neighbor_strategy = neighbor_strategy
        self.cells_per_dim = cells_per_dim
        self.cell_capacity = cell_capacity
        self.cell_block_spec = cell_block_spec
        self.tabulated_edge_mlp = int(tabulated_edge_mlp)
        self.act = get_activation(activation)
        self.distance_expansion = make_rbf(rbf_type, cutoff_lower,
                                           cutoff_upper, num_rbf,
                                           trainable_rbf, rbf_initial)
        self.tensor_embedding = TensorEmbedding(
            F, num_rbf, activation, cutoff_lower, cutoff_upper, max_z,
            pallas_embedding=pallas_embedding, remat=remat)
        self.layers = nn.ModuleList([
            Interaction(F, num_rbf, activation, cutoff_lower, cutoff_upper,
                        equivariance_invariance_group,
                        pallas_edge_mlp=pallas_edge_mlp,
                        tabulated_edge_mlp=tabulated_edge_mlp, remat=remat)
            for _ in range(num_layers)])
        self.out_norm = LayerNorm(3 * F)
        self.linear = Linear(3 * F, F)
        set_compute_dtype(self, dtype)

    build_neighbors = build_neighbors

    def forward(self, z, pos, batch, box=None, q=None, atom_mask=None,
                nbr=None, num_mols=None, blocked=False):
        if blocked and self.cell_block_spec is None:
            raise ValueError("blocked=True needs a model built with a "
                             "cell_block_spec")
        if nbr is None:
            nbr = self.build_neighbors(pos, batch, box=box, atom_mask=atom_mask)
        if nbr.rev_slot is None:
            nbr = nbr._replace(rev_slot=reverse_slots(nbr.idx, nbr.mask))
        rev_slot = nbr.rev_slot
        delta, dist = neighbor_geometry(pos, nbr, box=box, batch=batch)
        q_atom = atom_charges(q, batch, pos)
        edge_attr = self.distance_expansion(dist)
        tab = None
        if self.tabulated_edge_mlp:
            # the rbf once at the Chebyshev nodes; each layer fits its own
            # filter table from it
            dk = cheb_nodes(self.tabulated_edge_mlp, 0.0, self.cutoff_upper,
                            dtype=dist.dtype, device=dist.device)
            tab = (dk, self.distance_expansion(dk))
        X = self.tensor_embedding(z, nbr, dist, unit_vectors(delta, dist),
                                  edge_attr, rev_slot)
        for layer in self.layers:
            X = layer(X, nbr, dist, edge_attr, q_atom, tab=tab,
                      blocked=blocked)
        x = self.act(self.linear(self.out_norm(irreps_norm3(X))))
        return x, None
