"""TensorNet2: TensorNet with AIMNet2-style neutral charge equilibration.

Counterpart of ``torchmdnet_tpu/models/tensornet2.py``: ``ChargePredict``,
both branches of ``Interaction2`` (``:147-260``) and ``TensorNet2``
(``:284-462``).  Per-layer MLPs predict multi-channel partial charges that
are redistributed so each molecule's channel sums equal its total charge;
the charges feed the next interaction layer as edge features (folded into
per-node vectors) and, with ``output_charges``, are appended to the node
features for the Coulomb head.

With ``pallas_edge_mlp`` the edge MLP tail runs kernel 3
(``ops/edge_mlp.py``); otherwise it is the plain chain.  With a
``cell_block_spec`` and ``blocked=True`` (the MD path in cell-blocked
sorted rows) each interaction runs the fused charge-fold q-tier instead
(``ops/blocked_q.py``, kernels A and B, the blocked branch of
``tensornet2.py:147-209``): its edge-MLP base ``rbf(d)·W1a`` is a
``q_tab``-term Chebyshev series fitted at the rbf's nodes, or with
``q_tab=0`` the exact rbf operand, and neither the edge weights nor their
reverse reach memory.  On a grouped spec (``col_slots``) the forward
takes ``nbr_emb``, a compact K list for the embedding, while the
interactions ride the column-partitioned K′ list through the tabulated
q-tier (the dual-list mode, ``tensornet2.py:358-373``).

``dtype`` and ``remat`` as in ``models/tensornet.py``: under a compute
dtype other than float32 (``precision=16``) or float64 inputs kernel 3
gives way to the plain chain, as JAX's does (``tensornet2.py:224-225``),
and so does the q-tier (``:151-152``); the charge heads take no compute
dtype (they compute in their input's, as in JAX).
"""

import torch
from torch import nn

from torchmdnet_tpu_torch.models.common import (
    MLP, LayerNorm, Linear, get_activation, make_rbf, set_compute_dtype)
from torchmdnet_tpu_torch.models.tensornet import (
    TensorEmbedding, atom_charges, build_neighbors, divide_irreps,
    edge_message_passing, interaction_update, linear_irreps, pack9,
    remat_call, split9, unit_vectors)
from torchmdnet_tpu_torch.ops import rbf as rbf_ops
from torchmdnet_tpu_torch.ops.blocked_q import (
    blocked_neighbor_sum_asym_q, blocked_neighbor_sum_asym_q_tab)
from torchmdnet_tpu_torch.ops.cheb import cheb_fit_matrix, cheb_nodes
from torchmdnet_tpu_torch.ops.edge_mlp import edge_mlp_pre
from torchmdnet_tpu_torch.ops.kernels import kernel_dtype
from torchmdnet_tpu_torch.ops.message_passing import gather_nodes, reverse_slots
from torchmdnet_tpu_torch.ops.neighbors import NeighborMatrix, neighbor_geometry
from torchmdnet_tpu_torch.ops.segment import segment_sum
from torchmdnet_tpu_torch.ops.tensor_algebra import (
    Irreps, irreps_norm2, irreps_norm3, tensor_frobenius_norm2)


class ChargePredict(nn.Module):
    """Charge head and neutral charge equilibration (reference
    ``tensornet2.py:49-156``)."""

    def __init__(self, hidden_channels, activation="silu", q_dim=16):
        super().__init__()
        self.q_dim = q_dim
        self.q_norm = LayerNorm(3 * hidden_channels)
        self.q_mlp = MLP(3 * hidden_channels, 2 * q_dim, hidden_channels,
                         activation, num_hidden_layers=1)

    @staticmethod
    def qeq(old_charges, f, batch, Q_atom, num_mols: int):
        """new = q + f²/(Σ_mol f² + ε)·(Q − Σ_mol q).  The per-molecule
        sums go back to the atoms through ``index_select``, whose
        backward is an ``index_add``: plain indexing transposes to a
        sorted ``index_put`` that sums a molecule's atoms, all duplicates
        of one index, one after another."""
        f_u = f * f
        F_u = segment_sum(f_u, batch, num_mols + 1) + 1.0e-6
        Q_u = segment_sum(old_charges, batch, num_mols + 1)
        dQ = Q_atom[:, None] - Q_u.index_select(0, batch)
        return old_charges + f_u / F_u.index_select(0, batch) * dQ

    def forward(self, X: Irreps, batch, Q_atom, num_mols: int):
        # feature (I, ‖A‖², ‖S‖²): the raw I, unlike the readout's 3I²
        _, nA, nS = irreps_norm2(X)
        cf = self.q_mlp(self.q_norm(torch.cat([X.I, nA, nS], dim=-1)))
        charges, f = cf[:, :self.q_dim], cf[:, self.q_dim:]
        return self.qeq(charges, f, batch, Q_atom, num_mols)


class Interaction2(nn.Module):
    """TensorNet2 interaction layer: the gather branch (reference
    ``tensornet2.py:465-626``) and the blocked q-tier branch."""

    def __init__(self, hidden_channels, num_rbf, q_dim, activation="silu",
                 cutoff_lower=0.0, cutoff_upper=4.5,
                 equivariance_invariance_group="O(3)", pallas_edge_mlp=False,
                 cell_block_spec=None, remat=False):
        super().__init__()
        F = hidden_channels
        self.remat = remat
        self.num_rbf = num_rbf
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.group = equivariance_invariance_group
        self.fused = pallas_edge_mlp and activation == "silu"
        self.q_tier = cell_block_spec is not None and activation == "silu"
        self.act = get_activation(activation)
        self.linears_scalar = nn.ModuleList([
            Linear(num_rbf + 2 * q_dim, F), Linear(F, 2 * F),
            Linear(2 * F, 3 * F)])
        self.linears_tensor = nn.ModuleList(
            [Linear(F, F, bias=False) for _ in range(6)])

    def _mlp_tail(self, pre1, cw):
        l2, l3 = self.linears_scalar[1], self.linears_scalar[2]
        if self.fused and kernel_dtype(pre1.dtype):
            return edge_mlp_pre(pre1, cw, l2.weight.t().contiguous(), l2.bias,
                                l3.weight.t().contiguous(), l3.bias)
        h = self.act(l3(self.act(l2(self.act(pre1)))))
        return h * cw[..., None]

    def message(self, Y: Irreps, charges, nbr: NeighborMatrix, edge_weight,
                edge_attr, rev_slot, blocked=False, rbf_nodes=None):
        """The neighbour sum ``[N, 9F]`` of the layer's edge weights (or
        the q-tier's) and the normalised, mixed features ``Y``."""
        R, Q = self.num_rbf, charges.shape[-1]
        C = rbf_ops.cosine_cutoff(edge_weight, self.cutoff_upper,
                                  self.cutoff_lower)
        l1 = self.linears_scalar[0]
        # the compute dtype (JAX's cdt, :130-132)
        cdt = l1.compute_dtype or (edge_weight if edge_attr is None
                                   else edge_attr).dtype
        # Charge-fold of the first edge linear:
        # W1·[rbf; q_i; q_j] = rbf·W1a + (q·W1b + b1)[i] + (q·W1c)[j]
        w1 = l1.weight.t().to(cdt)
        qc = charges.to(cdt)
        u_i = qc @ w1[R:R + Q] + l1.bias.to(cdt)
        u_j = qc @ w1[R + Q:]
        cw = C * nbr.mask.to(C.dtype)
        q_path = (blocked and self.q_tier and l1.compute_dtype is None
                  and kernel_dtype(edge_weight.dtype))
        if edge_attr is None and not (q_path and rbf_nodes is not None):
            raise ValueError("edge_attr=None (the dual-list mode) needs the "
                             "θ-tabulated blocked q-tier")
        if q_path:
            # d (or the rbf) and cw are equal on both slots of a pair, as
            # the op's mirrored backward requires
            l2, l3 = self.linears_scalar[1], self.linears_scalar[2]
            w2, w3 = l2.weight.t().contiguous(), l3.weight.t().contiguous()
            n, f = Y.I.shape
            if rbf_nodes is not None:
                # base(d) = rbf(d)·W1a as a T-term Chebyshev series (one
                # [T, T]·[T, F] fit)
                T = rbf_nodes.shape[0]
                coeffs = cheb_fit_matrix(T, device=w1.device) @ (
                    rbf_nodes @ w1[:R])
                msg9 = blocked_neighbor_sum_asym_q_tab(
                    edge_weight, cw, u_i, u_j, pack9(Y), nbr.mask, nbr.idx,
                    rev_slot, coeffs, w2, l2.bias, w3, l3.bias,
                    self.cutoff_lower, self.cutoff_upper)
            else:
                msg9 = blocked_neighbor_sum_asym_q(
                    edge_attr, cw, u_i, u_j, pack9(Y), nbr.mask, nbr.idx,
                    rev_slot, w1[:R], w2, l2.bias, w3, l3.bias)
            return msg9
        base = edge_attr.to(cdt) @ w1[:R]
        pre1 = base + u_i[:, None, :] + gather_nodes(
            u_j, nbr.idx, rev_slot, nbr.mask)
        attr = self._mlp_tail(pre1, cw)
        # Reverse-edge weights (same MLP, q_i and q_j swapped) for the
        # scatter-free backward of the asymmetric neighbor sum.  Their
        # first-order cotangent is zero; the second order (force training)
        # reaches the weights through them, so they keep a graph only when
        # the weights take gradients.
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and w1.requires_grad):
            pre1_rev = base + u_j[:, None, :] + gather_nodes(
                u_i, nbr.idx, rev_slot, nbr.mask)
            attr_rev = self._mlp_tail(pre1_rev, cw)
        return pack9(edge_message_passing(attr, Y, nbr, attr_rev))

    def update(self, X: Irreps, Y: Irreps, msg9):
        return interaction_update(X, Y, split9(msg9, *Y.I.shape),
                                  self.linears_tensor[3:], self.group)

    def forward(self, X: Irreps, charges, nbr: NeighborMatrix, edge_weight,
                edge_attr, rev_slot, blocked=False, rbf_nodes=None):
        X = divide_irreps(X, tensor_frobenius_norm2(X) + 1.0)
        Y = linear_irreps(X, self.linears_tensor[:3])
        msg9 = remat_call(self.remat, self.message, Y, charges, nbr,
                          edge_weight, edge_attr, rev_slot, blocked, rbf_nodes)
        return remat_call(self.remat, self.update, X, Y, msg9)


class TensorNet2(nn.Module):
    """Representation model with charge equilibration (reference
    ``tensornet2.py:159-462``).  Returns ``(x, None)``; with
    ``output_charges`` the per-layer charges are appended to ``x``.
    ``rbf_initial``: a checkpoint's frozen rbf buffers (JAX's
    ``rbf_initial``), in place of the defaults."""

    def __init__(self, hidden_channels=128, q_dim=16, num_layers=2,
                 num_rbf=32, rbf_type="expnorm", trainable_rbf=False,
                 activation="silu", cutoff_lower=0.0, cutoff_upper=4.5,
                 max_num_neighbors=64, max_z=128,
                 equivariance_invariance_group="O(3)", output_charges=False,
                 neighbor_strategy="brute", cells_per_dim=None,
                 cell_capacity=64, pallas_edge_mlp=False,
                 pallas_embedding=False, cell_block_spec=None, q_tab=64,
                 rbf_initial=None, remat=False, dtype=None):
        super().__init__()
        if equivariance_invariance_group not in ("O(3)", "SO(3)"):
            raise ValueError(f'Unknown group "{equivariance_invariance_group}". '
                             "Choose O(3) or SO(3).")
        F = hidden_channels
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.max_num_neighbors = max_num_neighbors
        self.output_charges = output_charges
        self.neighbor_strategy = neighbor_strategy
        self.cells_per_dim = cells_per_dim
        self.cell_capacity = cell_capacity
        self.cell_block_spec = cell_block_spec
        self.q_tab = int(q_tab)
        self.act = get_activation(activation)
        self.distance_expansion = make_rbf(rbf_type, cutoff_lower,
                                           cutoff_upper, num_rbf,
                                           trainable_rbf, rbf_initial)
        self.tensor_embedding = TensorEmbedding(
            F, num_rbf, activation, cutoff_lower, cutoff_upper, max_z,
            pallas_embedding=pallas_embedding, remat=remat)
        self.charge_predict_0 = ChargePredict(F, activation, q_dim)
        self.layers = nn.ModuleList([
            Interaction2(F, num_rbf, q_dim, activation, cutoff_lower,
                         cutoff_upper, equivariance_invariance_group,
                         pallas_edge_mlp=pallas_edge_mlp,
                         cell_block_spec=cell_block_spec, remat=remat)
            for _ in range(num_layers)])
        self.charge_predicts = nn.ModuleList(
            [ChargePredict(F, activation, q_dim) for _ in range(num_layers)])
        self.out_norm = LayerNorm(3 * F)
        self.linear = Linear(3 * F, F)
        set_compute_dtype(self, dtype, skip=(ChargePredict,))

    build_neighbors = build_neighbors

    def forward(self, z, pos, batch, box=None, q=None, atom_mask=None,
                nbr=None, num_mols=None, blocked=False, nbr_emb=None):
        """``nbr_emb`` (dual-list mode, grouped blocked tier): the compact
        list of the embedding; the interactions then see no rbf array
        (reference ``tensornet2.py:358-373``, ``:391``)."""
        if num_mols is None:
            num_mols = int(batch.shape[0])
        if nbr is None:
            nbr = self.build_neighbors(pos, batch, box=box, atom_mask=atom_mask)
        rev_slot = (nbr.rev_slot if nbr.rev_slot is not None
                    else reverse_slots(nbr.idx, nbr.mask))
        delta, dist = neighbor_geometry(pos, nbr, box=box, batch=batch)
        if nbr_emb is not None:
            if not (self.q_tab and self.cell_block_spec is not None):
                raise ValueError("nbr_emb (dual-list) needs the θ-tabulated "
                                 "blocked q-tier (a cell_block_spec and "
                                 "q_tab > 0)")
            nbr_e = nbr_emb
            rev_slot_e = (nbr_e.rev_slot if nbr_e.rev_slot is not None
                          else reverse_slots(nbr_e.idx, nbr_e.mask))
            delta_e, dist_e = neighbor_geometry(pos, nbr_e, box=box,
                                                batch=batch)
        else:
            nbr_e, rev_slot_e, delta_e, dist_e = nbr, rev_slot, delta, dist

        # per-atom total charge Q (reference :376-380); ghosts get 0
        Q_atom = atom_charges(q, batch, pos)

        edge_attr_e = self.distance_expansion(dist_e)
        edge_attr = edge_attr_e if nbr_emb is None else None
        # the rbf at the Chebyshev nodes of the q-tier's series fit
        rbf_nodes = None
        if self.q_tab and self.cell_block_spec is not None:
            rbf_nodes = self.distance_expansion(cheb_nodes(
                self.q_tab, self.cutoff_lower, self.cutoff_upper,
                dtype=dist.dtype, device=dist.device))
        X = self.tensor_embedding(z, nbr_e, dist_e,
                                  unit_vectors(delta_e, dist_e), edge_attr_e,
                                  rev_slot_e)
        charges = self.charge_predict_0(X, batch, Q_atom, num_mols)
        charge_list = [charges]
        for layer, predict in zip(self.layers, self.charge_predicts):
            X = layer(X, charges, nbr, dist, edge_attr, rev_slot,
                      blocked=blocked, rbf_nodes=rbf_nodes)
            charges = predict(X, batch, Q_atom, num_mols)
            charge_list.append(charges)

        x = self.act(self.linear(self.out_norm(irreps_norm3(X))))
        if self.output_charges:
            x = torch.cat([x] + charge_list, dim=-1)
        return x, None
