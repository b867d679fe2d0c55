"""TorchMD-ET, the Equivariant Transformer (Thölke & de Fabritiis,
ICLR'22), and the neighbour embedding that TorchMD-T and TorchMD-GN share
with it.

Counterpart of ``torchmdnet_tpu/models/torchmd_et.py``
(``NeighborEmbedding`` ``:37-64``, ``EquivariantMultiHeadAttention``
``:67-158``, ``TorchMD_ET`` ``:161-253``; reference
``torchmdnet/models/torchmd_et.py``).  Attention runs over the dense
``[N, K]`` neighbour matrix: the per-edge products are gathers and masked
sums over the K axis, no scatter in the forward.  Every op is plain
PyTorch, so the force pass and its second order (force training) come
from autograd.

Direction: upstream aggregates into ``edge_index[1]`` from
``edge_index[0]`` with ``d_ij = (pos_src − pos_tgt)/r``; the dense row
format's ``delta = pos_row − pos_neighbour``, so the ET direction is the
negated row delta.  Self loops (``loop=True``) keep a zero direction.
"""

import torch
from torch import nn

from torchmdnet_tpu_torch.models.common import (
    Embedding, LayerNorm, Linear, get_activation, make_rbf,
    set_compute_dtype)
from torchmdnet_tpu_torch.models.tensornet import build_neighbors, unit_vectors
from torchmdnet_tpu_torch.ops import rbf as rbf_ops
from torchmdnet_tpu_torch.ops.neighbors import NeighborMatrix, neighbor_geometry

DISTANCE_INFLUENCES = ("keys", "values", "both", "none")


def no_blocked_tier(model, blocked):
    if blocked:
        raise ValueError(f"{type(model).__name__} has no blocked tier "
                         "(blocked=True is TensorNet's and TensorNet2's)")


class NeighborEmbedding(nn.Module):
    """Distance-filtered embedding of the neighbours' types (reference
    ``models/utils.py:45-117``): ``combine(cat[x, Σ_K W·x_nb[idx]])`` with
    ``W = distance_proj(rbf)·cutoff``; self loops are left out."""

    def __init__(self, hidden_channels, num_rbf, cutoff_lower, cutoff_upper,
                 max_z=100):
        super().__init__()
        F = hidden_channels
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.embedding = Embedding(max_z, F)
        self.distance_proj = Linear(num_rbf, F, init="xavier_zeros")
        self.combine = Linear(2 * F, F, init="xavier_zeros")

    def forward(self, z, x, nbr: NeighborMatrix, edge_weight, edge_attr):
        C = rbf_ops.cosine_cutoff(edge_weight, self.cutoff_upper,
                                  self.cutoff_lower)
        W = self.distance_proj(edge_attr) * C[..., None]
        rows = torch.arange(nbr.idx.shape[0], device=nbr.idx.device)[:, None]
        mask = nbr.mask & (nbr.idx != rows)
        msg = W * self.embedding(z)[nbr.idx] * mask[..., None].to(x.dtype)
        return self.combine(torch.cat([x, msg.sum(dim=1)], dim=-1))


class EquivariantMultiHeadAttention(nn.Module):
    """One ET layer (reference ``torchmd_et.py:242-431``): returns the
    residual updates ``(dx [N, F], dvec [N, 3, F])``.

    ``distance_influence`` gates the keys (``dk_proj``), the values
    (``dv_proj``), both or neither; a projection exists only where its
    gate is on.  ``vector_cutoff`` moves the cosine cutoff from the
    attention weights onto the gathered values, so that it weights the
    vector message too (the continuity fix); the attention then keeps
    only the mask."""

    def __init__(self, hidden_channels, num_rbf, distance_influence="both",
                 num_heads=8, activation="silu", attn_activation="silu",
                 cutoff_lower=0.0, cutoff_upper=5.0, vector_cutoff=False):
        super().__init__()
        if distance_influence not in DISTANCE_INFLUENCES:
            raise ValueError(f"distance_influence={distance_influence!r}: "
                             f"choose from {', '.join(DISTANCE_INFLUENCES)}")
        if hidden_channels % num_heads:
            raise ValueError(f"embedding_dimension {hidden_channels} is not "
                             f"a multiple of num_heads {num_heads}")
        F = hidden_channels
        self.num_heads = num_heads
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.vector_cutoff = vector_cutoff
        self.act = get_activation(activation)
        self.attn_activation = get_activation(attn_activation)
        self.layernorm = LayerNorm(F)
        self.q_proj = Linear(F, F, init="xavier_zeros")
        self.k_proj = Linear(F, F, init="xavier_zeros")
        self.v_proj = Linear(F, 3 * F, init="xavier_zeros")
        self.o_proj = Linear(F, 3 * F, init="xavier_zeros")
        self.vec_proj = Linear(F, 3 * F, bias=False, init="xavier_zeros")
        self.dk_proj = (Linear(num_rbf, F, init="xavier_zeros")
                        if distance_influence in ("keys", "both") else None)
        self.dv_proj = (Linear(num_rbf, 3 * F, init="xavier_zeros")
                        if distance_influence in ("values", "both") else None)

    def forward(self, x, vec, nbr: NeighborMatrix, r_ij, f_ij, d_ij):
        n, F = x.shape
        H = self.num_heads
        hd = F // H
        k = nbr.idx.shape[1]
        x = self.layernorm(x)
        q = self.q_proj(x).reshape(n, H, hd)
        key = self.k_proj(x).reshape(n, H, hd)
        v = self.v_proj(x).reshape(n, H, 3 * hd)
        vec1, vec2, vec3 = torch.split(self.vec_proj(vec), F, dim=-1)
        vec_dot = (vec1 * vec2).sum(dim=1)  # [N, F]

        idx, emask = nbr.idx, nbr.mask
        k_j = key[idx]  # [N, K, H, hd]
        v_j = v[idx]  # [N, K, H, 3 hd]
        vec_j = vec.reshape(n, 3, H, hd)[idx]  # [N, K, 3, H, hd]

        prod = q[:, None] * k_j
        if self.dk_proj is not None:
            prod = prod * self.act(self.dk_proj(f_ij)).reshape(n, k, H, hd)
        attn = self.attn_activation(prod.sum(dim=-1))  # [N, K, H]
        cutoff = rbf_ops.cosine_cutoff(r_ij, self.cutoff_upper,
                                       self.cutoff_lower)
        if self.vector_cutoff:
            v_j = v_j * cutoff[..., None, None]
            attn = attn * emask.to(attn.dtype)[..., None]
        else:
            attn = attn * (cutoff * emask.to(cutoff.dtype))[..., None]
        if self.dv_proj is not None:
            v_j = v_j * self.act(self.dv_proj(f_ij)).reshape(n, k, H, 3 * hd)
        xe, vec1e, vec2e = torch.split(v_j, hd, dim=-1)  # [N, K, H, hd]

        xm = (xe * attn[..., None]).sum(dim=1).reshape(n, F)
        # the vector message; ET's direction is the negated row delta
        vmsg = (vec_j * vec1e[:, :, None]
                + vec2e[:, :, None] * (-d_ij)[..., None, None])
        vmsg = vmsg * emask[..., None, None, None].to(vmsg.dtype)
        vm = vmsg.sum(dim=1).reshape(n, 3, F)

        o1, o2, o3 = torch.split(self.o_proj(xm), F, dim=-1)
        dx = vec_dot * o2 + o3
        dvec = vec3 * o1[:, None, :] + vm
        return dx, dvec


class TorchMD_ET(nn.Module):
    """Representation model (reference ``torchmd_et.py:19-239``); returns
    ``(x [N, F], vec [N, 3, F])``.  It builds its list with self loops
    (``loop=True``).  ``dtype`` (``precision=16``: bfloat16) is the
    layers' compute dtype; ``rbf_initial``: a checkpoint's frozen rbf
    buffers."""

    def __init__(self, hidden_channels=128, num_layers=6, num_rbf=50,
                 rbf_type="expnorm", trainable_rbf=True, rbf_initial=None,
                 activation="silu", attn_activation="silu",
                 neighbor_embedding=True, num_heads=8,
                 distance_influence="both", cutoff_lower=0.0,
                 cutoff_upper=5.0, max_z=100, max_num_neighbors=32,
                 vector_cutoff=False, neighbor_strategy="brute",
                 cells_per_dim=None, cell_capacity=64, dtype=None):
        super().__init__()
        F = hidden_channels
        self.hidden_channels = F
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.max_num_neighbors = max_num_neighbors
        self.neighbor_strategy = neighbor_strategy
        self.cells_per_dim = cells_per_dim
        self.cell_capacity = cell_capacity
        self.embedding = Embedding(max_z, F)
        self.distance_expansion = make_rbf(rbf_type, cutoff_lower,
                                           cutoff_upper, num_rbf,
                                           trainable_rbf, rbf_initial)
        self.neighbor_embedding = (
            NeighborEmbedding(F, num_rbf, cutoff_lower, cutoff_upper, max_z)
            if neighbor_embedding else None)
        self.attention_layers = nn.ModuleList([
            EquivariantMultiHeadAttention(
                F, num_rbf, distance_influence, num_heads, activation,
                attn_activation, cutoff_lower, cutoff_upper, vector_cutoff)
            for _ in range(num_layers)])
        self.out_norm = LayerNorm(F)
        set_compute_dtype(self, dtype)

    build_neighbors = build_neighbors

    def forward(self, z, pos, batch, box=None, q=None, atom_mask=None,
                nbr=None, num_mols=None, blocked=False):
        no_blocked_tier(self, blocked)
        x = self.embedding(z)
        if nbr is None:
            nbr = self.build_neighbors(pos, batch, box=box, atom_mask=atom_mask)
        delta, dist = neighbor_geometry(pos, nbr, box=box, batch=batch)
        edge_attr = self.distance_expansion(dist)
        edge_vec_norm = unit_vectors(delta, dist)
        if self.neighbor_embedding is not None:
            x = self.neighbor_embedding(z, x, nbr, dist, edge_attr)
        vec = x.new_zeros(x.shape[0], 3, x.shape[1])
        for layer in self.attention_layers:
            dx, dvec = layer(x, vec, nbr, dist, edge_attr, edge_vec_norm)
            x = x + dx
            vec = vec + dvec
        return self.out_norm(x), vec
