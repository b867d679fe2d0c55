"""TorchMD-T, the invariant Transformer (deprecated upstream, kept for the
models it trained).

Counterpart of ``torchmdnet_tpu/models/torchmd_t.py``
(``MultiHeadAttention`` ``:30-94``, ``TorchMD_T`` ``:97-168``; reference
``torchmdnet/models/torchmd_t.py``).  Its attention aggregates into
``edge_index[0]`` from ``edge_index[1]``, the dense row format's own
orientation, and has no vector channel.
"""

from torch import nn

from torchmdnet_tpu_torch.models.common import (
    Embedding, LayerNorm, Linear, get_activation, make_rbf,
    set_compute_dtype)
from torchmdnet_tpu_torch.models.tensornet import build_neighbors
from torchmdnet_tpu_torch.models.torchmd_et import (
    DISTANCE_INFLUENCES, NeighborEmbedding, no_blocked_tier)
from torchmdnet_tpu_torch.ops import rbf as rbf_ops
from torchmdnet_tpu_torch.ops.neighbors import NeighborMatrix, neighbor_geometry


class MultiHeadAttention(nn.Module):
    """One T layer (reference ``torchmd_t.py:224-338``): returns ``dx [N,
    F]``.  ``distance_influence`` as in ET."""

    def __init__(self, hidden_channels, num_rbf, distance_influence="both",
                 num_heads=8, activation="silu", attn_activation="silu",
                 cutoff_lower=0.0, cutoff_upper=5.0):
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
        self.act = get_activation(activation)
        self.attn_activation = get_activation(attn_activation)
        self.layernorm = LayerNorm(F)
        self.q_proj = Linear(F, F, init="xavier_zeros")
        self.k_proj = Linear(F, F, init="xavier_zeros")
        self.v_proj = Linear(F, F, init="xavier_zeros")
        self.o_proj = Linear(F, F, init="xavier_zeros")
        self.dk_proj = (Linear(num_rbf, F, init="xavier_zeros")
                        if distance_influence in ("keys", "both") else None)
        self.dv_proj = (Linear(num_rbf, F, init="xavier_zeros")
                        if distance_influence in ("values", "both") else None)

    def forward(self, x, nbr: NeighborMatrix, r_ij, f_ij):
        n, F = x.shape
        H = self.num_heads
        hd = F // H
        k = nbr.idx.shape[1]
        x = self.layernorm(x)
        q = self.q_proj(x).reshape(n, H, hd)
        k_j = self.k_proj(x).reshape(n, H, hd)[nbr.idx]
        v_j = self.v_proj(x).reshape(n, H, hd)[nbr.idx]
        prod = q[:, None] * k_j
        if self.dk_proj is not None:
            prod = prod * self.act(self.dk_proj(f_ij)).reshape(n, k, H, hd)
        cutoff = rbf_ops.cosine_cutoff(r_ij, self.cutoff_upper,
                                       self.cutoff_lower)
        attn = self.attn_activation(prod.sum(dim=-1)) * (
            cutoff * nbr.mask.to(cutoff.dtype))[..., None]
        if self.dv_proj is not None:
            v_j = v_j * self.act(self.dv_proj(f_ij)).reshape(n, k, H, hd)
        return self.o_proj((v_j * attn[..., None]).sum(dim=1).reshape(n, F))


class TorchMD_T(nn.Module):
    """Representation model (reference ``torchmd_t.py:20-205``); returns
    ``(x [N, F], None)``.  It builds its list with self loops."""

    def __init__(self, hidden_channels=128, num_layers=6, num_rbf=50,
                 rbf_type="expnorm", trainable_rbf=True, rbf_initial=None,
                 activation="silu", attn_activation="silu",
                 neighbor_embedding=True, num_heads=8,
                 distance_influence="both", cutoff_lower=0.0,
                 cutoff_upper=5.0, max_z=100, max_num_neighbors=32,
                 neighbor_strategy="brute", cells_per_dim=None,
                 cell_capacity=64, dtype=None):
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
            MultiHeadAttention(F, num_rbf, distance_influence, num_heads,
                               activation, attn_activation, cutoff_lower,
                               cutoff_upper)
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
        _, dist = neighbor_geometry(pos, nbr, box=box, batch=batch)
        edge_attr = self.distance_expansion(dist)
        if self.neighbor_embedding is not None:
            x = self.neighbor_embedding(z, x, nbr, dist, edge_attr)
        for layer in self.attention_layers:
            x = x + layer(x, nbr, dist, edge_attr)
        return self.out_norm(x), None
