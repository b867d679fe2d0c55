"""TorchMD-GN, a SchNet-style graph network of continuous-filter
convolutions (deprecated upstream, kept for the models it trained).

Counterpart of ``torchmdnet_tpu/models/torchmd_gn.py`` (``CFConv``
``:30-75``, ``InteractionBlock`` ``:78-105``, ``TorchMD_GN`` ``:108-186``;
reference ``torchmdnet/models/torchmd_gn.py``).  Messages aggregate into
``edge_index[0]`` from ``edge_index[1]``, the row orientation, with
``aggr`` ∈ {add, mean, max} over the K axis.  The list has no self loops
(``loop=False``); the MD step's list has them (ROADMAP Queue 3 item 6).

Upstream's ``InteractionBlock`` holds the filter network as ``mlp`` and
hands the same module to its ``CFConv`` as ``net``.  Here the block owns
it and passes it to the convolution at each call, so the state dict has
one key per weight, ``interactions.{i}.mlp.{0,2}``, as the JAX package's
files write it (``utils/checkpoint.py`` maps upstream's ``conv.net``
copies onto it).
"""

import torch
from torch import nn

from torchmdnet_tpu_torch.models.common import (
    Activation, Embedding, Linear, get_activation, make_rbf,
    set_compute_dtype)
from torchmdnet_tpu_torch.models.torchmd_et import (
    NeighborEmbedding, no_blocked_tier)
from torchmdnet_tpu_torch.ops import rbf as rbf_ops
from torchmdnet_tpu_torch.ops.neighbors import (
    NeighborMatrix, build_neighbor_matrix, neighbor_geometry)

AGGREGATIONS = ("add", "mean", "max")


class CFConv(nn.Module):
    """Continuous-filter convolution (reference ``torchmd_gn.py:291-336``):
    ``lin2(aggr_K(net(rbf)·cutoff · lin1(x)[idx]))``."""

    def __init__(self, hidden_channels, num_filters, cutoff_lower,
                 cutoff_upper, aggr="add"):
        super().__init__()
        if aggr not in AGGREGATIONS:
            raise ValueError(f"aggr={aggr!r}: choose from "
                             f"{', '.join(AGGREGATIONS)}")
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.aggr = aggr
        self.lin1 = Linear(hidden_channels, num_filters, bias=False,
                           init="xavier_zeros")
        self.lin2 = Linear(num_filters, hidden_channels, init="xavier_zeros")

    def forward(self, x, nbr: NeighborMatrix, edge_weight, edge_attr, net):
        C = rbf_ops.cosine_cutoff(edge_weight, self.cutoff_upper,
                                  self.cutoff_lower)
        msg = net(edge_attr) * C[..., None] * self.lin1(x)[nbr.idx]
        m = nbr.mask[..., None].to(msg.dtype)
        if self.aggr == "add":
            out = (msg * m).sum(dim=1)
        elif self.aggr == "mean":
            # the reference's scatter-mean counts its zero initial value:
            # the denominator is the count + 1 (ops/segment.py)
            out = (msg * m).sum(dim=1) / torch.clamp(m.sum(dim=1) + 1.0,
                                                     min=1.0)
        else:
            # amax shares the gradient among ties, as JAX's max does; a
            # row with no neighbour gives 0
            out = torch.amax(torch.where(m > 0, msg, float("-inf")), dim=1)
            out = torch.where(m.sum(dim=1) > 0, out, 0.0)
        return self.lin2(out)


class InteractionBlock(nn.Module):
    """Reference ``torchmd_gn.py:230-288``: ``lin(act(conv(x)))``; the
    filter network ``mlp`` is ``Linear(R, F′) → act → Linear(F′, F′)``."""

    def __init__(self, hidden_channels, num_rbf, num_filters, activation,
                 cutoff_lower, cutoff_upper, aggr="add"):
        super().__init__()
        self.mlp = nn.Sequential(
            Linear(num_rbf, num_filters, init="xavier_zeros"),
            Activation(activation),
            Linear(num_filters, num_filters, init="xavier_zeros"))
        self.conv = CFConv(hidden_channels, num_filters, cutoff_lower,
                           cutoff_upper, aggr)
        self.act = get_activation(activation)
        self.lin = Linear(hidden_channels, hidden_channels,
                          init="xavier_zeros")

    def forward(self, x, nbr: NeighborMatrix, edge_weight, edge_attr):
        x = self.conv(x, nbr, edge_weight, edge_attr, self.mlp)
        return self.lin(self.act(x))


class TorchMD_GN(nn.Module):
    """Representation model (reference ``torchmd_gn.py:18-228``); returns
    ``(x [N, F], None)``.  It builds its own list without self loops."""

    def __init__(self, hidden_channels=128, num_filters=128, num_layers=6,
                 num_rbf=50, rbf_type="expnorm", trainable_rbf=True,
                 rbf_initial=None, activation="silu",
                 neighbor_embedding=True, cutoff_lower=0.0,
                 cutoff_upper=5.0, max_z=100, max_num_neighbors=32,
                 aggr="add", neighbor_strategy="brute", cells_per_dim=None,
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
        self.interactions = nn.ModuleList([
            InteractionBlock(F, num_rbf, num_filters, activation,
                             cutoff_lower, cutoff_upper, aggr)
            for _ in range(num_layers)])
        set_compute_dtype(self, dtype)

    def build_neighbors(self, pos, batch, box=None, atom_mask=None):
        """The model's own list: its strategy, cutoffs and
        ``max_num_neighbors``, without self loops."""
        kwargs = {}
        if self.neighbor_strategy == "cell":
            kwargs = dict(cells_per_dim=self.cells_per_dim,
                          cell_capacity=self.cell_capacity)
        return build_neighbor_matrix(
            pos, batch, strategy=self.neighbor_strategy,
            k_max=self.max_num_neighbors, cutoff_upper=self.cutoff_upper,
            cutoff_lower=self.cutoff_lower, loop=False, box=box,
            atom_mask=atom_mask, **kwargs)

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
        for block in self.interactions:
            x = x + block(x, nbr, dist, edge_attr)
        return x, None
