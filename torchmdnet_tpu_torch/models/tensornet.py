"""TensorNet trunk pieces used by TensorNet2.

Counterpart of ``torchmdnet_tpu/models/tensornet.py``: ``PairLinear``,
``TensorEmbedding`` (``:201-325``), ``linear_irreps`` and the gather
branch of ``edge_message_passing`` (``:143-153``).  The embedding's fused
branch runs kernels 1 and 2 (``ops/radial_embedding.py``).
"""

import torch
from torch import nn

from torchmdnet_tpu_torch.models.common import (
    Embedding, LayerNorm, Linear, get_activation)
from torchmdnet_tpu_torch.ops import rbf as rbf_ops
from torchmdnet_tpu_torch.ops.message_passing import (
    gather_nodes, packed_neighbor_sum_asym)
from torchmdnet_tpu_torch.ops.neighbors import NeighborMatrix
from torchmdnet_tpu_torch.ops.radial_embedding import (
    radial_embedding, radial_embedding_ref)
from torchmdnet_tpu_torch.ops.tensor_algebra import (
    Irreps, tensor_frobenius_norm2)


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


def edge_message_passing(attr3f, irr: Irreps, nbr: NeighborMatrix,
                         attr_rev) -> Irreps:
    """TensorNet message pass over the neighbor matrix with
    direction-dependent edge weights ``attr3f [N, K, 3F]`` (cutoff- and
    pad-masked; block 0 weights I, 1 weights A, 2 weights S) and their
    recomputed reverse ``attr_rev``."""
    n, f = irr.I.shape
    msg = packed_neighbor_sum_asym(attr3f, attr_rev, pack9(irr), nbr.idx,
                                   nbr.mask)
    return split9(msg, n, f)


class PairLinear(nn.Linear):
    """Upstream ``nn.Linear(2F, F)`` on ``cat(Z_i, Z_j)``, lifted to node
    level: returns ``(Z·W₁ᵀ + b, Z·W₂ᵀ)`` — a 64× saving over applying it
    on the edge axis."""

    def __init__(self, features):
        super().__init__(2 * features, features)

    def reset_parameters(self, generator=None):
        bound = 1.0 / (self.in_features ** 0.5)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, Z):
        f = Z.shape[-1]
        zw1 = Z @ self.weight[:, :f].t() + self.bias
        zw2 = Z @ self.weight[:, f:].t()
        return zw1, zw2


class TensorEmbedding(nn.Module):
    """Edge-wise tensor embedding (reference ``tensornet.py:448-619``)."""

    def __init__(self, hidden_channels, num_rbf, activation="silu",
                 cutoff_lower=0.0, cutoff_upper=4.5, max_z=128,
                 pallas_embedding=False):
        super().__init__()
        F = hidden_channels
        self.hidden_channels = F
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

    def forward(self, z, nbr: NeighborMatrix, edge_weight, edge_vec_norm,
                edge_attr, rev_slot):
        F = self.hidden_channels
        idx, emask = nbr.idx, nbr.mask
        zw1, zw2 = self.emb2(self.emb(z))
        zw2g = gather_nodes(zw2, idx, rev_slot, emask)
        projs = (self.distance_proj1, self.distance_proj2, self.distance_proj3)
        kall = torch.cat([p.weight.t() for p in projs], dim=1)
        ball = torch.cat([p.bias for p in projs])
        C = rbf_ops.cosine_cutoff(edge_weight, self.cutoff_upper,
                                  self.cutoff_lower)
        em = emask.to(edge_attr.dtype)
        v = edge_vec_norm
        args = (edge_attr.contiguous(), C.contiguous(), v[..., 0].contiguous(),
                v[..., 1].contiguous(), v[..., 2].contiguous(),
                zw1.contiguous(), zw2g.contiguous(), em, kall, ball)
        # kernels 1/2: the dp/cz/w chain stays on chip, only [N, 9F] is
        # written; otherwise the plain chain under autograd
        embed = radial_embedding if self.fused else radial_embedding_ref
        out9 = embed(*args)
        X = split9(out9, z.shape[0], F)

        norm = self.init_norm(tensor_frobenius_norm2(X))
        norm = self.act(self.linears_scalar[0](norm))
        norm = self.act(self.linears_scalar[1](norm)).reshape(-1, 3, F)
        X = linear_irreps(X, self.linears_tensor)
        return Irreps(X.I * norm[:, 0, :], X.A * norm[:, 1, None, :],
                      X.S * norm[:, 2, None, :])
