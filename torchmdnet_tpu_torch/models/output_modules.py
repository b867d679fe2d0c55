"""Output heads; counterpart of ``torchmdnet_tpu/models/output_modules.py``
(``reduce_atoms``, ``Scalar`` and the list and windowed paths of
``ScalarPlusWeightedCoulomb``).

Ghost (padding) atoms sit in the extra segment ``num_mols`` and are
dropped by :func:`reduce_atoms`.
"""

import math

import torch
from torch import nn

from torchmdnet_tpu_torch.models.common import MLP
from torchmdnet_tpu_torch.ops.coulomb import coulomb_cutoff_energy_w
from torchmdnet_tpu_torch.ops.neighbors import build_neighbor_matrix
from torchmdnet_tpu_torch.ops.segment import segment_sum
from torchmdnet_tpu_torch.ops.windowed_coulomb import windowed_coulomb_energy


def reduce_atoms(x, batch, num_mols: int, reduce_op: str = "sum"):
    """Per-molecule sum; ghost atoms (``batch == num_mols``) are dropped."""
    if reduce_op not in ("sum", "add"):
        raise NotImplementedError(
            f"reduce_op={reduce_op!r}: only 'sum' is ported (ROADMAP Queue 1, "
            "'Remaining heads and wrappers')")
    return segment_sum(x, batch, num_mols + 1)[:num_mols]


class Scalar(nn.Module):
    """MLP energy head (reference ``output_modules.py:79-117``)."""

    def __init__(self, hidden_channels=128, activation="silu",
                 reduce_op="sum", num_hidden_layers=0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.reduce_op = reduce_op
        self.output_network = MLP(hidden_channels, 1, hidden_channels // 2,
                                  activation, num_hidden_layers)

    def pre_reduce(self, x, z, pos, batch, box=None, num_mols=None, nbr=None,
                   win=None):
        return self.output_network(x)

    def reduce(self, x, batch, num_mols):
        return reduce_atoms(x, batch, num_mols, self.reduce_op)


class ScalarPlusWeightedCoulomb(Scalar):
    """Scalar energy plus the multi-channel predicted-charge Coulomb energy
    over a cutoff neighbor list with a reaction field (reference
    ``output_modules.py:344-609``; the list path, ``:298-343``).

    Expects ``x = [N, hidden + (num_layers+1)·q_dim]`` with the per-layer
    charges appended by TensorNet2.
    """

    # 0.5 · Hartree · Bohr (eV·Å Coulomb constant / 2), reference :397-401
    FACTOR = 0.5 * 27.211386024367243 * 0.5291772105638411

    def __init__(self, hidden_channels=128, activation="silu",
                 reduce_op="sum", num_hidden_layers=0, q_dim=16,
                 num_interaction_layers=2, q_weights=(), coulomb_cutoff=None,
                 coulomb_max_num_neighbors=None,
                 coulomb_neighbor_strategy="brute",
                 coulomb_cells_per_dim=None, coulomb_cell_capacity=64,
                 coulomb_cell_stencil=1, epsilon_solvent=78.3):
        super().__init__(hidden_channels, activation, reduce_op,
                         num_hidden_layers)
        if coulomb_cutoff is None:
            raise NotImplementedError(
                "coulomb_cutoff=None (all-to-all Coulomb) is not ported "
                "(ROADMAP Queue 1, 'Coulomb head')")
        if len(q_weights) != num_interaction_layers + 1:
            raise ValueError("q_weights must have one entry per interaction "
                             "layer + 1")
        w = torch.tensor([[float(v) for v in row] for row in q_weights],
                         dtype=torch.float32)
        if w.shape[1] != q_dim:
            raise ValueError(f"q_weights rows must have q_dim={q_dim} entries")
        self.register_buffer("qweights", w.flatten(), persistent=False)
        # static channel-weight total, from the config
        self.factor = self.FACTOR / sum(float(v) for row in q_weights
                                        for v in row)
        self.coulomb_cutoff = float(coulomb_cutoff)
        self.coulomb_max_num_neighbors = coulomb_max_num_neighbors
        self.coulomb_neighbor_strategy = coulomb_neighbor_strategy
        self.coulomb_cells_per_dim = coulomb_cells_per_dim
        self.coulomb_cell_capacity = coulomb_cell_capacity
        self.coulomb_cell_stencil = coulomb_cell_stencil
        self.epsilon_solvent = epsilon_solvent

    def coulomb_max_neighbors(self) -> int:
        """Default list budget: the per-row mean at water-like density plus
        35% Poisson headroom (reference :420-423, JAX ``:235-245``)."""
        if self.coulomb_max_num_neighbors is not None:
            return int(self.coulomb_max_num_neighbors)
        volume = 4.0 / 3.0 * math.pi * self.coulomb_cutoff ** 3
        return int(0.1 * volume * 1.35) + 16

    def build_coulomb_neighbors(self, pos, batch, box=None, num_mols=None):
        kwargs = {}
        if self.coulomb_neighbor_strategy == "cell":
            kwargs = dict(cells_per_dim=self.coulomb_cells_per_dim,
                          cell_capacity=self.coulomb_cell_capacity,
                          stencil=self.coulomb_cell_stencil)
        return build_neighbor_matrix(
            pos, batch, strategy=self.coulomb_neighbor_strategy,
            k_max=self.coulomb_max_neighbors(),
            cutoff_upper=self.coulomb_cutoff, loop=False, box=box,
            atom_mask=(batch < num_mols) if num_mols is not None else None,
            **kwargs)

    def pre_reduce(self, x, z, pos, batch, box=None, num_mols=None, nbr=None,
                   win=None):
        """``nbr``: a Coulomb neighbor list (MD passes a skin-cached one;
        edges beyond the cutoff are re-masked by the energy op).  ``win``:
        the rebuild's :class:`~torchmdnet_tpu_torch.ops.windowed_coulomb.
        CoulombWindows` over the cell-blocked sort ``pos`` is in; the head
        then evaluates every window pair directly (kernels C and D,
        ``output_modules.py:254-275``) and needs no list."""
        charges = x[:, self.hidden_channels:]
        x = self.output_network(x[:, :self.hidden_channels])
        if win is not None:
            e_i = windowed_coulomb_energy(
                pos, self.qweights.to(x.dtype), charges, win,
                self.coulomb_cutoff, self.epsilon_solvent, self.factor)
            return x + e_i[:, None]
        if nbr is None:
            nbr = self.build_coulomb_neighbors(pos, batch, box, num_mols)
        e_i = coulomb_cutoff_energy_w(
            pos, self.qweights.to(x.dtype), charges, nbr.idx, nbr.mask,
            self.coulomb_cutoff, self.epsilon_solvent, self.factor, box,
            batch)
        return x + e_i[:, None]
