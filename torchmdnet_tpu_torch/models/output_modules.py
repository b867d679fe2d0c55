"""Output heads; counterpart of ``torchmdnet_tpu/models/output_modules.py``:
``reduce_atoms`` (sum or the reference's mean), the ``OutputModel`` base,
every head of JAX ``OUTPUT_MODULES`` (``:349-358``) and the list,
windowed and all-to-all paths of ``ScalarPlusWeightedCoulomb``.

Ghost (padding) atoms sit in the extra segment ``num_mols`` and are
dropped by :func:`reduce_atoms`.  The ``Equivariant*`` heads read the
representation's vector features ``v [N, 3, F]``, which only the
Equivariant Transformer produces: ``create_model`` builds them on it,
and on it alone, by JAX's naming rule (``output_model="Scalar"`` →
``EquivariantScalar``).
"""

import math

import torch
from torch import nn

from torchmdnet_tpu_torch.models.common import GatedEquivariantBlock, MLP
from torchmdnet_tpu_torch.ops.coulomb import coulomb_cutoff_energy_w
from torchmdnet_tpu_torch.ops.neighbors import build_neighbor_matrix
from torchmdnet_tpu_torch.ops.segment import segment_mean, segment_sum
from torchmdnet_tpu_torch.ops.windowed_coulomb import windowed_coulomb_energy
from torchmdnet_tpu_torch.utils.periodic_table import ATOMIC_MASSES


def reduce_atoms(x, batch, num_mols: int, reduce_op: str = "sum"):
    """Per-molecule reduction; ghost atoms (``batch == num_mols``) are
    dropped.  ``"mean"`` divides by the atom count + 1, as the reference
    does (``ops/segment.py::segment_mean``)."""
    if reduce_op in ("sum", "add"):
        out = segment_sum(x, batch, num_mols + 1)
    elif reduce_op == "mean":
        out = segment_mean(x, batch, num_mols + 1)
    else:
        raise ValueError(f"Unsupported reduce_op {reduce_op!r}")
    return out[:num_mols]


def center_of_mass(z, pos, batch, num_mols: int):
    """Each molecule's centre of mass, with a zero row appended for the
    ghost segment: ``[num_mols + 1, 3]`` (JAX ``:33-38``, ``:116-118``)."""
    mass = torch.as_tensor(ATOMIC_MASSES, dtype=pos.dtype,
                           device=pos.device)[z][:, None]
    c = reduce_atoms(mass * pos, batch, num_mols) / reduce_atoms(
        mass, batch, num_mols)
    return torch.cat([c, c.new_zeros(1, 3)])


def _from_center(z, pos, batch, num_mols):
    """``pos − c[batch]``; ghosts measured from the origin."""
    c = center_of_mass(z, pos, batch, num_mols)
    return pos - c[torch.clamp(batch, max=num_mols)]


class OutputModel(nn.Module):
    """pre_reduce (per atom) → reduce → post_reduce (per molecule), JAX
    ``:41-57``.  ``allow_prior_model = False`` makes ``create_model`` drop
    the priors (JAX ``models/model.py:365-366``); ``needs_vectors`` marks
    the heads that read ``v``."""

    allow_prior_model = True
    needs_vectors = False

    def __init__(self, hidden_channels=128, activation="silu",
                 reduce_op="sum", num_hidden_layers=0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.activation = activation
        self.reduce_op = reduce_op
        self.num_hidden_layers = num_hidden_layers

    def pre_reduce(self, x, v, z, pos, batch, box=None, num_mols=None,
                   nbr=None, win=None):
        raise NotImplementedError

    def reduce(self, x, batch, num_mols):
        return reduce_atoms(x, batch, num_mols, self.reduce_op)

    def post_reduce(self, x):
        return x


class Scalar(OutputModel):
    """MLP energy head (reference ``output_modules.py:79-117``)."""

    def __init__(self, hidden_channels=128, activation="silu",
                 reduce_op="sum", num_hidden_layers=0):
        super().__init__(hidden_channels, activation, reduce_op,
                         num_hidden_layers)
        self.output_network = MLP(hidden_channels, 1, hidden_channels // 2,
                                  activation, num_hidden_layers)

    def pre_reduce(self, x, v, z, pos, batch, box=None, num_mols=None,
                   nbr=None, win=None):
        return self.output_network(x)


class EquivariantScalar(OutputModel):
    """Two gated equivariant blocks (reference ``output_modules.py:
    120-163``); keys ``output_network.0.``/``.1.`` as upstream's
    ``ModuleList`` writes them (the JAX package writes
    ``output_network_0.``/``_1.``; the loader reads both)."""

    needs_vectors = True

    def __init__(self, hidden_channels=128, activation="silu",
                 reduce_op="sum", num_hidden_layers=0):
        super().__init__(hidden_channels, activation, reduce_op,
                         num_hidden_layers)
        self.output_network = nn.ModuleList([
            GatedEquivariantBlock(hidden_channels, hidden_channels // 2,
                                  activation=activation,
                                  scalar_activation=True),
            GatedEquivariantBlock(hidden_channels // 2, 1,
                                  activation=activation)])

    def blocks(self, x, v):
        for layer in self.output_network:
            x, v = layer(x, v)
        return x, v

    def pre_reduce(self, x, v, z, pos, batch, box=None, num_mols=None,
                   nbr=None, win=None):
        # the reference adds v.sum()·0 to tie every weight into its graph;
        # autograd needs no such term
        return self.blocks(x, v)[0]


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class DipoleMoment(Scalar):
    """Magnitude of the dipole about the centre of mass (reference
    ``:166-206``): per-atom charges × (pos − c), summed, then the norm.
    The norm's gradient at a zero dipole is NaN, as in JAX."""

    allow_prior_model = False

    def pre_reduce(self, x, v, z, pos, batch, box=None, num_mols=None,
                   nbr=None, win=None):
        return self.output_network(x) * _from_center(z, pos, batch,
                                                     num_mols)

    def post_reduce(self, x):
        return _norm(x)


class EquivariantDipoleMoment(EquivariantScalar):
    """Reference ``output_modules.py:209-242``."""

    allow_prior_model = False

    def pre_reduce(self, x, v, z, pos, batch, box=None, num_mols=None,
                   nbr=None, win=None):
        x, v = self.blocks(x, v)
        return x * _from_center(z, pos, batch, num_mols) + v.squeeze(-1)

    def post_reduce(self, x):
        return _norm(x)


class ElectronicSpatialExtent(OutputModel):
    """Σ_i q_i |pos_i − c|² (reference ``output_modules.py:245-290``)."""

    allow_prior_model = False

    def __init__(self, hidden_channels=128, activation="silu",
                 reduce_op="sum", num_hidden_layers=0):
        super().__init__(hidden_channels, activation, reduce_op,
                         num_hidden_layers)
        self.output_network = MLP(hidden_channels, 1, hidden_channels // 2,
                                  activation, num_hidden_layers)

    def pre_reduce(self, x, v, z, pos, batch, box=None, num_mols=None,
                   nbr=None, win=None):
        d = _from_center(z, pos, batch, num_mols)
        return (d * d).sum(dim=-1, keepdim=True) * self.output_network(x)


class EquivariantElectronicSpatialExtent(ElectronicSpatialExtent):
    """An alias, as in the reference: it reads no vector features."""


class EquivariantVectorOutput(EquivariantScalar):
    """Per-atom vectors (reference ``output_modules.py:297-320``)."""

    allow_prior_model = False

    def pre_reduce(self, x, v, z, pos, batch, box=None, num_mols=None,
                   nbr=None, win=None):
        return self.blocks(x, v)[1].squeeze(-1)


def exp_cutoff(d, rc: float):
    """AIMNet2 short-range damping (reference ``output_modules.py:
    323-332``, JAX ``:186-189``)."""
    t = torch.clamp(d / rc, 0.0, 1.0 - 1e-6)
    return torch.exp(-1.0 / (1.0 - t * t)) / 0.36787944117144233


def all_to_all_coulomb(pos, batch, charges, qw, num_mols, factor: float):
    """Per-atom energies of the multi-channel charges over every pair of
    atoms of one molecule (``coulomb_cutoff=None``, JAX ``:277-296``),
    written as JAX writes it: the full ``[N, N]`` pair matrices, masked
    to same-molecule pairs of valid atoms off the diagonal.  The diagonal's
    zero distance goes through ``sqrt(where(d² > 0, d², 1))``, which keeps
    its gradient finite (``torch.cdist`` differs there)."""
    n = pos.shape[0]
    pair_mask = (batch[:, None] == batch[None, :]) & ~torch.eye(
        n, dtype=torch.bool, device=pos.device)
    if num_mols is not None:
        valid = batch < num_mols
        pair_mask = pair_mask & valid[:, None] & valid[None, :]
    diff = pos[:, None, :] - pos[None, :, :]
    d2 = (diff * diff).sum(dim=-1)
    d = torch.sqrt(torch.where(d2 > 0, d2, 1.0))
    fc = 1.0 - exp_cutoff(d, 4.6)
    # Σ_c qw_c·q_i[c]·q_j[c] as one [N, C] × [C, N] product
    qq = (charges * qw) @ charges.T
    e_pair = factor * fc * qq / (d * qw.sum())
    return torch.where(pair_mask, e_pair, 0.0).sum(dim=1)


class ScalarPlusWeightedCoulomb(Scalar):
    """Scalar energy plus the multi-channel predicted-charge Coulomb energy
    (reference ``output_modules.py:344-609``): over a cutoff neighbor list
    with a reaction field (the list path, ``:298-343``), or with
    ``coulomb_cutoff=None`` over every pair of each molecule
    (:func:`all_to_all_coulomb`; the AceFF recipe,
    ``examples/TensorNet2-AceFF.yaml``).

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
        self.coulomb_cutoff = (None if coulomb_cutoff is None
                               else float(coulomb_cutoff))
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

    def pre_reduce(self, x, v, z, pos, batch, box=None, num_mols=None,
                   nbr=None, win=None):
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
        if self.coulomb_cutoff is None:
            if box is not None:
                raise ValueError(
                    "PBC is not supported with coulomb_cutoff = None")
            e_i = all_to_all_coulomb(pos, batch, charges,
                                     self.qweights.to(x.dtype), num_mols,
                                     self.FACTOR)
            return x + e_i[:, None]
        if nbr is None:
            nbr = self.build_coulomb_neighbors(pos, batch, box, num_mols)
        e_i = coulomb_cutoff_energy_w(
            pos, self.qweights.to(x.dtype), charges, nbr.idx, nbr.mask,
            self.coulomb_cutoff, self.epsilon_solvent, self.factor, box,
            batch)
        return x + e_i[:, None]


OUTPUT_MODULES = {
    "Scalar": Scalar,
    "EquivariantScalar": EquivariantScalar,
    "DipoleMoment": DipoleMoment,
    "EquivariantDipoleMoment": EquivariantDipoleMoment,
    "ElectronicSpatialExtent": ElectronicSpatialExtent,
    "EquivariantElectronicSpatialExtent": EquivariantElectronicSpatialExtent,
    "EquivariantVectorOutput": EquivariantVectorOutput,
    "ScalarPlusWeightedCoulomb": ScalarPlusWeightedCoulomb,
}
