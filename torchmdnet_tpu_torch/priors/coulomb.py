"""Cosine-switched Coulomb prior on a dataset's partial charges
(counterpart of ``torchmdnet_tpu/priors/coulomb.py``, reference
``torchmdnet/priors/coulomb.py``)."""

import math

import numpy as np
import torch

from torchmdnet_tpu_torch.ops.segment import segment_sum
from torchmdnet_tpu_torch.priors.base import BasePrior, prior_pairs


class Coulomb(BasePrior):
    """Coulomb energy from ``extra_args["partial_charges"]``, switched on
    between the lower and upper switch distances (reference
    ``coulomb.py:107-125``).  Like the reference it works in nanometers
    (positions × 1e9·distance_scale) with an unbounded cutoff: all pairs
    of a molecule, up to ``max_num_neighbors`` a row.  The box, when
    given, is passed to the list as it is (in the positions' own unit),
    as the JAX package does."""

    def __init__(self, lower_switch_distance: float = 0.0,
                 upper_switch_distance: float = 1.0,
                 max_num_neighbors: int = 32, distance_scale: float = 1e-10,
                 energy_scale: float = 1.0):
        super().__init__()
        self.lower_switch_distance = float(lower_switch_distance)
        self.upper_switch_distance = float(upper_switch_distance)
        self.max_num_neighbors = int(max_num_neighbors)
        self.distance_scale = float(distance_scale)
        self.energy_scale = float(energy_scale)

    def post_reduce(self, y, z, pos, batch, box=None, extra_args=None,
                    num_mols=None):
        num_mols = int(y.shape[0]) if num_mols is None else num_mols
        x = 1e9 * self.distance_scale * pos  # → nm
        nbr, dist = prior_pairs(
            x, batch, box, num_mols,
            cutoff=float(np.finfo(np.float32).max) ** 0.5,
            k_max=self.max_num_neighbors)
        q = torch.as_tensor(extra_args["partial_charges"],
                            device=pos.device).to(pos.dtype)
        lower = self.lower_switch_distance
        upper = self.upper_switch_distance
        phase = (torch.clamp(dist, lower, upper) - lower) / (upper - lower)
        safe_d = torch.where(dist > 0, dist, 1.0)
        e_pair = ((0.5 - 0.5 * torch.cos(math.pi * phase))
                  * q[:, None] * q[nbr.idx] / safe_d)
        e_pair = torch.where(nbr.mask, e_pair, 0.0)
        scale = 0.5 * (2.30707e-28 / self.energy_scale / self.distance_scale)
        e_mol = scale * segment_sum(e_pair.sum(dim=1), batch,
                                    num_mols + 1)[:num_mols]
        return y + e_mol.reshape(y.shape).to(y.dtype)

    def get_init_args(self):
        return {"lower_switch_distance": self.lower_switch_distance,
                "upper_switch_distance": self.upper_switch_distance,
                "max_num_neighbors": self.max_num_neighbors,
                "distance_scale": self.distance_scale,
                "energy_scale": self.energy_scale}
