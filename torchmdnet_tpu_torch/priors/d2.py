"""Grimme DFT-D2 dispersion correction (counterpart of
``torchmdnet_tpu/priors/d2.py``, reference ``torchmdnet/priors/d2.py``)."""

import numpy as np
import torch

from torchmdnet_tpu_torch.ops.segment import segment_sum
from torchmdnet_tpu_torch.priors.base import BasePrior, prior_pairs

# C_6 (J/mol·nm⁶) and vdW radii (Å, converted to nm below) for Z = 1..54,
# Grimme 2006 Table 1 (reference ``d2.py:49-109``).  Index 0 is NaN.
# fmt: off
_C6_TABLE = [
    np.nan,
    0.14, 0.08, 1.61, 1.61, 3.13, 1.75, 1.23, 0.70, 0.75, 0.63,
    5.71, 5.71, 10.79, 9.23, 7.84, 5.57, 5.07, 4.61, 10.80, 10.80,
    10.80, 10.80, 10.80, 10.80, 10.80, 10.80, 10.80, 10.80, 10.80, 10.80,
    16.99, 17.10, 16.37, 12.64, 12.47, 12.01, 24.67, 24.67, 24.67, 24.67,
    24.67, 24.67, 24.67, 24.67, 24.67, 24.67, 24.67, 24.67, 37.32, 38.71,
    38.44, 31.74, 31.50, 29.99,
]
_RR_TABLE = [
    np.nan,
    1.001, 1.012, 0.825, 1.408, 1.485, 1.452, 1.397, 1.342, 1.287, 1.243,
    1.144, 1.364, 1.639, 1.716, 1.705, 1.683, 1.639, 1.595, 1.485, 1.474,
    1.562, 1.562, 1.562, 1.562, 1.562, 1.562, 1.562, 1.562, 1.562, 1.562,
    1.650, 1.727, 1.760, 1.771, 1.749, 1.727, 1.628, 1.606, 1.639, 1.639,
    1.639, 1.639, 1.639, 1.639, 1.639, 1.639, 1.639, 1.639, 1.672, 1.804,
    1.881, 1.892, 1.892, 1.881,
]
# fmt: on

C_6 = np.asarray(_C6_TABLE, np.float64)
R_R = np.asarray(_RR_TABLE, np.float64) * 0.1  # Å → nm


class D2(BasePrior):
    """Fermi-damped C6/R⁶ dispersion with element parameters for Z ≤ 54
    (reference ``d2.py:110-201``); ``d = 20``, ``s6 = 1``."""

    def __init__(self, cutoff_distance: float = 10.0,
                 max_num_neighbors: int = 128, atomic_number=(),
                 distance_scale: float = 1e-10, energy_scale: float = 1.0,
                 d: float = 20.0, s_6: float = 1.0):
        super().__init__()
        self.cutoff_distance = float(cutoff_distance)
        self.max_num_neighbors = int(max_num_neighbors)
        self.atomic_number = tuple(int(v) for v in atomic_number)
        self.distance_scale = float(distance_scale)
        self.energy_scale = float(energy_scale)
        self.d = float(d)
        self.s_6 = float(s_6)
        self.register_buffer("zmap", torch.tensor(self.atomic_number,
                                                  dtype=torch.long),
                             persistent=False)
        self.register_buffer("c6", torch.tensor(C_6, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("rr", torch.tensor(R_R, dtype=torch.float32),
                             persistent=False)

    def post_reduce(self, y, z, pos, batch, box=None, extra_args=None,
                    num_mols=None):
        num_mols = int(y.shape[0]) if num_mols is None else num_mols
        nbr, dist = prior_pairs(pos, batch, box, num_mols,
                                cutoff=self.cutoff_distance,
                                k_max=self.max_num_neighbors)
        distance_scale = self.distance_scale * 1e9  # m → nm
        energy_scale = self.energy_scale * 6.02214076e23  # J → J/mol
        r = dist * distance_scale
        zs = self.zmap[z]
        c6 = self.c6.to(pos.dtype)[zs]
        rr = self.rr.to(pos.dtype)[zs]
        c6_ij = torch.sqrt(c6[:, None] * c6[nbr.idx])
        rr_ij = rr[:, None] + rr[nbr.idx]
        safe_r = torch.where(r > 0, r, 1.0)
        f_damp = 1.0 / (1.0 + torch.exp(-self.d * (safe_r / rr_ij - 1.0)))
        e_pair = torch.where(nbr.mask, c6_ij / safe_r ** 6 * f_damp, 0.0)
        # -s6 ×, and 0.5× for the doubly counted pairs (reference :189-196)
        e_mol = -self.s_6 * 0.5 * segment_sum(
            e_pair.sum(dim=1), batch, num_mols + 1)[:num_mols]
        return y + (e_mol / energy_scale).reshape(y.shape).to(y.dtype)

    def get_init_args(self):
        return {"cutoff_distance": self.cutoff_distance,
                "max_num_neighbors": self.max_num_neighbors,
                "atomic_number": list(self.atomic_number),
                "distance_scale": self.distance_scale,
                "energy_scale": self.energy_scale}
