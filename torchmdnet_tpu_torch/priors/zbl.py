"""Ziegler-Biersack-Littmark screened nuclear repulsion (counterpart of
``torchmdnet_tpu/priors/zbl.py``, reference ``torchmdnet/priors/zbl.py``)."""

import torch

from torchmdnet_tpu_torch.ops.rbf import cosine_cutoff
from torchmdnet_tpu_torch.ops.segment import segment_sum
from torchmdnet_tpu_torch.priors.base import BasePrior, prior_pairs


class ZBL(BasePrior):
    """Universal 4-exponential screening function, cosine-cutoff windowed,
    unit-converted through the dataset's distance and energy scales
    (reference ``zbl.py:74-112``).  ``atomic_number[z]`` maps atom types
    to atomic numbers."""

    def __init__(self, cutoff_distance: float = 4.0,
                 max_num_neighbors: int = 32, atomic_number=(),
                 distance_scale: float = 1e-10, energy_scale: float = 1.0):
        super().__init__()
        self.cutoff_distance = float(cutoff_distance)
        self.max_num_neighbors = int(max_num_neighbors)
        self.atomic_number = tuple(int(v) for v in atomic_number)
        self.distance_scale = float(distance_scale)
        self.energy_scale = float(energy_scale)
        self.register_buffer("zmap", torch.tensor(self.atomic_number,
                                                  dtype=torch.long),
                             persistent=False)

    def post_reduce(self, y, z, pos, batch, box=None, extra_args=None,
                    num_mols=None):
        num_mols = int(y.shape[0]) if num_mols is None else num_mols
        nbr, dist = prior_pairs(pos, batch, box, num_mols,
                                cutoff=self.cutoff_distance,
                                k_max=self.max_num_neighbors)
        zs = self.zmap[z]
        zi = zs[:, None].to(pos.dtype)
        zj = zs[nbr.idx].to(pos.dtype)
        # 0.8854·a0 / (Zi^0.23 + Zj^0.23), the Bohr radius in meters
        a = 0.8854 * 5.29177210903e-11 / (zi ** 0.23 + zj ** 0.23)
        safe_d = torch.where(dist > 0, dist, 1.0)
        d = safe_d * self.distance_scale / a
        f = (0.1818 * torch.exp(-3.2 * d) + 0.5099 * torch.exp(-0.9423 * d)
             + 0.2802 * torch.exp(-0.4029 * d)
             + 0.02817 * torch.exp(-0.2016 * d))
        f = f * cosine_cutoff(dist, self.cutoff_distance)
        e_pair = torch.where(nbr.mask, f * zi * zj / safe_d, 0.0)
        # 0.5×: the rows hold both directions of each pair
        scale = 0.5 * (2.30707755e-28 / self.energy_scale
                       / self.distance_scale)
        e_mol = scale * segment_sum(e_pair.sum(dim=1), batch,
                                    num_mols + 1)[:num_mols]
        return y + e_mol.reshape(y.shape).to(y.dtype)

    def get_init_args(self):
        return {"cutoff_distance": self.cutoff_distance,
                "max_num_neighbors": self.max_num_neighbors,
                "atomic_number": list(self.atomic_number),
                "distance_scale": self.distance_scale,
                "energy_scale": self.energy_scale}
