"""Prior-model base class (counterpart of ``torchmdnet_tpu/priors/base.py``,
reference ``torchmdnet/priors/base.py``)."""

from torch import nn

from torchmdnet_tpu_torch.ops.neighbors import (
    build_neighbor_matrix, neighbor_geometry)


class BasePrior(nn.Module):
    """Priors hook into the energy pipeline at two points:

    * ``pre_reduce(x, z, pos, batch, extra_args, num_mols)``: per-atom
      scalar terms, after ×std and before the reduction;
    * ``post_reduce(y, z, pos, batch, box, extra_args, num_mols)``:
      per-molecule terms, after +mean.

    ``get_init_args()`` gives the constructor's arguments back (checkpoint
    round trip)."""

    def get_init_args(self):
        return {}

    def pre_reduce(self, x, z, pos, batch, extra_args=None, num_mols=None):
        return x

    def post_reduce(self, y, z, pos, batch, box=None, extra_args=None,
                    num_mols=None):
        return y


def prior_pairs(pos, batch, box, num_mols, *, cutoff: float, k_max: int):
    """A prior's own brute neighbor list (no self loops, ghosts left out)
    and its distances ``[N, K]``, built anew on every call as the JAX
    priors build theirs; its geometry has the scatter-free transpose."""
    nbr = build_neighbor_matrix(pos, batch, strategy="brute", k_max=k_max,
                                cutoff_upper=cutoff, loop=False, box=box,
                                atom_mask=batch < num_mols)
    _, dist = neighbor_geometry(pos, nbr, box=box, batch=batch)
    return nbr, dist
