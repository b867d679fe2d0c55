"""Representation-model wrappers; counterpart of
``torchmdnet_tpu/models/wrappers.py`` (reference
``torchmdnet/models/wrappers.py``).

``AtomFilter`` drops the atoms with Z ≤ ``remove_threshold`` after the
representation (reference ``wrappers.py:33-67``).  As in the JAX package
the rows stay and their features are zeroed, which removes them from
every reduction downstream.  ``TorchMDNet`` applies the same mask inline
(``atom_filter``); this wrapper is the standalone module.
"""

from torch import nn


class BaseWrapper(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model(*args, **kwargs)


class AtomFilter(BaseWrapper):
    def __init__(self, model: nn.Module, remove_threshold: int = -1):
        super().__init__(model)
        self.remove_threshold = int(remove_threshold)

    def forward(self, z, pos, batch, box=None, q=None, atom_mask=None,
                nbr=None, num_mols=None, **kwargs):
        x, v = self.model(z, pos, batch, box=box, q=q, atom_mask=atom_mask,
                          nbr=nbr, num_mols=num_mols, **kwargs)
        keep = (z > self.remove_threshold)[:, None].to(x.dtype)
        x = x * keep
        if v is not None:
            v = v * keep[:, :, None]
        return x, v
