"""Atomref prior (counterpart of ``torchmdnet_tpu/priors/atomref.py``,
reference ``torchmdnet/priors/atomref.py``)."""

import numpy as np
import torch
from torch import nn

from torchmdnet_tpu_torch.priors.base import BasePrior


class _Table(nn.Module):
    """Holds the trainable table as ``weight``, so that its key is
    ``atomref.weight`` as upstream's ``nn.Embedding`` writes it; not an
    embedding here, so the model's random initialisation leaves it."""

    def __init__(self, table):
        super().__init__()
        self.weight = nn.Parameter(table)


class Atomref(BasePrior):
    """Adds per-element reference energies: ``x' = x + atomref[z]``.

    ``initial_atomref`` may come from a dataset's ``get_atomref()``.  When
    ``trainable`` the table is a parameter (key ``atomref.weight``, the
    JAX leaf ``atomref``), otherwise a constant outside the state dict, as
    in the JAX package.  ``enable=False`` makes it a no-op
    (delta-learning, reference ``atomref.py:93-96``)."""

    trainable = False

    def __init__(self, max_z=None, initial_atomref=None, trainable=None,
                 enable: bool = True):
        super().__init__()
        if trainable is not None:
            self.trainable = bool(trainable)
        self.enable = bool(enable)
        if initial_atomref is not None:
            table = np.asarray(initial_atomref, np.float32)
            if table.ndim == 1:
                table = table[:, None]
        elif max_z is not None:
            table = np.zeros((int(max_z), 1), np.float32)
        else:
            raise ValueError(
                "Can't instantiate Atomref prior, all arguments are None.")
        table = torch.from_numpy(np.array(table, copy=True))
        # the table it started from (upstream's ``initial_atomref``
        # buffer; a checkpoint carries it)
        self.register_buffer("initial_atomref", table.clone(),
                             persistent=False)
        if self.trainable:
            self.atomref = _Table(table)
        else:
            self.register_buffer("table", table, persistent=False)

    def _table(self):
        return self.atomref.weight if self.trainable else self.table

    def pre_reduce(self, x, z, pos, batch, extra_args=None, num_mols=None):
        if not self.enable:
            return x
        return x + self._table().to(x.dtype)[z]

    def get_init_args(self):
        return dict(max_z=int(self._table().shape[0]),
                    trainable=self.trainable, enable=self.enable)


class LearnableAtomref(Atomref):
    trainable = True
