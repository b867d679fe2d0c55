"""Dataset base classes (counterpart of ``Dataset`` and ``Subset`` in
``torchmdnet_tpu/datasets/memdataset.py:21-70``).

Samples are plain dicts of numpy arrays (``z``, ``pos`` and optionally
``y``, ``neg_dy``, ``q``, ...).  The memory-mapped dataset and the named
datasets are not ported yet (ROADMAP Queue 1 item 18).
"""

from typing import Dict

import numpy as np


class Dataset:
    """Minimal dataset protocol: ``len(ds)``, ``ds[i] -> dict``, optional
    ``get_atomref()``."""

    transform = None

    def __len__(self):
        raise NotImplementedError

    def get(self, idx) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def __getitem__(self, idx):
        data = self.get(int(idx))
        if self.transform is not None:
            data = self.transform(data)
        return data

    def get_atomref(self, max_z=100):
        return None


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)

    def __len__(self):
        return len(self.indices)

    def get(self, idx):
        return self.dataset[int(self.indices[idx])]

    def __getattr__(self, name):
        # metadata (atomref, scales) comes from the base dataset
        return getattr(self.dataset, name)
