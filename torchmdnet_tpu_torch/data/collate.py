"""Static-shape batch packing (counterpart of
``torchmdnet_tpu/data/collate.py``).

Samples are packed into fixed ``(max_atoms, max_mols)`` buffers: atoms
are concatenated along one axis and padded with ghost atoms whose segment
id is ``max_mols`` (dropped by every segment reduction and by the loss
masks); per-molecule arrays (y, q, s, dp, box) are padded with zeros and
masked by ``mol_mask``.  Every batch of a loader has the same shapes, as
in the JAX package.  :func:`pad_samples` is the plain numpy version, which
in-memory datasets use; a :class:`~torchmdnet_tpu_torch.datasets.
memdataset.MemmappedDataset` (or a ``Subset`` of one) with no transform is
packed straight from its mapped files by the native packer
(``data/_native.py::pack_from_memmap``).
"""

import math
from typing import Dict, Iterator, List, Optional

import numpy as np


def pad_samples(samples: List[Dict[str, np.ndarray]], max_atoms: int,
                max_mols: int) -> Dict[str, np.ndarray]:
    """Pack a list of dict samples into one padded batch dict."""
    n_mols = len(samples)
    if n_mols > max_mols:
        raise ValueError(f"{n_mols} molecules > max_mols={max_mols}")
    total_atoms = sum(len(s["z"]) for s in samples)
    if total_atoms > max_atoms:
        raise ValueError(f"{total_atoms} atoms > max_atoms={max_atoms}")

    out = {
        "z": np.zeros(max_atoms, np.int32),
        "pos": np.zeros((max_atoms, 3), np.float32),
        "batch": np.full(max_atoms, max_mols, np.int32),
        "mol_mask": np.zeros(max_mols, bool),
    }
    has = {k: all(k in s for s in samples) for k in
           ("y", "neg_dy", "q", "s", "pq", "dp", "box", "partial_charges")}
    shapes = {"y": (max_mols, 1), "neg_dy": (max_atoms, 3), "q": (max_mols,),
              "s": (max_mols,), "pq": (max_atoms,),
              "partial_charges": (max_atoms,), "dp": (max_mols, 3),
              "box": (max_mols, 3, 3)}
    for key, shape in shapes.items():
        if has[key]:
            out[key] = np.zeros(shape, np.float32)

    o = 0
    for m, s in enumerate(samples):
        n = len(s["z"])
        out["z"][o:o + n] = np.asarray(s["z"]).reshape(-1)
        out["pos"][o:o + n] = s["pos"]
        out["batch"][o:o + n] = m
        out["mol_mask"][m] = True
        if has["y"]:
            out["y"][m, 0] = float(np.asarray(s["y"]).reshape(()))
        if has["neg_dy"]:
            out["neg_dy"][o:o + n] = s["neg_dy"]
        for key in ("q", "s"):
            if has[key]:
                out[key][m] = float(np.asarray(s[key]).reshape(()))
        for key in ("pq", "partial_charges"):
            if has[key]:
                out[key][o:o + n] = np.asarray(s[key]).reshape(-1)
        if has["dp"]:
            out["dp"][m] = np.asarray(s["dp"]).reshape(3)
        if has["box"]:
            out["box"][m] = np.asarray(s["box"]).reshape(3, 3)
        o += n
    return out


class PaddedLoader:
    """Iterates a dataset as padded static-shape batches.

    ``max_atoms`` defaults to ``batch_size ×`` the largest sample (of the
    whole mapped dataset, read from its index file, for a memory-mapped
    one; of the first 1,000 of ``indices`` otherwise), rounded up to a
    multiple of 64; with ``shuffle`` the order of epoch ``e`` is
    ``default_rng(seed + e).permutation`` of ``indices`` (default: all),
    as in the JAX package.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, max_atoms: Optional[int] = None,
                 drop_last: bool = False,
                 indices: Optional[np.ndarray] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.indices = (np.asarray(indices, np.int64) if indices is not None
                        else np.arange(len(dataset), dtype=np.int64))
        if max_atoms is None:
            max_atoms = self.batch_size * self._max_sample_size()
        self.max_atoms = int(math.ceil(max_atoms / 64) * 64)
        self._epoch = 0

    def _max_sample_size(self) -> int:
        base = getattr(self.dataset, "dataset", self.dataset)
        if hasattr(base, "mmaps"):  # a MemmappedDataset: from its index
            return int(np.max(np.diff(np.asarray(base.mmaps["idx"]))))
        return int(max(len(self.dataset[int(i)]["z"])
                       for i in self.indices[:1000]))

    def __len__(self):
        n = len(self.indices)
        return (n // self.batch_size if self.drop_last
                else math.ceil(n / self.batch_size))

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def _memmap_base(self):
        """``(base MemmappedDataset, index map or None)`` where the native
        memmap packer applies (no transform in the chain), else
        ``(None, None)``."""
        from torchmdnet_tpu_torch.datasets.memdataset import (
            MemmappedDataset, Subset)

        ds, remap = self.dataset, None
        if isinstance(ds, Subset):
            ds, remap = ds.dataset, ds.indices
        if isinstance(ds, MemmappedDataset) and ds.transform is None:
            return ds, remap
        return None, None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self.indices
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(
                order)
        base, remap = self._memmap_base()
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            if base is not None:
                from torchmdnet_tpu_torch.data._native import pack_from_memmap

                ids = remap[chunk] if remap is not None else chunk
                yield pack_from_memmap(base, ids, self.max_atoms,
                                       self.batch_size)
            else:
                yield pad_samples([self.dataset[int(i)] for i in chunk],
                                  self.max_atoms, self.batch_size)
