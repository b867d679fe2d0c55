"""Static-shape batch packing (counterpart of the numpy path of
``torchmdnet_tpu/data/collate.py``).

Samples are packed into fixed ``(max_atoms, max_mols)`` buffers: atoms
are concatenated along one axis and padded with ghost atoms whose segment
id is ``max_mols`` (dropped by every segment reduction and by the loss
masks); per-molecule arrays (y, q, s, dp, box) are padded with zeros and
masked by ``mol_mask``.  Every batch of a loader has the same shapes, as
in the JAX package.  The C packer and the memory-mapped fast path are not
ported yet (ROADMAP Queue 1 item 18).
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

    ``max_atoms`` defaults to ``batch_size ×`` the largest sample among
    the first 1,000, rounded up to a multiple of 64; with ``shuffle`` the
    order of epoch ``e`` is ``default_rng(seed + e).permutation``, as in
    the JAX package.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, max_atoms: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        if max_atoms is None:
            sizes = [len(dataset[i]["z"])
                     for i in range(min(len(dataset), 1000))]
            max_atoms = self.batch_size * int(max(sizes))
        self.max_atoms = int(math.ceil(max_atoms / 64) * 64)
        self._epoch = 0

    def __len__(self):
        return math.ceil(len(self.dataset) / self.batch_size)

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset), dtype=np.int64)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(
                order)
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            yield pad_samples([self.dataset[int(i)] for i in chunk],
                              self.max_atoms, self.batch_size)
