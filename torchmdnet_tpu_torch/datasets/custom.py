"""Custom dataset of ``.npy`` files found by glob patterns (counterpart of
``torchmdnet_tpu/datasets/custom.py``, reference ``torchmdnet/datasets/
custom.py``).

Per file: coordinates [frames, n, 3]; embeddings (atom types) [n], shared
by the frames; optionally energies [frames(, 1)] and forces [frames, n,
3].  Files of less than ``preload_memory_limit`` MB together are read into
memory, larger ones are opened as memory maps.
"""

import glob as globmod

import numpy as np

from torchmdnet_tpu_torch.datasets.memdataset import Dataset


class Custom(Dataset):
    def __init__(self, coordglob, embedglob, energyglob=None, forceglob=None,
                 preload_memory_limit=1024, transform=None, **kwargs):
        if energyglob is None and forceglob is None:
            raise ValueError("Either energies, forces or both must be "
                             "specified as the target")
        self.transform = transform
        self.has_energies = energyglob is not None
        self.has_forces = forceglob is not None
        self.files = {"pos": sorted(globmod.glob(coordglob)),
                      "z": sorted(globmod.glob(embedglob))}
        if self.has_energies:
            self.files["y"] = sorted(globmod.glob(energyglob))
        if self.has_forces:
            self.files["neg_dy"] = sorted(globmod.glob(forceglob))
        for key, names in self.files.items():
            if len(names) != len(self.files["pos"]):
                raise ValueError(f"{len(names)} {key} files for "
                                 f"{len(self.files['pos'])} coordinate files")

        self.index = []
        total = 0
        for i, f in enumerate(self.files["pos"]):
            coords = np.load(f, mmap_mode="r")
            embed = np.load(self.files["z"][i])
            if coords.shape[1] != embed.shape[0]:
                raise ValueError(f"Atom count mismatch in file pair {i}")
            total += coords.nbytes + embed.nbytes
            if self.has_energies:
                e = np.load(self.files["y"][i], mmap_mode="r")
                if e.shape[0] != coords.shape[0]:
                    raise ValueError(f"Frame count mismatch in file {i}")
                total += e.nbytes
            if self.has_forces:
                fr = np.load(self.files["neg_dy"][i], mmap_mode="r")
                if fr.shape != coords.shape:
                    raise ValueError(f"Force shape mismatch in file {i}")
                total += fr.nbytes
            self.index.extend((i, j) for j in range(coords.shape[0]))

        mmap_mode = None if total < preload_memory_limit * 1024 ** 2 else "r"
        self.stored = {
            key: [np.load(f, mmap_mode=mmap_mode) for f in names]
            for key, names in self.files.items() if key != "z"}
        self.stored["z"] = [np.load(f).astype(np.int64)
                            for f in self.files["z"]]

    def __len__(self):
        return len(self.index)

    def get(self, idx):
        fid, i = self.index[idx]
        out = {"pos": np.asarray(self.stored["pos"][fid][i], np.float32),
               "z": self.stored["z"][fid]}
        if self.has_energies:
            out["y"] = np.asarray(self.stored["y"][fid][i],
                                  np.float32).reshape(1, 1)
        if self.has_forces:
            out["neg_dy"] = np.asarray(self.stored["neg_dy"][fid][i],
                                       np.float32)
        return out
