"""Generic HDF5 dataset (counterpart of ``torchmdnet_tpu/datasets/
hdf.py``, reference ``torchmdnet/datasets/hdf.py``).

File contract: each group holds samples of one atom count, with arrays
``types`` [n] (or [s, n]), ``pos`` [s, n, 3] and at least one of
``energy`` [s] / ``forces`` [s, n, 3]; optional ``partial_charges``; the
arrays of a ``_metadata`` group become attributes of the dataset.
``filename`` may be a semicolon-separated list.  Files of at most
``dataset_preload_limit`` MB together are read into memory at once; larger
ones are read sample by sample from the open files.  ``h5py`` is imported
where a file is read.
"""

from typing import Dict

import numpy as np

from torchmdnet_tpu_torch.datasets.memdataset import Dataset


class HDF5(Dataset):
    def __init__(self, filename, dataset_preload_limit=1024, **kwargs):
        import h5py

        self.filename = filename
        self.num_molecules = 0
        self.fields = None
        total_size = 0
        for fname in filename.split(";"):
            with h5py.File(fname, "r") as f:
                total_size += f.id.get_filesize()
                for group_name, group in f.items():
                    if group_name == "_metadata":
                        for name in group:
                            setattr(self, name, np.asarray(group[name]))
                        continue
                    self.num_molecules += len(group["pos"])
                    if self.fields is None:
                        self.fields = self._fields(group)
        self.cached = total_size <= dataset_preload_limit * 1024 ** 2
        self._index = None
        self._groups = None
        if self.cached:
            self._preload()

    @staticmethod
    def _fields(group):
        """``(sample key, file key, dtype)`` of each array the groups
        carry."""
        if "energy" not in group and "forces" not in group:
            raise ValueError("Each group must contain at least energies or "
                             "forces")
        fields = [("pos", "pos", np.float32), ("z", "types", np.int64)]
        for name, key in (("y", "energy"), ("neg_dy", "forces"),
                          ("partial_charges", "partial_charges")):
            if key in group:
                fields.append((name, key, np.float32))
        return fields

    def _iter_groups(self):
        """Every sample group of the files, the files left open (the
        streamed dataset reads from them)."""
        import h5py

        self._files = getattr(self, "_files", [])
        for fname in self.filename.split(";"):
            f = h5py.File(fname, "r")
            self._files.append(f)
            for group_name, group in f.items():
                if group_name != "_metadata":
                    yield group

    def _preload(self):
        self._data = {name: [] for name, _, _ in self.fields}
        self._index = []
        for gi, group in enumerate(self._iter_groups()):
            size = len(group["pos"])
            for name, key, dtype in self.fields:
                arr = np.asarray(group[key], dtype=dtype)
                if arr.ndim == 1:
                    arr = (arr[:, None] if len(arr) == size else
                           np.broadcast_to(arr[None, :], (size, len(arr))))
                self._data[name].append(arr)
            self._index.extend((gi, i) for i in range(size))
        for f in self._files:
            f.close()
        self._files = []

    def _setup_lazy_index(self):
        self._index = []
        self._groups = []
        for gi, group in enumerate(self._iter_groups()):
            self._groups.append(group)
            self._index.extend((gi, i) for i in range(len(group["pos"])))

    def __len__(self):
        return self.num_molecules

    def get(self, idx) -> Dict[str, np.ndarray]:
        if self._index is None:
            self._setup_lazy_index()
        gi, i = self._index[idx]
        out = {}
        if self.cached:
            for name, _, _ in self.fields:
                out[name] = np.asarray(self._data[name][gi][i])
        else:
            group = self._groups[gi]
            size = len(group["pos"])
            for name, key, dtype in self.fields:
                d = group[key]
                if d.ndim == 1:
                    val = np.asarray([d[i]] if len(d) == size else d[:],
                                     dtype)
                else:
                    val = np.asarray(d[i], dtype)
                out[name] = val
        out["z"] = np.asarray(out["z"], np.int64).reshape(-1)
        if "y" in out:
            out["y"] = np.asarray(out["y"], np.float32).reshape(1, 1)
        return out
