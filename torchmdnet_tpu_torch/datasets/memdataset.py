"""Dataset base classes and the memory-mapped dataset (counterpart of
``torchmdnet_tpu/datasets/memdataset.py``, reference
``torchmdnet/datasets/memdataset.py``).

Samples are plain dicts of numpy arrays (``z``, ``pos`` and optionally
``y``, ``neg_dy``, ``q``, ...).  :class:`MemmappedDataset` writes the
reference's ``<Name>.<prop>.mmap`` files (:data:`PROP_SPECS`: idx int64
prefix offsets, z int8, pos float32 [A, 3], y float64, neg_dy float32
[A, 3], q int8, pq float32, dp float32 [C, 3]) in two passes over the raw
samples, each file written as ``.tmp`` and renamed when all are
complete, so that a dataset processed by this package, by the JAX package
or by upstream torchmd-net opens in the others byte for byte.
"""

import gc
import os
from typing import Dict, Iterator, Sequence

import numpy as np


class Dataset:
    """Minimal dataset protocol: ``len(ds)``, ``ds[i] -> dict``, optional
    ``get_atomref()`` and ``atomic_number``/``distance_scale``/
    ``energy_scale`` attributes read by the priors."""

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
        # metadata (atomref, scales) comes from the base dataset; an
        # unpickled copy has no base yet when it is asked for its state
        if name == "dataset" or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.dataset, name)


def missing_raw_files(name, paths):
    """The error of a dataset whose raw files are absent: this package
    downloads nothing, so it names the files to place (JAX
    ``datasets/_download.py:27`` after its download fails)."""
    paths = [str(p) for p in paths]
    return RuntimeError(
        f"{name}: raw file(s) missing; this package downloads nothing. "
        f"Place {', '.join(paths)} and retry.")


# property → (dtype, values a row)
PROP_SPECS = {
    "idx": (np.int64, 1),
    "z": (np.int8, 1),
    "pos": (np.float32, 3),
    "y": (np.float64, 1),
    "neg_dy": (np.float32, 3),
    "q": (np.int8, 1),
    "pq": (np.float32, 1),
    "dp": (np.float32, 3),
}
# properties with one row a conformer (the rest have one an atom; idx has
# one more)
_PER_CONF = ("y", "q", "dp")


class MemmappedDataset(Dataset):
    """A dataset stored as one memory-mapped file a property.  A subclass
    gives :meth:`sample_iter` (the raw samples, dicts with ``z``, ``pos``
    and the declared ``properties``) and, where its raw files live
    elsewhere, ``raw_dir``; the files are written on first use and
    ``get`` slices them."""

    def __init__(self, root: str, transform=None, pre_transform=None,
                 pre_filter=None,
                 properties: Sequence[str] = ("y", "neg_dy", "q", "pq",
                                              "dp")):
        if not hasattr(self, "name"):
            self.name = self.__class__.__name__
        self.root = os.path.expanduser(root)
        self.transform = transform
        self.pre_transform = pre_transform
        self.pre_filter = pre_filter
        self.properties = tuple(properties)
        os.makedirs(self.processed_dir, exist_ok=True)
        if not all(os.path.exists(p) for p in self.processed_paths):
            self.process()
        self._open()

    # -- layout ------------------------------------------------------------
    @property
    def raw_dir(self):
        return os.path.join(self.root, "raw")

    @property
    def processed_dir(self):
        return os.path.join(self.root, "processed")

    @property
    def _props(self):
        return ["idx", "z", "pos"] + list(self.properties)

    @property
    def processed_file_names(self):
        return [f"{self.name}.{prop}.mmap" for prop in self._props]

    @property
    def processed_paths(self):
        return [os.path.join(self.processed_dir, f)
                for f in self.processed_file_names]

    @property
    def processed_paths_dict(self):
        return dict(zip(self._props, self.processed_paths))

    # -- abstract ------------------------------------------------------------
    def sample_iter(self, mol_ids=False) -> Iterator[Dict[str, np.ndarray]]:
        """Yield dict samples with at least ``z`` and ``pos`` [n, 3], and
        the declared properties."""
        raise NotImplementedError

    def _filtered(self, data):
        """``data`` after ``pre_filter`` (None where it drops the sample)
        and ``pre_transform``."""
        if self.pre_filter is not None and not self.pre_filter(data):
            return None
        if self.pre_transform is not None:
            data = self.pre_transform(data)
        return data

    # -- processing ----------------------------------------------------------
    def process(self):
        print("Gathering statistics...")
        num_all_confs = 0
        num_all_atoms = 0
        for data in self.sample_iter():
            num_all_confs += 1
            num_all_atoms += int(np.asarray(data["z"]).shape[0])
        print(f"  Total number of conformers: {num_all_confs}")
        print(f"  Total number of atoms: {num_all_atoms}")
        print(f"  Properties available: {self.properties}")

        fnames = self.processed_paths_dict
        mmaps = {}
        for prop in self._props:
            dtype, width = PROP_SPECS[prop]
            count = (num_all_confs + 1 if prop == "idx" else num_all_confs
                     if prop in _PER_CONF else num_all_atoms)
            shape = (count,) if width == 1 else (count, width)
            mmaps[prop] = np.memmap(fnames[prop] + ".tmp", mode="w+",
                                    dtype=dtype, shape=shape)

        print("Storing data...")
        i_atom = 0
        for i_conf, data in enumerate(self.sample_iter()):
            n = int(np.asarray(data["z"]).shape[0])
            atoms = slice(i_atom, i_atom + n)
            mmaps["idx"][i_conf] = i_atom
            mmaps["z"][atoms] = np.asarray(data["z"], np.int8)
            mmaps["pos"][atoms] = np.asarray(data["pos"], np.float32)
            for prop in self.properties:
                value = np.asarray(data[prop])
                if prop in ("y", "q"):
                    mmaps[prop][i_conf] = value.reshape(())
                elif prop == "dp":
                    mmaps[prop][i_conf] = value.astype(np.float32)
                else:
                    mmaps[prop][atoms] = value.astype(np.float32)
            i_atom += n
        mmaps["idx"][-1] = num_all_atoms
        if i_atom != num_all_atoms:
            raise RuntimeError(f"{self.name}: the second pass read "
                               f"{i_atom} atoms, the first {num_all_atoms}")

        for prop in list(mmaps):
            mmaps[prop].flush()
            del mmaps[prop]
        gc.collect()
        for path in fnames.values():
            os.rename(path + ".tmp", path)

    def _open(self):
        fnames = self.processed_paths_dict
        idx = np.memmap(fnames["idx"], mode="r", dtype=np.int64)
        z = np.memmap(fnames["z"], mode="r", dtype=np.int8)
        num_confs, num_atoms = idx.shape[0] - 1, z.shape[0]
        self.mmaps = {"idx": idx, "z": z}
        for prop in ["pos"] + list(self.properties):
            dtype, width = PROP_SPECS[prop]
            count = num_confs if prop in _PER_CONF else num_atoms
            self.mmaps[prop] = np.memmap(
                fnames[prop], mode="r", dtype=dtype,
                shape=(count,) if width == 1 else (count, width))
        if idx[0] != 0 or idx[-1] != num_atoms:
            raise RuntimeError(f"{self.name}: corrupt index file "
                               f"{fnames['idx']}")

    def __getstate__(self):
        # a pickled copy (a data-parallel rank's) reopens the files rather
        # than carrying their contents
        state = dict(self.__dict__)
        state.pop("mmaps", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._open()

    def __len__(self):
        return len(self.mmaps["idx"]) - 1

    def get(self, idx):
        mm = self.mmaps
        atoms = slice(int(mm["idx"][idx]), int(mm["idx"][idx + 1]))
        out = {"z": np.asarray(mm["z"][atoms], np.int64),
               "pos": np.array(mm["pos"][atoms], np.float32)}
        if "y" in self.properties:
            out["y"] = np.array([[mm["y"][idx]]], np.float64)
        if "neg_dy" in self.properties:
            out["neg_dy"] = np.array(mm["neg_dy"][atoms], np.float32)
        if "q" in self.properties:
            out["q"] = np.asarray(mm["q"][idx], np.int64)
        if "pq" in self.properties:
            out["pq"] = np.array(mm["pq"][atoms], np.float32)
        if "dp" in self.properties:
            out["dp"] = np.array(mm["dp"][idx], np.float32)
        return out
