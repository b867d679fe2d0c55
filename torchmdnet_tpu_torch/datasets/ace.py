"""The AceFF datasets (counterpart of ``torchmdnet_tpu/datasets/ace.py``,
reference ``torchmdnet/datasets/ace.py:14-392``).

:class:`Ace` reads HDF5 files of the ``Ace`` layout, versions 1.0 (a group
a conformer) and 2.0 (the conformers stacked a molecule), units checked
(positions Å, formation energy eV, forces eV/Å, partial charges e, dipole
moments e·Å), into memory-mapped files with all five properties (y,
neg_dy, q = the sum of the formal charges, pq, dp).  Failed calculations
(no energy, or a NaN energy) and frames whose largest force passes
``max_gradient`` are skipped.  ``h5py`` is imported where a file is read.

:class:`AceHF` serves the same samples from parquet shards through the
Hugging Face ``datasets`` package, without the memory-mapped files.  A
``gitea`` path (a repository to clone) raises: this package fetches
nothing.
"""

import hashlib
import os

import numpy as np

from torchmdnet_tpu_torch.datasets.memdataset import (
    MemmappedDataset, missing_raw_files)


def _check_units(dataset, units):
    if dataset.attrs["units"] != units:
        raise ValueError(f"{dataset.name}: units {dataset.attrs['units']!r}, "
                         f"expected {units!r}")


class Ace(MemmappedDataset):
    def __init__(self, root=None, transform=None, pre_transform=None,
                 pre_filter=None, paths=None, max_gradient=None,
                 subsample_molecules=1):
        if not isinstance(paths, (str, list)):
            raise ValueError("paths: a file or directory, or a list of them")
        arg_hash = hashlib.md5(
            f"{paths}{max_gradient}{subsample_molecules}".encode()
        ).hexdigest()
        self.name = f"{self.__class__.__name__}-{arg_hash}"
        self.paths = paths
        self.max_gradient = max_gradient
        self.subsample_molecules = int(subsample_molecules)
        if self.subsample_molecules < 1:
            raise ValueError("subsample_molecules must be >= 1")
        super().__init__(root, transform, pre_transform, pre_filter,
                         properties=("y", "neg_dy", "q", "pq", "dp"))

    @property
    def raw_paths(self):
        paths = []
        for path in self.paths if isinstance(self.paths, list) \
                else [self.paths]:
            if os.path.isfile(path):
                paths.append(path)
            elif os.path.isdir(path):
                paths.extend(os.path.join(path, f)
                             for f in sorted(os.listdir(path))
                             if f.endswith(".h5"))
            else:
                raise missing_raw_files("Ace", [path])
        return paths

    @staticmethod
    def _confs_v1(mol):
        for conf in mol["conformations"].values():
            if "formation_energy" not in conf:
                continue  # failed calculation
            for key, units in (("positions", "Å"), ("formation_energy", "eV"),
                               ("forces", "eV/Å"), ("partial_charges", "e"),
                               ("dipole_moment", "e*Å")):
                _check_units(conf[key], units)
            yield (np.asarray(conf["positions"][...], np.float32),
                   np.float64(conf["formation_energy"][()]),
                   np.asarray(conf["forces"][...], np.float32),
                   np.asarray(conf["partial_charges"][:], np.float32),
                   np.asarray(conf["dipole_moment"][:], np.float32))

    @staticmethod
    def _confs_v2(mol):
        for key, units in (("positions", "Å"), ("formation_energies", "eV"),
                           ("forces", "eV/Å"), ("partial_charges", "e"),
                           ("dipole_moments", "e*Å")):
            _check_units(mol[key], units)
        for pos, y, f, pq, dp in zip(
                np.asarray(mol["positions"][...], np.float32),
                np.asarray(mol["formation_energies"][:], np.float64),
                np.asarray(mol["forces"][...], np.float32),
                np.asarray(mol["partial_charges"][...], np.float32),
                np.asarray(mol["dipole_moments"][...], np.float32)):
            if not np.isnan(y):
                yield pos, y, f, pq, dp

    def sample_iter(self, mol_ids=False):
        import h5py

        for i_path, path in enumerate(self.raw_paths):
            with h5py.File(path, "r") as h5:
                if h5.attrs["layout"] != "Ace":
                    raise ValueError(f"{path}: layout "
                                     f"{h5.attrs['layout']!r}, not 'Ace'")
                version = h5.attrs["layout_version"]
                if version == "1.0":
                    if "name" not in h5.attrs:
                        raise ValueError(f"{path}: no 'name' attribute")
                    mols, load_confs = list(h5.items()), self._confs_v1
                elif version == "2.0":
                    if len(h5.keys()) != 1:
                        raise ValueError(f"{path}: {len(h5.keys())} top "
                                         "groups, expected 1")
                    mols = list(next(iter(h5.values())).items())
                    load_confs = self._confs_v2
                else:
                    raise RuntimeError(
                        f"Unsupported layout version: {version}")

                for i_mol, (mol_id, mol) in enumerate(mols):
                    if i_mol % self.subsample_molecules != 0:
                        continue
                    z = np.asarray(mol["atomic_numbers"], np.int64)
                    q = int(np.asarray(mol["formal_charges"]).sum())
                    for i_conf, (pos, y, neg_dy, pq, dp) in enumerate(
                            load_confs(mol)):
                        if self.max_gradient is not None and (
                                np.linalg.norm(neg_dy, axis=1).max()
                                > float(self.max_gradient)):
                            continue
                        data = dict(z=z, pos=pos,
                                    y=np.asarray(y).reshape(1, 1),
                                    neg_dy=neg_dy, q=q, pq=pq, dp=dp)
                        if mol_ids:
                            data.update(i_path=i_path, mol_id=mol_id,
                                        i_conf=i_conf)
                        data = self._filtered(data)
                        if data is not None:
                            yield data


class AceHF:
    """:class:`Ace`'s samples from parquet shards (reference
    ``datasets/ace.py:335-392``), through ``datasets.load_dataset(root,
    data_files=paths, split=split)``; ``max_gradient`` drops the rows with
    a NaN energy or force or a force of that norm or more."""

    def __init__(self, root="parquet", paths=None, split="train",
                 max_gradient=None):
        from datasets import load_dataset

        paths = list(paths)
        remote = [p for p in paths if "gitea" in p]
        if remote:
            raise missing_raw_files("AceHF (a gitea repository is cloned "
                                    "by the reference, not here)", remote)
        self.dataset = load_dataset(root, data_files=paths, split=split)
        if max_gradient is not None:
            def keep(x):
                forces = np.asarray(x["forces"])
                energy = np.asarray(x["formation_energy"])
                if np.isnan(forces).any() or np.isnan(energy).any():
                    return False
                return np.max(np.linalg.norm(forces, axis=1)) < max_gradient

            self.dataset = self.dataset.filter(
                keep, desc="Filtering",
                num_proc=max((os.cpu_count() or 2) // 2, 1))
        self.dataset = self.dataset.with_format("numpy")

    def __len__(self):
        return self.dataset.num_rows

    def get(self, idx):
        data = self.dataset[int(idx)]
        return {
            "z": np.asarray(data["atomic_numbers"], np.int64),
            "pos": np.asarray(data["positions"], np.float32),
            "y": np.asarray(data["formation_energy"],
                            np.float64).reshape(1, 1),
            "neg_dy": np.asarray(data["forces"], np.float32),
            "q": np.int64(np.asarray(data["formal_charges"]).sum()),
            "pq": np.asarray(data["partial_charges"], np.float32),
            "dp": np.asarray(data["dipole_moment"], np.float32),
        }

    def __getitem__(self, idx):
        return self.get(idx)
