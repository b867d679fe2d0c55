"""SPICE (counterpart of ``torchmdnet_tpu/datasets/spice.py``, reference
``torchmdnet/datasets/spice.py``), stored as memory-mapped files.

One HDF5 file (``root/raw/spice/<version>/<file>``) keyed by molecule:
``atomic_numbers``, ``conformations`` (Bohr → Å), ``formation_energy``
(Hartree → eV), ``dft_total_gradient`` (negated, Hartree/Bohr → eV/Å),
``subset``; optional filters by subset, by the largest force
(``max_gradient``) and one molecule in ``subsample_molecules``.  ``h5py``
is imported where the file is read.
"""

import hashlib
import logging
import os

import numpy as np

from torchmdnet_tpu_torch.datasets.memdataset import (
    MemmappedDataset, missing_raw_files)

HARTREE_TO_EV = 27.211386246
BOHR_TO_ANGSTROM = 0.529177


class SPICE(MemmappedDataset):
    VERSIONS = {
        "1.0": "SPICE.hdf5",
        "1.1": "SPICE.hdf5",
        "1.1.1": "SPICE-1.1.1.hdf5",
        "1.1.2": "SPICE-1.1.2.hdf5",
        "1.1.3": "SPICE-1.1.3.hdf5",
        "1.1.4": "SPICE-1.1.4.hdf5",
        "2.0.1": "SPICE-2.0.1.hdf5",
    }

    HARTREE_TO_EV = HARTREE_TO_EV
    BORH_TO_ANGSTROM = BOHR_TO_ANGSTROM

    def __init__(self, root=None, transform=None, pre_transform=None,
                 pre_filter=None, version="1.1.3", subsets=None,
                 max_gradient=None, subsample_molecules=1):
        arg_hash = hashlib.md5(
            f"{version}{subsets}{max_gradient}{subsample_molecules}".encode()
        ).hexdigest()
        self.name = f"{self.__class__.__name__}-{arg_hash}"
        self.version = str(version)
        if self.version not in self.VERSIONS:
            raise ValueError(f"SPICE version {self.version!r}: choose from "
                             f"{', '.join(self.VERSIONS)}")
        self.subsets = subsets
        self.max_gradient = max_gradient
        self.subsample_molecules = int(subsample_molecules)
        if self.subsample_molecules < 1:
            raise ValueError("subsample_molecules must be >= 1")
        super().__init__(root, transform, pre_transform, pre_filter,
                         properties=("y", "neg_dy"))

    @property
    def raw_dir(self):
        return os.path.join(self.root, "raw", "spice", self.version)

    @property
    def raw_paths(self):
        return [os.path.join(self.raw_dir, self.VERSIONS[self.version])]

    def download(self):
        raise missing_raw_files(f"SPICE {self.version}", self.raw_paths)

    def process(self):
        if not os.path.exists(self.raw_paths[0]):
            self.download()
        super().process()

    def sample_iter(self, mol_ids=False):
        import h5py

        with h5py.File(self.raw_paths[0], "r") as f:
            for i_mol, (mol_id, mol) in enumerate(f.items()):
                if self.subsets and (mol["subset"][0].decode()
                                     not in list(self.subsets)):
                    continue
                if i_mol % self.subsample_molecules != 0:
                    continue
                z = np.asarray(mol["atomic_numbers"], np.int64)
                all_pos = (np.asarray(mol["conformations"], np.float32)
                           * self.BORH_TO_ANGSTROM)
                all_y = (np.asarray(mol["formation_energy"], np.float64)
                         * self.HARTREE_TO_EV)
                all_neg_dy = (-np.asarray(mol["dft_total_gradient"],
                                          np.float32)
                              * self.HARTREE_TO_EV / self.BORH_TO_ANGSTROM)
                if all_pos.ndim < 3:
                    logging.warning(f"Bogus conformation {mol_id}")
                    continue
                for pos, y, neg_dy in zip(all_pos, all_y, all_neg_dy):
                    if self.max_gradient and (
                            np.linalg.norm(neg_dy, axis=1).max()
                            > float(self.max_gradient)):
                        continue
                    data = dict(z=z, pos=pos, y=np.asarray(y).reshape(1, 1),
                                neg_dy=neg_dy)
                    if mol_ids:
                        data["mol_id"] = mol_id
                    data = self._filtered(data)
                    if data is not None:
                        yield data
