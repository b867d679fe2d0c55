"""MD17, revised MD17 and the CCSD(T) trajectories (counterpart of
``torchmdnet_tpu/datasets/md17.py``, reference ``torchmdnet/datasets/
md17.py``), stored as memory-mapped files.

Raw files: an ``.npz`` per molecule, with the keys ``z``/``R``/``E``/``F``
(original) or ``nuclear_charges``/``coords``/``energies``/``forces``
(revised: ``root/raw/rmd17/npz_data/rmd17_<molecule>.npz``).  Energies in
kcal/mol and forces in kcal/mol/Å, as the files hold them.
"""

import os.path as osp

import numpy as np

from torchmdnet_tpu_torch.datasets.memdataset import (
    MemmappedDataset, missing_raw_files)


class MD17(MemmappedDataset):
    file_names = {
        "benzene": "md17_benzene2017.npz",
        "uracil": "md17_uracil.npz",
        "naphtalene": "md17_naphthalene.npz",
        "aspirin": "md17_aspirin.npz",
        "salicylic_acid": "md17_salicylic.npz",
        "malonaldehyde": "md17_malonaldehyde.npz",
        "ethanol": "md17_ethanol.npz",
        "toluene": "md17_toluene.npz",
        "paracetamol": "paracetamol_dft.npz",
        "azobenzene": "azobenzene_dft.npz",
        "revised_benzene": "rmd17_benzene.npz",
        "revised_uracil": "rmd17_uracil.npz",
        "revised_naphthalene": "rmd17_naphthalene.npz",
        "revised_aspirin": "rmd17_aspirin.npz",
        "revised_salicylic_acid": "rmd17_salicylic.npz",
        "revised_malonaldehyde": "rmd17_malonaldehyde.npz",
        "revised_ethanol": "rmd17_ethanol.npz",
        "revised_toluene": "rmd17_toluene.npz",
        "revised_paracetamol": "rmd17_paracetamol.npz",
        "revised_azobenzene": "rmd17_azobenzene.npz",
        "benzene_CCSD_T": "benzene_ccsd_t.zip",
        "aspirin_CCSD": "aspirin_ccsd.zip",
        "malonaldehyde_CCSD_T": "malonaldehyde_ccsd_t.zip",
        "ethanol_CCSD_T": "ethanol_ccsd_t.zip",
        "toluene_CCSD_T": "toluene_ccsd_t.zip",
        "benzene_FHI-aims": "benzene2018_dft.npz",
    }

    def __init__(self, root, molecules, train=None, transform=None,
                 pre_transform=None, pre_filter=None):
        if molecules not in self.file_names:
            raise ValueError(f"Unknown dataset name '{molecules}'")
        self.molecule = molecules
        self.revised = "revised" in molecules
        self.ccsd = "CCSD" in molecules
        if self.ccsd:
            if train is None:
                raise ValueError(
                    f"'{molecules}' provides pre-defined splits but the "
                    "'train' argument was not specified")
            self.split = "train" if train else "test"
            self.name = f"MD17-{molecules}-{self.split}"
        else:
            if train is not None:
                raise ValueError(
                    f"'{molecules}' does not provide pre-defined splits but "
                    f"the 'train' argument is set to '{train}'")
            self.split = None
            self.name = f"MD17-{molecules}"
        super().__init__(root, transform, pre_transform, pre_filter,
                         properties=("y", "neg_dy"))

    @property
    def raw_dir(self):
        if self.revised:
            return osp.join(self.root, "raw")
        return osp.join(self.root, self.molecule, "raw")

    @property
    def raw_paths(self):
        name = self.file_names[self.molecule]
        if self.revised:
            return [osp.join(self.raw_dir, "rmd17", "npz_data", name)]
        if self.ccsd:
            return [osp.join(self.raw_dir, f"{name[:-4]}-{self.split}.npz")]
        return [osp.join(self.raw_dir, name)]

    def download(self):
        raise missing_raw_files(f"MD17 '{self.molecule}'", self.raw_paths)

    def process(self):
        if not all(osp.exists(p) for p in self.raw_paths):
            self.download()
        super().process()

    def sample_iter(self, mol_ids=False):
        for raw_path in self.raw_paths:
            raw = np.load(raw_path)
            if self.revised:
                z = np.asarray(raw["nuclear_charges"], np.int64)
                pos = np.asarray(raw["coords"], np.float32)
                energy = np.asarray(raw["energies"], np.float64)
                force = np.asarray(raw["forces"], np.float32)
            else:
                z = np.asarray(raw["z"], np.int64)
                pos = np.asarray(raw["R"], np.float32)
                energy = np.asarray(raw["E"], np.float64).reshape(-1)
                force = np.asarray(raw["F"], np.float32)
            for i in range(pos.shape[0]):
                data = self._filtered(dict(
                    z=z, pos=pos[i], y=np.asarray(energy[i]).reshape(1, 1),
                    neg_dy=force[i]))
                if data is not None:
                    yield data
