"""MD22 large-molecule trajectories (counterpart of ``torchmdnet_tpu/
datasets/md22.py``, reference ``torchmdnet/datasets/md22.py``), stored as
memory-mapped files.

Raw file: ``root/<molecule>/raw/md22_<molecule>.npz`` with the keys
``z``/``R``/``E``/``F``, energies in kcal/mol and forces in kcal/mol/Å as
the files hold them.
"""

import os
import os.path as osp

import numpy as np

from torchmdnet_tpu_torch.datasets.memdataset import (
    MemmappedDataset, missing_raw_files)


class MD22(MemmappedDataset):
    file_names = {
        "AT-AT-CG-CG": "md22_AT-AT-CG-CG.npz",
        "AT-AT": "md22_AT-AT.npz",
        "Ac-Ala3-NHMe": "md22_Ac-Ala3-NHMe.npz",
        "DHA": "md22_DHA.npz",
        "buckyball-catcher": "md22_buckyball-catcher.npz",
        "dw-nanotube": "md22_dw_nanotube.npz",
        "stachyose": "md22_stachyose.npz",
    }

    def __init__(self, root, molecules, transform=None, pre_transform=None,
                 pre_filter=None):
        if molecules not in self.file_names:
            raise ValueError(f"Unknown dataset name '{molecules}'")
        self.molecule = molecules
        self.name = f"MD22-{molecules}"
        super().__init__(root, transform, pre_transform, pre_filter,
                         properties=("y", "neg_dy"))

    @property
    def raw_dir(self):
        return osp.join(self.root, self.molecule, "raw")

    @property
    def raw_paths(self):
        return [osp.join(self.raw_dir, self.file_names[self.molecule])]

    def download(self):
        raise missing_raw_files(f"MD22 '{self.molecule}'", self.raw_paths)

    def process(self):
        if not all(os.path.exists(p) for p in self.raw_paths):
            self.download()
        super().process()

    def sample_iter(self, mol_ids=False):
        raw = np.load(self.raw_paths[0])
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
