"""The WaterBox dataset (counterpart of ``torchmdnet_tpu/datasets/
water.py``, reference ``torchmdnet/datasets/water.py``): a periodic
liquid-water trajectory of 1,593 frames in extended-XYZ format, stored as
memory-mapped files.

Raw file: ``root/raw/training-set/dataset_1593.xyz``; each frame's comment
line holds ``TotEnergy=`` and ``Lattice="…"``, each atom line the symbol,
the position, the force and Z.  Every frame shares the box, kept as
``WaterBox.box``.
"""

import os
import re

import numpy as np

from torchmdnet_tpu_torch.datasets.memdataset import (
    MemmappedDataset, missing_raw_files)


def parse_extxyz(file_path):
    """``(energies, forces, positions, zs, boxes)`` of every frame of an
    extended-XYZ file (JAX ``:14-44``): a NaN energy and a zero box where
    the comment line has none."""
    energies, forces, positions, zs, boxes = [], [], [], [], []
    energy_re = re.compile(r"TotEnergy=(-?\d+\.\d+)")
    lattice_re = re.compile(r'Lattice="([-?\d+.\d+\s]+)"')
    with open(file_path) as fh:
        while True:
            line = fh.readline()
            if not line:
                break
            n = int(line.strip())
            props = fh.readline()
            e = energy_re.search(props)
            lat = lattice_re.search(props)
            energies.append(float(e.group(1)) if e else np.nan)
            boxes.append(
                np.asarray([float(x) for x in lat.group(1).split()],
                           np.float32).reshape(3, 3)
                if lat else np.zeros((3, 3), np.float32))
            pos = np.zeros((n, 3), np.float32)
            frc = np.zeros((n, 3), np.float32)
            z = np.zeros(n, np.int64)
            for j in range(n):
                parts = fh.readline().split()
                pos[j] = [float(x) for x in parts[1:4]]
                frc[j] = [float(x) for x in parts[4:7]]
                z[j] = int(parts[7])
            positions.append(pos)
            forces.append(frc)
            zs.append(z)
    return energies, forces, positions, zs, boxes


class WaterBox(MemmappedDataset):
    def __init__(self, root, transform=None, pre_transform=None,
                 pre_filter=None):
        self.name = self.__class__.__name__
        super().__init__(root, transform, pre_transform, pre_filter,
                         properties=("y", "neg_dy"))
        xyz = self._xyz_path()
        if os.path.exists(xyz):
            self.box = parse_extxyz(xyz)[4][0]

    def _xyz_path(self):
        return os.path.join(self.raw_dir, "training-set", "dataset_1593.xyz")

    def download(self):
        raise missing_raw_files(self.name, [self._xyz_path()])

    def process(self):
        if not os.path.exists(self._xyz_path()):
            self.download()
        super().process()

    def sample_iter(self, mol_ids=False):
        energies, forces, positions, zs, _ = parse_extxyz(self._xyz_path())
        for i in range(len(energies)):
            yield dict(z=zs[i], pos=positions[i],
                       y=np.asarray(energies[i]).reshape(1, 1),
                       neg_dy=forces[i])
