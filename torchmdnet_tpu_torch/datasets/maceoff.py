"""The MACE-OFF23 training set (counterpart of ``torchmdnet_tpu/datasets/
maceoff.py``, reference ``torchmdnet/datasets/maceoff.py``), stored as
memory-mapped files.

Raw file: ``root/raw/maceoff/<version>/train_large_neut_no_bad_clean.
tar.gz``, a gzipped tar of extended-XYZ shards with ``energy=`` in each
frame's comment line and the force columns after the positions, already
in eV and eV/Å.
"""

import hashlib
import os
import re
import tarfile

import numpy as np

from torchmdnet_tpu_torch.datasets.memdataset import (
    MemmappedDataset, missing_raw_files)
from torchmdnet_tpu_torch.utils.periodic_table import ATOMIC_NUMBERS


def parse_maceoff_tar(tar_file):
    """Yield ``(energy, atomic numbers, positions, forces)`` of each frame
    of the shards in ``tar_file``."""
    energy_re = re.compile(r"energy=(\S+)")
    with tarfile.open(tar_file, "r:gz") as tar:
        for member in tar.getmembers():
            f = tar.extractfile(member)
            if f is None:
                continue
            n_atoms = None
            for line in f:
                line = line.decode("utf-8").strip()
                if n_atoms is None:
                    n_atoms = int(line)
                    positions, numbers, forces = [], [], []
                    energy = None
                    counter = 1
                    continue
                if counter == 1:
                    energy = float(energy_re.search(line).group(1))
                    counter = 2
                    continue
                el, x, y, z, fx, fy, fz, *_ = line.split()
                numbers.append(ATOMIC_NUMBERS[el])
                positions.append([float(x), float(y), float(z)])
                forces.append([float(fx), float(fy), float(fz)])
                counter += 1
                if counter == n_atoms + 2:
                    n_atoms = None
                    yield energy, numbers, positions, forces


class MACEOFF(MemmappedDataset):
    VERSIONS = {"1.0": "train_large_neut_no_bad_clean.tar.gz"}

    def __init__(self, root=None, transform=None, pre_transform=None,
                 pre_filter=None, version="1.0", max_gradient=None):
        arg_hash = hashlib.md5(f"{version}{max_gradient}".encode()).hexdigest()
        self.name = f"{self.__class__.__name__}-{arg_hash}"
        self.version = str(version)
        if self.version not in self.VERSIONS:
            raise ValueError(f"MACEOFF version {self.version!r}: choose "
                             f"from {', '.join(self.VERSIONS)}")
        self.max_gradient = max_gradient
        super().__init__(root, transform, pre_transform, pre_filter,
                         properties=("y", "neg_dy"))

    @property
    def raw_dir(self):
        return os.path.join(self.root, "raw", "maceoff", self.version)

    @property
    def raw_paths(self):
        return [os.path.join(self.raw_dir, self.VERSIONS[self.version])]

    def download(self):
        raise missing_raw_files(f"MACEOFF {self.version}", self.raw_paths)

    def process(self):
        if not os.path.exists(self.raw_paths[0]):
            self.download()
        super().process()

    def sample_iter(self, mol_ids=False):
        for energy, numbers, positions, forces in parse_maceoff_tar(
                self.raw_paths[0]):
            neg_dy = np.asarray(forces, np.float32)
            if self.max_gradient and (np.linalg.norm(neg_dy, axis=1).max()
                                      > float(self.max_gradient)):
                continue
            data = self._filtered(dict(
                z=np.asarray(numbers, np.int64),
                pos=np.asarray(positions, np.float32),
                y=np.asarray(energy, np.float64).reshape(1, 1),
                neg_dy=neg_dy))
            if data is not None:
                yield data
