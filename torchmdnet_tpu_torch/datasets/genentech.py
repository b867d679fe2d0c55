"""Genentech torsion scans (counterpart of ``torchmdnet_tpu/datasets/
genentech.py``, reference ``torchmdnet/datasets/genentech.py``), stored as
memory-mapped files.

Raw file: ``root/raw/QM_MM_Gas_Phase_Torsion_Scan_Individual_Results_
with_CCSD_T_CBS_baseline.sdf``, the CCSD(T)/CBS torsion-scan conformations
of the paper's supporting information.  Each record's ``energy_field``
(ΔE to the scan minimum, kcal/mol) becomes ``y`` in eV; records whose
``MinMethod`` is not ``theory`` are skipped.
"""

import os

import numpy as np

from torchmdnet_tpu_torch.datasets.memdataset import (
    MemmappedDataset, missing_raw_files)
from torchmdnet_tpu_torch.utils.periodic_table import ATOMIC_NUMBERS


class GenentechTorsions(MemmappedDataset):
    KCALMOL_TO_EV = 0.0433641153087705

    def __init__(self, root=None, transform=None, pre_transform=None,
                 pre_filter=None, paths=None, theory="CCSD_T_CBS_MP2",
                 energy_field="deltaE"):
        self.name = self.__class__.__name__
        self.paths = str(paths)
        self.theory = theory
        self.energy_field = energy_field
        super().__init__(root, transform, pre_transform, pre_filter,
                         properties=("y",))

    @property
    def raw_paths(self):
        return [
            os.path.join(
                self.raw_dir,
                "QM_MM_Gas_Phase_Torsion_Scan_Individual_Results_with_"
                "CCSD_T_CBS_baseline.sdf")
        ]

    def download(self):
        raise missing_raw_files(self.name, self.raw_paths)

    def process(self):
        if not os.path.exists(self.raw_paths[0]):
            self.download()
        super().process()

    def sample_iter(self, mol_ids=False):
        """One sample a kept SDF record (JAX ``:61-103``): the atom block
        after the counts line, the ``<MinMethod>``, ``<energy_field>`` and
        ``<Number>`` fields, closed by ``$$$$``."""
        with open(self.raw_paths[0]) as f:
            header = 0  # lines of the record read up to its counts line
            discard = False
            delta_e = mol_id = num_atoms = None
            z, pos = [], []
            for line in f:
                stripped = line.strip()
                if discard and not stripped.startswith("$$$$"):
                    continue
                if 0 <= header < 4:
                    header += 1
                if header == 4:  # the counts line of the SDF header
                    num_atoms = int(stripped.split()[0])
                    header = -1
                    continue
                if stripped.startswith("$$$$"):
                    if not discard and delta_e is not None:
                        data = dict(
                            z=np.asarray(z, np.int64),
                            pos=np.vstack(pos).astype(np.float32),
                            y=np.asarray(delta_e * self.KCALMOL_TO_EV,
                                         np.float64).reshape(1, 1))
                        if mol_ids:
                            data["mol_id"] = mol_id
                        yield data
                    header = 0
                    discard = False
                    delta_e = mol_id = num_atoms = None
                    z, pos = [], []
                    continue
                if num_atoms is not None:
                    num_atoms -= 1
                    if num_atoms >= 0:
                        px, py, pz, el = stripped.split()[:4]
                        pos.append([float(px), float(py), float(pz)])
                        z.append(ATOMIC_NUMBERS[el])
                if stripped.startswith(">  <MinMethod>"):
                    if next(f).strip() != self.theory:
                        discard = True
                        continue
                if stripped.startswith(f">  <{self.energy_field}>"):
                    delta_e = float(next(f).strip())
                if stripped.startswith(">  <Number>"):
                    mol_id = int(next(f).strip())
