"""QM9 from the raw GDB-9 xyz archive (counterpart of
``torchmdnet_tpu/datasets/qm9.py``; the reference wraps torch_geometric's
QM9, ``torchmdnet/datasets/qm9.py``).

Each xyz file of ``root/raw/gdb9.tar.gz``: the atom count, a property line
``gdb <id> A B C mu alpha homo lumo gap r2 zpve U0 U H G Cv``, then the
atom rows.  The label is one of :data:`QM9_TARGETS`, in torch_geometric's
order and units (Hartree → eV for the orbital and thermochemical
energies); the molecules listed in ``root/raw/uncharacterized.txt`` are
skipped when that file is present.  ``get_atomref`` gives torch_geometric's
per-element reference energies of the label.
"""

import os
import tarfile

import numpy as np

from torchmdnet_tpu_torch.datasets.memdataset import (
    MemmappedDataset, missing_raw_files)

HAR2EV = 27.211386246

# torch_geometric's qm9_target_dict order
QM9_TARGETS = [
    "dipole_moment",
    "isotropic_polarizability",
    "homo",
    "lumo",
    "gap",
    "electronic_spatial_extent",
    "zpve",
    "energy_U0",
    "energy_U",
    "enthalpy_H",
    "free_energy",
    "heat_capacity",
]

# the raw property line after "gdb <id>", and the raw key of each target
_RAW_ORDER = ["A", "B", "C", "mu", "alpha", "homo", "lumo", "gap", "r2",
              "zpve", "U0", "U", "H", "G", "Cv"]
_TARGET_RAW_KEY = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve",
                   "U0", "U", "H", "G", "Cv"]
_CONVERSION = {
    "homo": HAR2EV, "lumo": HAR2EV, "gap": HAR2EV, "zpve": HAR2EV,
    "U0": HAR2EV, "U": HAR2EV, "H": HAR2EV, "G": HAR2EV,
}

_SYMBOLS = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}

# per-element reference values of each target (torch_geometric's SchNet
# atomrefs), energies in eV
_ATOMREFS = {
    "zpve": {},
    "energy_U0": {1: -13.61312172, 6: -1029.86312267, 7: -1485.30251237,
                  8: -2042.61123593, 9: -2713.48485589},
    "energy_U": {1: -13.5745904, 6: -1029.82456413, 7: -1485.26398105,
                 8: -2042.5727046, 9: -2713.44632457},
    "enthalpy_H": {1: -13.54887564, 6: -1029.79887659, 7: -1485.2382935,
                   8: -2042.54701705, 9: -2713.42063702},
    "free_energy": {1: -13.90303183, 6: -1030.25891228, 7: -1485.71166277,
                    8: -2043.01812778, 9: -2713.88796536},
    "heat_capacity": {1: 2.981, 6: 2.981, 7: 2.981, 8: 2.981, 9: 2.981},
}


def _float(text):
    return float(text.replace("*^", "e"))


class QM9(MemmappedDataset):
    def __init__(self, root, transform=None, label=None, pre_transform=None,
                 pre_filter=None):
        if label not in QM9_TARGETS:
            raise ValueError(
                'Please pass the desired property to train on via "label". '
                f'Available properties are {", ".join(QM9_TARGETS)}.')
        self.label = label
        self.label_idx = QM9_TARGETS.index(label)
        self.name = f"QM9-{label}"
        super().__init__(root, transform, pre_transform, pre_filter,
                         properties=("y",))

    def get_atomref(self, max_z=100):
        table = _ATOMREFS.get(self.label)
        if not table:
            return None
        refs = np.zeros((max_z, 1), np.float32)
        for zz, val in table.items():
            refs[zz, 0] = val
        return refs

    @property
    def raw_paths(self):
        return [os.path.join(self.raw_dir, "gdb9.tar.gz")]

    def download(self):
        raise missing_raw_files("QM9", self.raw_paths + [os.path.join(
            self.raw_dir, "uncharacterized.txt (optional)")])

    def process(self):
        if not os.path.exists(self.raw_paths[0]):
            self.download()
        super().process()

    def _skip_ids(self):
        path = os.path.join(self.raw_dir, "uncharacterized.txt")
        if not os.path.exists(path):
            return set()
        with open(path) as fh:
            return {int(line.split()[0]) for line in fh.readlines()[9:-1]
                    if line.split()}

    def sample_iter(self, mol_ids=False):
        skip = self._skip_ids()
        raw_key = _TARGET_RAW_KEY[self.label_idx]
        conv = _CONVERSION.get(raw_key, 1.0)
        raw_idx = _RAW_ORDER.index(raw_key)
        with tarfile.open(self.raw_paths[0], "r:gz") as tar:
            members = sorted((m for m in tar.getmembers()
                              if m.name.endswith(".xyz")),
                             key=lambda m: m.name)
            for member in members:
                fh = tar.extractfile(member)
                if fh is None:
                    continue
                lines = fh.read().decode().splitlines()
                n = int(lines[0])
                props = lines[1].split()
                gdb_id = int(props[1])
                if gdb_id in skip:
                    continue
                y = _float(props[2 + raw_idx]) * conv
                z = np.zeros(n, np.int64)
                pos = np.zeros((n, 3), np.float32)
                for i in range(n):
                    parts = lines[2 + i].split()
                    z[i] = _SYMBOLS[parts[0]]
                    pos[i] = [_float(p) for p in parts[1:4]]
                data = dict(z=z, pos=pos, y=np.asarray(y).reshape(1, 1))
                if mol_ids:
                    data["mol_id"] = gdb_id
                data = self._filtered(data)
                if data is not None:
                    yield data
