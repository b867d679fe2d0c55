"""The COMP6 benchmark suites v1 and v2 (counterpart of ``torchmdnet_tpu/
datasets/comp6.py``, reference ``torchmdnet/datasets/comp6.py``), stored as
memory-mapped files.

Raw formats: each v1 subset is one or more HDF5 files under ``root/raw``
of molecule groups with byte-string ``species`` and ``coordinates``,
``energies`` and ``forces`` (Hartree → eV; the stored "forces" are
gradients and are negated).  ``COMP6v1`` is the concatenation of the six
subsets, each processed under the same root.  v2 is one
``comp6v2_final_h5/COMP6v2_wB97X-631Gd.h5`` in ANI-2x's layout (integer
``species`` grouped by atom count).  ``h5py`` is imported where a file is
read.

``COMP6v2`` stores energies and forces (the reference's ``ANIBase``
default).  The JAX package's class takes its base's five-property default
and raises ``KeyError('q')`` while processing, as its ``ANI1X`` and
``ANI2X`` do; the port follows the reference, as its ``ani.py`` does.
"""

import os

import numpy as np

from torchmdnet_tpu_torch.datasets.ani import ANIBase
from torchmdnet_tpu_torch.datasets.memdataset import (
    Dataset, MemmappedDataset, missing_raw_files)

HARTREE_TO_EV = 27.211386246


class COMP6Base(MemmappedDataset):
    _ELEMENT_ENERGIES = {  # ANI-1x self energies, Hartree
        1: -0.500607632585,
        6: -37.8302333826,
        7: -54.5680045287,
        8: -75.0362229210,
    }
    ATOMIC_NUMBERS = {b"H": 1, b"C": 6, b"N": 7, b"O": 8}
    HARTREE_TO_EV = HARTREE_TO_EV

    def __init__(self, root, transform=None, pre_transform=None,
                 pre_filter=None):
        self.name = self.__class__.__name__
        super().__init__(root, transform, pre_transform, pre_filter,
                         properties=("y", "neg_dy"))

    @property
    def raw_paths(self):
        return [os.path.join(self.raw_dir, n) for n in self.raw_file_names]

    def get_atomref(self, max_z=100):
        refs = np.zeros((max_z, 1), np.float32)
        for key, val in self._ELEMENT_ENERGIES.items():
            refs[key, 0] = val * self.HARTREE_TO_EV
        return refs

    def download(self):
        raise missing_raw_files(self.name, self.raw_paths)

    def process(self):
        if not all(os.path.exists(p) for p in self.raw_paths):
            self.download()
        super().process()

    def sample_iter(self, mol_ids=False):
        import h5py

        for path in self.raw_paths:
            with h5py.File(path, "r") as f:
                for mol_id, mol in list(next(iter(f.values())).items()):
                    z = np.asarray([self.ATOMIC_NUMBERS[a]
                                    for a in mol["species"]], np.int64)
                    all_pos = np.asarray(mol["coordinates"][:], np.float32)
                    all_y = np.asarray(mol["energies"][:],
                                       np.float64) * self.HARTREE_TO_EV
                    # the files' "forces" are gradients
                    all_neg_dy = -np.asarray(
                        mol["forces"][:], np.float32) * self.HARTREE_TO_EV
                    for pos, y, neg_dy in zip(all_pos, all_y, all_neg_dy):
                        data = dict(z=z, pos=pos,
                                    y=np.asarray(y).reshape(1, 1),
                                    neg_dy=neg_dy)
                        if mol_ids:
                            data["mol_id"] = (
                                f"{os.path.basename(path)}_{mol_id}")
                        data = self._filtered(data)
                        if data is not None:
                            yield data


class ANIMD(COMP6Base):
    raw_file_names = ["ani_md_bench.h5"]


class DrugBank(COMP6Base):
    raw_file_names = ["drugbank_testset.h5"]


class GDB07to09(COMP6Base):
    raw_file_names = ["gdb11_07_test500.h5", "gdb11_08_test500.h5",
                      "gdb11_09_test500.h5"]


class GDB10to13(COMP6Base):
    raw_file_names = ["gdb11_10_test500.h5", "gdb11_11_test500.h5",
                      "gdb13_12_test1000.h5", "gdb13_13_test1000.h5"]


class Tripeptides(COMP6Base):
    raw_file_names = ["tripeptide_full.h5"]


class S66X8(COMP6Base):
    raw_file_names = ["s66x8_wb97x6-31gd.h5"]


V1_SUBSETS = (ANIMD, DrugBank, GDB07to09, GDB10to13, Tripeptides, S66X8)


class COMP6v1(Dataset):
    """The six COMP6 v1 subsets in one dataset (not memory-mapped itself:
    each subset is)."""

    def __init__(self, root, transform=None, pre_transform=None,
                 pre_filter=None):
        self.transform = transform
        self.subsets = [cls(root, None, pre_transform, pre_filter)
                        for cls in V1_SUBSETS]
        self.subset_indices = np.array(
            [[i_subset, i_sample]
             for i_subset, subset in enumerate(self.subsets)
             for i_sample in range(len(subset))])

    def __len__(self):
        return len(self.subset_indices)

    def get(self, idx):
        i_subset, i_sample = self.subset_indices[idx]
        return self.subsets[i_subset][i_sample]

    def get_atomref(self, max_z=100):
        return self.subsets[0].get_atomref(max_z)


class COMP6v2(ANIBase):
    """COMP6 v2 at wB97X/631Gd (the ANI-2x elements H C N O F S Cl)."""

    _ELEMENT_ENERGIES = {
        1: -0.5978583943827134,
        6: -38.08933878049795,
        7: -54.711968298621066,
        8: -75.19106774742086,
        9: -99.80348506781634,
        16: -398.1577125334925,
        17: -460.1681939421027,
    }

    @property
    def raw_file_names(self):
        return [os.path.join("comp6v2_final_h5", "COMP6v2_wB97X-631Gd.h5")]

    def sample_iter(self, mol_ids=False):
        import h5py

        with h5py.File(self.raw_paths[0], "r") as h5:
            for key, grp in h5.items():
                all_z = np.asarray(grp["species"][:], np.int64)
                all_pos = np.asarray(grp["coordinates"][:], np.float32)
                all_y = np.asarray(grp["energies"][:],
                                   np.float64) * self.HARTREE_TO_EV
                all_f = np.asarray(grp["forces"][:],
                                   np.float32) * self.HARTREE_TO_EV
                for i, (pos, y, z, neg_dy) in enumerate(
                        zip(all_pos, all_y, all_z, all_f)):
                    data = dict(z=z, pos=pos, y=np.asarray(y).reshape(1, 1),
                                neg_dy=neg_dy)
                    if mol_ids:
                        data["mol_id"] = f"{key}_{i}"
                    data = self._filtered(data)
                    if data is not None:
                        yield data
