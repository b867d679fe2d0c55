"""The ANI datasets (counterpart of ``torchmdnet_tpu/datasets/ani.py``,
reference ``torchmdnet/datasets/ani.py``), stored as memory-mapped files.

Raw formats: ANI-1, eight ``ANI-1_release/ani_gdb_s0X.h5`` files of
molecule groups with byte-string ``species``, ``coordinates`` and
``energies``; ANI-1x and ANI-1ccx, one ``ani1x-release.h5`` keyed by
molecule with a dataset for each level of theory; ANI-2x, one
``final_h5/ANI-2x-wB97X-631Gd.h5`` of groups with integer ``species``.
Energies and forces go from Hartree to eV; ``get_atomref`` gives the
self-energies of the elements (Hartree → eV).  ``h5py`` is imported where
a file is read.

ANI-1x and ANI-2x store energies and forces (the reference's
``ANIBase`` default).  The JAX package's classes leave those two on the
five-property default of its base, so they raise ``KeyError('q')`` while
processing; the port follows the reference there.
"""

import os

import numpy as np

from torchmdnet_tpu_torch.datasets.memdataset import (
    MemmappedDataset, missing_raw_files)

HARTREE_TO_EV = 27.211386246


class ANIBase(MemmappedDataset):
    HARTREE_TO_EV = HARTREE_TO_EV
    _ELEMENT_ENERGIES = {}

    def __init__(self, root, transform=None, pre_transform=None,
                 pre_filter=None, properties=("y", "neg_dy")):
        self.name = self.__class__.__name__
        super().__init__(root, transform, pre_transform, pre_filter,
                         properties=properties)

    def get_atomref(self, max_z=100):
        refs = np.zeros((max_z, 1), np.float32)
        for key, val in self._ELEMENT_ENERGIES.items():
            refs[key, 0] = val * self.HARTREE_TO_EV
        return refs

    @property
    def raw_paths(self):
        names = self.raw_file_names
        if isinstance(names, str):
            names = [names]
        return [os.path.join(self.raw_dir, n) for n in names]

    def download(self):
        raise missing_raw_files(self.name, self.raw_paths)

    def process(self):
        if not all(os.path.exists(p) for p in self.raw_paths):
            self.download()
        super().process()

    def _samples(self, mol_id, z, all_pos, all_y, all_neg_dy=None,
                 mol_ids=False):
        """The conformers of one molecule, NaN energies (and forces)
        skipped where the file has forces."""
        for i, (pos, y) in enumerate(zip(all_pos, all_y)):
            data = dict(z=z, pos=pos, y=np.asarray(y).reshape(1, 1))
            if all_neg_dy is not None:
                data["neg_dy"] = all_neg_dy[i]
            if mol_ids:
                data["mol_id"] = mol_id
            data = self._filtered(data)
            if data is not None:
                yield data


class ANI1(ANIBase):
    _ELEMENT_ENERGIES = {
        1: -0.500607632585,
        6: -37.8302333826,
        7: -54.5680045287,
        8: -75.0362229210,
    }

    def __init__(self, root, transform=None, pre_transform=None,
                 pre_filter=None):
        super().__init__(root, transform, pre_transform, pre_filter,
                         properties=("y",))

    @property
    def raw_file_names(self):
        return [os.path.join("ANI-1_release", f"ani_gdb_s{i:02d}.h5")
                for i in range(1, 9)]

    def sample_iter(self, mol_ids=False):
        import h5py

        atomic_numbers = {b"H": 1, b"C": 6, b"N": 7, b"O": 8}
        for path in self.raw_paths:
            with h5py.File(path, "r") as f:
                for mol_id, mol in list(next(iter(f.values())).items()):
                    z = np.asarray([atomic_numbers[a]
                                    for a in mol["species"]], np.int64)
                    yield from self._samples(
                        mol_id, z,
                        np.asarray(mol["coordinates"][:], np.float32),
                        np.asarray(mol["energies"][:], np.float64)
                        * self.HARTREE_TO_EV, mol_ids=mol_ids)


class _ANI1XBase(ANIBase):
    @property
    def raw_file_names(self):
        return "ani1x-release.h5"


class ANI1X(_ANI1XBase):
    _ELEMENT_ENERGIES = {
        1: -0.600952980000,
        6: -38.08316124000,
        7: -54.70775770000,
        8: -75.19446356000,
    }

    def sample_iter(self, mol_ids=False):
        import h5py

        with h5py.File(self.raw_paths[0], "r") as h5:
            for mol_id, mol in h5.items():
                z = np.asarray(mol["atomic_numbers"][:], np.int64)
                all_pos = np.asarray(mol["coordinates"][:], np.float32)
                all_y = np.asarray(mol["wb97x_dz.energy"][:],
                                   np.float64) * self.HARTREE_TO_EV
                all_f = np.asarray(mol["wb97x_dz.forces"][:],
                                   np.float32) * self.HARTREE_TO_EV
                keep = ~(np.isnan(all_y)
                         | np.isnan(all_f).reshape(len(all_f), -1).any(1))
                yield from self._samples(mol_id, z, all_pos[keep],
                                         all_y[keep], all_f[keep], mol_ids)


class ANI1CCX(_ANI1XBase):
    _ELEMENT_ENERGIES = {
        1: -0.5991501324919538,
        6: -38.03750806057356,
        7: -54.67448347695333,
        8: -75.16043537275567,
    }

    def __init__(self, root, transform=None, pre_transform=None,
                 pre_filter=None):
        super().__init__(root, transform, pre_transform, pre_filter,
                         properties=("y",))

    def sample_iter(self, mol_ids=False):
        import h5py

        with h5py.File(self.raw_paths[0], "r") as h5:
            for mol_id, mol in h5.items():
                z = np.asarray(mol["atomic_numbers"][:], np.int64)
                all_pos = np.asarray(mol["coordinates"][:], np.float32)
                all_y = np.asarray(mol["ccsd(t)_cbs.energy"][:],
                                   np.float64) * self.HARTREE_TO_EV
                keep = ~np.isnan(all_y)
                yield from self._samples(mol_id, z, all_pos[keep],
                                         all_y[keep], mol_ids=mol_ids)


class ANI2X(ANIBase):
    # sae_linfit.dat self energies (ASE_ANI ani-2x_8x)
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
        return [os.path.join("final_h5", "ANI-2x-wB97X-631Gd.h5")]

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
