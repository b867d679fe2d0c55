"""QM9q, charged QM9 conformations (counterpart of ``torchmdnet_tpu/
datasets/qm9q.py``, reference ``torchmdnet/datasets/qm9q.py``), stored as
memory-mapped files.

Raw files: ``paths``, one HDF5 file or a directory of them, of molecule
groups with ``atomic_numbers`` and, a dataset a property keyed by
conformation, ``positions`` (Å), ``energy`` (Hartree), ``gradient_vector``
(Hartree/Bohr, negated into forces), ``electronic_charge`` (fractional
electrons, their sum rounded into the total charge ``q``) and
``dipole_moment`` (Debye → e·Å).  Each energy loses the reference energy
of the lowest-energy ionic assignment that sums to ``q``
(:meth:`QM9q.compute_reference_energy`); conformations with a force above
100 eV/Å are dropped.  ``h5py`` is imported where a file is read.
"""

import os

import numpy as np

from torchmdnet_tpu_torch.datasets.memdataset import (
    MemmappedDataset, missing_raw_files)

HARTREE_TO_EV = 27.211386246
BOHR_TO_ANGSTROM = 0.529177
DEBYE_TO_EANG = 0.2081943


class QM9q(MemmappedDataset):
    HARTREE_TO_EV = HARTREE_TO_EV
    BORH_TO_ANGSTROM = BOHR_TO_ANGSTROM
    DEBYE_TO_EANG = DEBYE_TO_EANG

    # element → {charge: energy of the ion, Hartree}
    ELEMENT_ENERGIES = {
        1: {0: -0.5013312007, 1: 0.0000000000},
        6: {-1: -37.8236383010, 0: -37.8038423252, 1: -37.3826165878},
        7: {-1: -54.4626446440, 0: -54.5269367415, 1: -53.9895574739},
        8: {-1: -74.9699154500, 0: -74.9812632126, 1: -74.4776884006},
        9: {-1: -99.6695561536, 0: -99.6185158728},
    }

    # each element's lowest-energy charge
    INITIAL_CHARGES = {
        element: sorted(zip(charges.values(), charges.keys()))[0][1]
        for element, charges in ELEMENT_ENERGIES.items()
    }

    def __init__(self, root=None, transform=None, pre_transform=None,
                 pre_filter=None, paths=None):
        self.name = self.__class__.__name__
        self.paths = str(paths)
        super().__init__(root, transform, pre_transform, pre_filter,
                         properties=("y", "neg_dy", "q", "pq", "dp"))

    @property
    def raw_paths(self):
        if os.path.isfile(self.paths):
            return [self.paths]
        if os.path.isdir(self.paths):
            return [os.path.join(self.paths, f)
                    for f in sorted(os.listdir(self.paths))
                    if f.endswith(".h5")]
        raise missing_raw_files(self.name, [self.paths])

    @staticmethod
    def compute_reference_energy(atomic_numbers, charge):
        """The reference energy (eV) of the greedy lowest-energy ionic
        assignment whose charges sum to ``charge`` (reference
        ``qm9q.py:69-100``): from each element's lowest-energy charge,
        one unit at a time on the atom where it costs least."""
        atomic_numbers = np.asarray(atomic_numbers)
        charge = int(charge)
        table = QM9q.ELEMENT_ENERGIES
        charges = [QM9q.INITIAL_CHARGES[int(z)] for z in atomic_numbers]
        energy = sum(table[int(z)][q] for z, q in zip(atomic_numbers,
                                                       charges))
        while sum(charges) != charge:
            dq = int(np.sign(charge - sum(charges)))
            candidates = []
            for i, (z, q) in enumerate(zip(atomic_numbers, charges)):
                ions = table[int(z)]
                if (q + dq) in ions:
                    candidates.append(
                        (energy - ions[q] + ions[q + dq], i, q + dq))
            energy, i, q = sorted(candidates)[0]
            charges[i] = q
        assert sum(charges) == charge
        energy = sum(table[int(z)][q] for z, q in zip(atomic_numbers,
                                                       charges))
        return energy * QM9q.HARTREE_TO_EV

    def sample_iter(self, mol_ids=False):
        import h5py

        for path in self.raw_paths:
            with h5py.File(path, "r") as f:
                for mol_id, mol in list(next(iter(f.values())).items()):
                    z = np.asarray(mol["atomic_numbers"], np.int64)
                    for conf in mol["energy"]:
                        yield from self._conformation(mol, mol_id, z, conf,
                                                      mol_ids)

    def _conformation(self, mol, mol_id, z, conf, mol_ids):
        """The sample of conformation ``conf`` of molecule ``mol`` (none
        if a force passes 100 eV/Å or ``pre_filter`` drops it), each
        property's units checked as the reference checks them."""
        assert mol["positions"].attrs["units"] == "Å : ångströms"
        pos = np.asarray(mol["positions"][conf], np.float32)
        assert mol["energy"].attrs["units"] == "E_h : hartree"
        y = np.float64(mol["energy"][conf][()]) * self.HARTREE_TO_EV
        assert (mol["gradient_vector"].attrs["units"]
                == "vector : Hartree/Bohr ")
        neg_dy = (-np.asarray(mol["gradient_vector"][conf], np.float32)
                  * self.HARTREE_TO_EV / self.BORH_TO_ANGSTROM)
        assert (mol["electronic_charge"].attrs["units"]
                == "n : fractional electrons")
        pq = np.asarray(mol["electronic_charge"][conf], np.float32)
        q = int(np.round(pq.sum()))
        assert mol["dipole_moment"].attrs["units"] == "\\mu : Debye "
        dp = (np.asarray(mol["dipole_moment"][conf], np.float32)
              * self.DEBYE_TO_EANG)
        y -= self.compute_reference_energy(z, q)
        if np.linalg.norm(neg_dy, axis=1).max() > 100:  # eV/Å
            return
        data = dict(z=z, pos=pos, y=np.asarray(y).reshape(1, 1),
                    neg_dy=neg_dy, q=q, pq=pq, dp=dp)
        if mol_ids:
            data["mol_id"] = mol_id
        data = self._filtered(data)
        if data is not None:
            yield data
