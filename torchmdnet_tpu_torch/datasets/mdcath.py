"""The mdCATH protein-domain trajectories (counterpart of
``torchmdnet_tpu/datasets/mdcath.py``, reference ``torchmdnet/datasets/
mdcath.py``), read lazily from the HDF5 files (not memory-mapped).

Raw files, under ``root``: ``mdcath_source.h5``, a catalogue of each
domain's attributes (``numProteinAtoms``, ``numNoHAtoms``,
``numResidues``) and of each temperature's replicas (``numFrames``,
gyration radii, ``alpha``/``beta`` residue counts), and one
``<file_basename>_<pdb>.h5`` a domain, with ``<pdb>/z`` and
``<pdb>/<temperature>/<replica>/coords``/``forces`` [frames, atoms, 3].
The constructor keeps the replicas that pass the filters and takes every
``skip_frames``-th frame of each; a sample is one frame's ``z``, ``pos``,
``neg_dy`` and an ``info`` string.  Nothing is downloaded: a missing file
raises, naming it.  ``h5py`` is imported where a file is read.
"""

import logging
import os
from os.path import join as opj

import numpy as np

from torchmdnet_tpu_torch.datasets.memdataset import (
    Dataset, missing_raw_files)

logger = logging.getLogger("mdcath")


def load_pdb_list(pdb_list):
    """The domains of ``pdb_list``: a list, or a file of one a line."""
    if isinstance(pdb_list, list):
        return pdb_list
    if isinstance(pdb_list, str) and os.path.isfile(pdb_list):
        with open(pdb_list) as fh:
            return [line.strip() for line in fh if line.strip()]
    raise ValueError("Invalid pdb_list. Must be a list or a file path.")


class MDCATH(Dataset):
    def __init__(self, root, transform=None, pre_transform=None,
                 pre_filter=None, numAtoms=5000, numNoHAtoms=None,
                 numResidues=1000, temperatures=("348",), skip_frames=1,
                 pdb_list=None, min_gyration_radius=None,
                 max_gyration_radius=None, alpha_beta_coil=None,
                 solid_ss=None, numFrames=None,
                 source_file="mdcath_source.h5",
                 file_basename="mdcath_dataset"):
        self.root = root
        self.transform = transform
        self.pre_transform = pre_transform
        self.pre_filter = pre_filter
        self.source_file = source_file
        self.file_basename = file_basename
        self.numAtoms = numAtoms
        self.numNoHAtoms = numNoHAtoms
        self.numResidues = numResidues
        self.temperatures = [str(t) for t in temperatures]
        self.skip_frames = skip_frames
        self.pdb_list = (load_pdb_list(pdb_list) if pdb_list is not None
                         else None)
        self.min_gyration_radius = min_gyration_radius
        self.max_gyration_radius = max_gyration_radius
        # kept as the JAX package and the reference keep it: no filter
        # reads it
        self.alpha_beta_coil = alpha_beta_coil
        self.solid_ss = solid_ss
        self.numFrames = numFrames
        os.makedirs(root, exist_ok=True)
        source = opj(self.root, self.source_file)
        if not os.path.exists(source):
            raise missing_raw_files("MDCATH", [source])
        self._filter_and_prepare_data()
        missing = [p for p in map(self._domain_path, self.processed)
                   if not os.path.exists(p)]
        if missing:
            raise missing_raw_files("MDCATH", missing)
        self.idx = None

    def _domain_path(self, pdb_id):
        return opj(self.root, f"{self.file_basename}_{pdb_id}.h5")

    def _replica_kept(self, grp, rgrp):
        """Whether a replica passes the frame-count, gyration-radius and
        secondary-structure filters (JAX ``:121-149``)."""
        a = rgrp.attrs
        if self.numFrames is not None and a["numFrames"] < self.numFrames:
            return False
        if (self.min_gyration_radius is not None
                and a["min_gyration_radius"] < self.min_gyration_radius):
            return False
        if (self.max_gyration_radius is not None
                and a["max_gyration_radius"] > self.max_gyration_radius):
            return False
        if self.solid_ss is not None:
            ss = (a["alpha"] + a["beta"]) / grp.attrs["numResidues"] * 100
            if ss > self.solid_ss:
                return False
        return True

    def _filter_and_prepare_data(self):
        import h5py

        self.processed = {}
        self.num_conformers = 0
        limits = (("numProteinAtoms", self.numAtoms),
                  ("numResidues", self.numResidues),
                  ("numNoHAtoms", self.numNoHAtoms))
        with h5py.File(opj(self.root, self.source_file), "r") as f:
            pdb_ids = self.pdb_list if self.pdb_list is not None else list(f)
            for pdb_id in pdb_ids:
                grp = f[pdb_id]
                if any(cap is not None and grp.attrs[key] > cap
                       for key, cap in limits):
                    continue
                entries = []
                for temp in self.temperatures:
                    if temp not in grp:
                        continue
                    for replica in grp[temp]:
                        rgrp = grp[temp][replica]
                        if not self._replica_kept(grp, rgrp):
                            continue
                        num = int(rgrp.attrs["numFrames"] // self.skip_frames)
                        if num > 0:
                            entries.append((temp, replica, num))
                            self.num_conformers += num
                if entries:
                    self.processed[pdb_id] = entries
        logger.info(f"domains: {len(self.processed)}, "
                    f"conformers: {self.num_conformers}")

    def _setup_idx(self):
        self.idx = [(pdb, self._domain_path(pdb), temp, replica, ci)
                    for pdb, entries in self.processed.items()
                    for temp, replica, num in entries
                    for ci in range(num)]
        assert len(self.idx) == self.num_conformers

    def __len__(self):
        return self.num_conformers

    def get(self, element):
        import h5py

        if self.idx is None:
            self._setup_idx()
        pdb_id, path, temp, replica, conf_idx = self.idx[element]
        frame = conf_idx * self.skip_frames
        with h5py.File(path, "r") as f:
            z = np.asarray(f[pdb_id]["z"][:], np.int64)
            grp = f[f"{pdb_id}/{temp}/{replica}"]
            coords = np.asarray(grp["coords"][frame], np.float32)
            forces = np.asarray(grp["forces"][frame], np.float32)
        return dict(z=z, pos=coords, neg_dy=forces,
                    info=f"{pdb_id}_{temp}_{replica}_{conf_idx}")
