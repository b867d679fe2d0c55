"""Dataset writers (counterpart of ``torchmdnet_tpu/utils/io.py``,
reference ``torchmdnet/utils.py:349-385``)."""

import numpy as np


def write_as_hdf5(files, hdf5_dataset, tile_embed=True):
    """Write ``Custom``-format ``.npy`` files (``files``: lists under
    ``pos``, ``z`` and optionally ``y`` and ``neg_dy``) as one HDF5 file in
    the ``HDF5`` dataset's layout: a group a source file, with ``pos``,
    ``types`` (tiled to [frames, n] with ``tile_embed``), ``energy`` and
    ``forces``.  ``h5py`` is imported here."""
    import h5py

    with h5py.File(hdf5_dataset, "w") as f:
        for i in range(len(files["pos"])):
            grp = f.create_group(f"group_{i}")
            coord_data = np.load(files["pos"][i], mmap_mode="r")
            embed_data = np.load(files["z"][i]).astype(np.int64)
            grp["pos"] = coord_data
            grp["types"] = (np.tile(embed_data, (coord_data.shape[0], 1))
                            if tile_embed else embed_data)
            if "y" in files:
                grp["energy"] = np.load(files["y"][i], mmap_mode="r")
            if "neg_dy" in files:
                grp["forces"] = np.load(files["neg_dy"][i], mmap_mode="r")
