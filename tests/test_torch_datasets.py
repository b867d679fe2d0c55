"""File-backed data of the port against the JAX package: the memory-mapped
files interchange both ways byte for byte, the HDF5 (preloaded and
streamed) and Custom datasets and ``write_as_hdf5`` read and write what
JAX's do, and the loader packs a memory-mapped ``Subset`` through the
native packer into the batches of JAX's packer and of the port's numpy
``pad_samples``, every key and dtype.  A failed packer build raises.
numpy and torch only: no JAX model is compiled."""

import filecmp
import os
import shutil

import h5py
import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401
from torchmdnet_tpu.data import _native as jax_native
from torchmdnet_tpu.data.collate import PaddedLoader as JaxLoader
from torchmdnet_tpu.datasets import HDF5 as JaxHDF5
from torchmdnet_tpu.datasets import Custom as JaxCustom
from torchmdnet_tpu.datasets.memdataset import (
    MemmappedDataset as JaxMemmapped)
from torchmdnet_tpu.datasets.memdataset import Subset as JaxSubset
from torchmdnet_tpu_torch.data import _native
from torchmdnet_tpu_torch.data.collate import PaddedLoader, pad_samples
from torchmdnet_tpu_torch.datasets import HDF5, Custom, MemmappedDataset
from torchmdnet_tpu_torch.datasets.memdataset import Subset
from torchmdnet_tpu_torch.utils.io import write_as_hdf5

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PROPS = ("y", "neg_dy", "q", "pq", "dp")


def seeded_samples(n=23, seed=0):
    """Molecules of 3-11 atoms with every property, from ``seed``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a = rng.randint(3, 12)
        out.append(dict(z=rng.randint(1, 36, a), pos=rng.randn(a, 3),
                        y=rng.randn(1, 1), neg_dy=rng.randn(a, 3),
                        q=rng.randint(-2, 3), pq=rng.randn(a),
                        dp=rng.randn(3)))
    return out


def memmapped(base, samples):
    """A memory-mapped dataset class of ``base`` (either package's)
    serving ``samples``, named ``Seeded``."""
    class Seeded(base):
        def __init__(self, root, properties=PROPS):
            self.name = "Seeded"
            super().__init__(root, properties=properties)

        def sample_iter(self, mol_ids=False):
            yield from samples
    return Seeded


def same_samples(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        sa, sb = a[i], b[i]
        assert sorted(sa) == sorted(sb), i
        for key in sa:
            va, vb = np.asarray(sa[key]), np.asarray(sb[key])
            assert va.dtype == vb.dtype, (i, key, va.dtype, vb.dtype)
            np.testing.assert_array_equal(va, vb, err_msg=f"{i} {key}")


def same_batches(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, (key, a[key].dtype,
                                              b[key].dtype)
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("props", [PROPS, ("y", "neg_dy"), ("y",)])
def test_memmap_files_interchange_byte_for_byte(tmp_path, props):
    samples = seeded_samples()
    port = memmapped(MemmappedDataset, samples)(str(tmp_path / "port"),
                                                properties=props)
    jax = memmapped(JaxMemmapped, samples)(str(tmp_path / "jax"),
                                           properties=props)
    names = sorted(os.listdir(tmp_path / "port" / "processed"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "processed"))
    assert len(names) == 3 + len(props)
    assert all(n.startswith("Seeded.") and n.endswith(".mmap")
               for n in names)
    _, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "port" / "processed", tmp_path / "jax" / "processed",
        names, shallow=False)
    assert not mismatch and not errors
    same_samples(port, jax)
    # each package opens the other's files, without its samples
    for src, dst in (("port", "jax2"), ("jax", "port2")):
        shutil.copytree(tmp_path / src / "processed",
                        tmp_path / dst / "processed")
    empty = []
    same_samples(memmapped(MemmappedDataset, empty)(
        str(tmp_path / "port2"), properties=props), port)
    same_samples(memmapped(JaxMemmapped, empty)(
        str(tmp_path / "jax2"), properties=props), port)


def test_memmap_process_leaves_no_tmp_files(tmp_path):
    ds = memmapped(MemmappedDataset, seeded_samples(5))(str(tmp_path))
    files = os.listdir(tmp_path / "processed")
    assert not any(f.endswith(".tmp") for f in files)
    assert len(ds) == 5 and ds.mmaps["idx"][0] == 0


def make_hdf5(path, ngroups=3, nsamples=4, natoms=5, seed=0):
    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        for g in range(ngroups):
            grp = f.create_group(f"g{g}")
            n = natoms + g
            grp["types"] = rng.randint(1, 9, n)
            grp["pos"] = rng.randn(nsamples, n, 3).astype(np.float32)
            grp["energy"] = rng.randn(nsamples)
            grp["forces"] = rng.randn(nsamples, n, 3)
            grp["partial_charges"] = rng.randn(nsamples, n)
        meta = f.create_group("_metadata")
        meta["atomic_number"] = np.arange(10)


@pytest.mark.parametrize("preload", [True, False])
def test_hdf5_matches_jax(tmp_path, preload):
    path = str(tmp_path / "data.h5")
    make_hdf5(path)
    paths = f"{path};{path}"  # a list of files
    limit = 1024 if preload else 0
    port, jax = HDF5(paths, limit), JaxHDF5(paths, limit)
    assert port.cached == jax.cached == preload
    assert len(port) == 24
    same_samples(port, jax)
    np.testing.assert_array_equal(port.atomic_number, np.arange(10))


def write_custom(tmp_path, nfiles=3, frames=6, atoms=7, seed=1):
    rng = np.random.RandomState(seed)
    for i in range(nfiles):
        np.save(tmp_path / f"coords_{i}.npy",
                rng.randn(frames, atoms, 3).astype(np.float32))
        np.save(tmp_path / f"embed_{i}.npy", rng.randint(1, 9, atoms))
        np.save(tmp_path / f"energy_{i}.npy",
                rng.randn(frames).astype(np.float32))
        np.save(tmp_path / f"forces_{i}.npy",
                rng.randn(frames, atoms, 3).astype(np.float32))
    return [str(tmp_path / f"{k}_*.npy")
            for k in ("coords", "embed", "energy", "forces")]


@pytest.mark.parametrize("limit", [1024, 0])
def test_custom_matches_jax(tmp_path, limit):
    globs = write_custom(tmp_path)
    port, jax = Custom(*globs, limit), JaxCustom(*globs, limit)
    assert len(port) == 18
    same_samples(port, jax)
    coords = np.load(tmp_path / "coords_1.npy")
    np.testing.assert_array_equal(port[7]["pos"], coords[1])
    with pytest.raises(ValueError, match="Either energies"):
        Custom(globs[0], globs[1])


@pytest.mark.parametrize("tile", [True, False])
def test_write_as_hdf5_matches_jax(tmp_path, tile):
    from torchmdnet_tpu.utils.io import write_as_hdf5 as jax_write

    globs = write_custom(tmp_path)
    files = {key: sorted(__import__("glob").glob(g))
             for key, g in zip(("pos", "z", "y", "neg_dy"), globs)}
    write_as_hdf5(files, str(tmp_path / "port.h5"), tile_embed=tile)
    jax_write(files, str(tmp_path / "jax.h5"), tile_embed=tile)
    with h5py.File(tmp_path / "port.h5") as a, \
            h5py.File(tmp_path / "jax.h5") as b:
        assert sorted(a) == sorted(b) == ["group_0", "group_1", "group_2"]
        for g in a:
            assert sorted(a[g]) == sorted(b[g])
            for k in a[g]:
                assert a[g][k].dtype == b[g][k].dtype
                np.testing.assert_array_equal(a[g][k][()], b[g][k][()])
    # and the HDF5 dataset reads it as the Custom one reads the npy files
    if tile:
        same_samples(HDF5(str(tmp_path / "port.h5")), Custom(*globs))


@pytest.mark.parametrize("shuffle", [False, True])
def test_memmap_loader_uses_the_native_packer(tmp_path, shuffle):
    """``PaddedLoader`` over a ``Subset`` of a memory-mapped dataset packs
    from the mapped files (``pack_from_memmap``): every batch equals JAX's
    loader's and the port's ``pad_samples`` of the same samples, every key
    and dtype, the last batch ragged."""
    samples = seeded_samples(40, seed=2)
    ds = memmapped(MemmappedDataset, samples)(str(tmp_path / "port"),
                                              properties=("y", "neg_dy",
                                                          "q", "pq"))
    jds = memmapped(JaxMemmapped, samples)(str(tmp_path / "jax"),
                                           properties=("y", "neg_dy", "q",
                                                       "pq"))
    idx = np.random.RandomState(3).permutation(40)[:29]
    loader = PaddedLoader(Subset(ds, idx), batch_size=8, shuffle=shuffle,
                          seed=5)
    jloader = JaxLoader(JaxSubset(jds, idx), batch_size=8, shuffle=shuffle,
                        seed=5)
    assert loader._memmap_base()[0] is ds
    assert loader.max_atoms == jloader.max_atoms == 128  # 8 × 11 atoms
    assert jax_native.native_available()
    calls = []
    real = _native.pack_from_memmap

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    _native.pack_from_memmap = counted
    try:
        loader.set_epoch(1)
        jloader.set_epoch(1)
        got, want = list(loader), list(jloader)
    finally:
        _native.pack_from_memmap = real
    assert len(got) == len(want) == len(loader) == 4 and len(calls) == 4
    order = (np.random.default_rng(6).permutation(np.arange(29)) if shuffle
             else np.arange(29))
    for b, (g, w) in enumerate(zip(got, want)):
        same_batches(g, w)
        chunk = order[b * 8:(b + 1) * 8]
        plain = pad_samples([ds[int(idx[i])] for i in chunk],
                            loader.max_atoms, 8)
        same_batches(g, plain)
    assert not got[-1]["mol_mask"][5:].any()


def test_transform_takes_the_numpy_path(tmp_path):
    ds = memmapped(MemmappedDataset, seeded_samples(6))(str(tmp_path))
    ds.transform = lambda s: s
    loader = PaddedLoader(ds, batch_size=4)
    assert loader._memmap_base() == (None, None)
    ds.transform = None
    got = next(iter(PaddedLoader(ds, batch_size=4, max_atoms=64)))
    want = pad_samples([ds[i] for i in range(4)], 64, 4)
    # the packer carries no dipoles, as the JAX package's does not
    assert set(want) - set(got) == {"dp"}
    same_batches(got, {k: want[k] for k in got})


def test_pack_batch_native_matches_pad_samples():
    samples = [{k: s[k] for k in ("z", "pos", "neg_dy", "pq")}
               for s in seeded_samples(7, seed=4)]
    got = _native.pack_batch_native(samples, 96, 8)
    want = pad_samples(samples, 96, 8)
    same_batches(got, {k: want[k] for k in got})
    with pytest.raises(ValueError, match="capacity"):
        _native.pack_batch_native(samples, 16, 8)


def test_packer_overflow_raises(tmp_path):
    ds = memmapped(MemmappedDataset, seeded_samples(6))(str(tmp_path))
    with pytest.raises(ValueError, match="capacity"):
        _native.pack_from_memmap(ds, np.arange(6), 8, 6)
    with pytest.raises(ValueError, match="capacity"):
        _native.pack_from_memmap(ds, np.arange(6), 640, 5)


def test_failed_packer_build_raises(tmp_path, monkeypatch):
    """No quiet numpy fallback: the compiler's message comes up."""
    bad = tmp_path / "packer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="packer build failed") as err:
        _native.build(bad)
    assert "error" in str(err.value)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="packer build failed"):
        _native.build()
    monkeypatch.setattr(_native, "_LIB", None)
    ds = memmapped(MemmappedDataset, seeded_samples(3))(str(tmp_path / "d"))
    with pytest.raises(RuntimeError, match="packer build failed"):
        list(PaddedLoader(ds, batch_size=2))
