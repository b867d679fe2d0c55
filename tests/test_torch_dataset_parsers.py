"""The port's named dataset parsers against the JAX package's, on synthetic
raw files in each dataset's own format (as ``test_dataset_parsers.py``
writes them; a QM9 xyz archive of a few molecules is built here): MD17
(original and revised npz keys), QM9, SPICE, the ANI family, MACE-OFF and
Ace (layouts 1.0 and 2.0, and ``AceHF`` on parquet).  Each gives the same
samples as JAX's, its processed files byte for byte, and the same
``get_atomref``.  A missing raw file raises at once, naming it.  numpy
only: no JAX model is compiled."""

import filecmp
import io
import os
import tarfile

import h5py
import numpy as np
import pytest

import torchmdnet_tpu.datasets as jax_datasets
import torchmdnet_tpu_torch.datasets as datasets
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def same_samples(a, b):
    assert len(a) == len(b) > 0
    for i in range(len(a)):
        sa, sb = a[i], b[i]
        assert sorted(sa) == sorted(sb), i
        for key in sa:
            va, vb = np.asarray(sa[key]), np.asarray(sb[key])
            assert va.dtype == vb.dtype, (i, key)
            np.testing.assert_array_equal(va, vb, err_msg=f"{i} {key}")


def same_files(port_root, jax_root):
    names = sorted(os.listdir(os.path.join(port_root, "processed")))
    assert names == sorted(os.listdir(os.path.join(jax_root, "processed")))
    _, mismatch, errors = filecmp.cmpfiles(
        os.path.join(port_root, "processed"),
        os.path.join(jax_root, "processed"), names, shallow=False)
    assert not mismatch and not errors


def both(tmp_path, name, write, **kwargs):
    """The port's and JAX's dataset ``name`` on the raw files ``write``
    puts under each root; their samples and files compared."""
    roots = [str(tmp_path / "port"), str(tmp_path / "jax")]
    for root in roots:
        write(root)
    port = getattr(datasets, name)(roots[0], **kwargs)
    jax = getattr(jax_datasets, name)(roots[1], **kwargs)
    same_samples(port, jax)
    same_files(*roots)
    return port, jax


@pytest.mark.parametrize("revised", [False, True])
def test_md17(tmp_path, revised):
    rng = np.random.RandomState(0)
    n, frames = 21, 7
    z = np.array([6] * 9 + [1] * 8 + [8] * 4)
    pos, forces = rng.randn(frames, n, 3), rng.randn(frames, n, 3)
    energies = rng.randn(frames)

    def write(root):
        if revised:
            d = os.path.join(root, "raw", "rmd17", "npz_data")
            os.makedirs(d)
            np.savez(os.path.join(d, "rmd17_aspirin.npz"), nuclear_charges=z,
                     coords=pos, energies=energies, forces=forces)
        else:
            d = os.path.join(root, "aspirin", "raw")
            os.makedirs(d)
            np.savez(os.path.join(d, "md17_aspirin.npz"), z=z, R=pos,
                     E=energies[:, None], F=forces)

    port, _ = both(tmp_path, "MD17", write,
                   molecules="revised_aspirin" if revised else "aspirin")
    assert len(port) == frames
    np.testing.assert_allclose(port[3]["pos"], pos[3], rtol=1e-6)
    assert port.name == ("MD17-revised_aspirin" if revised
                         else "MD17-aspirin")
    with pytest.raises(ValueError, match="Unknown dataset name"):
        datasets.MD17(str(tmp_path / "x"), molecules="caffeine")


QM9_MOLS = [
    (1, [("C", 0.0, 0.0, 0.0), ("H", 1.09, 0.0, 0.0), ("H", -0.36, 1.03, 0.0),
         ("H", -0.36, -0.51, 0.89), ("H", -0.36, -0.51, -0.89)]),
    (2, [("N", 0.0, 0.0, 0.1), ("H", 0.9, 0.1, -0.2), ("H", -0.5, 0.8, -0.2),
         ("H", -0.5, -0.8, -0.2)]),
    (3, [("O", 0.0, 0.0, 0.1), ("H", 0.76, 0.0, -0.47),
         ("H", -0.76, 0.0, -0.47)]),
    (4, [("C", 0.0, 0.0, 0.0), ("F", 1.35, 0.0, 0.0), ("H", -0.4, 1.0, 0.0),
         ("H", -0.4, -0.5, 0.9), ("H", -0.4, -0.5, -0.9)]),
]


def write_qm9(root, skip=(3,)):
    """``raw/gdb9.tar.gz`` of :data:`QM9_MOLS` (properties from the id, the
    Mathematica ``*^`` exponent in one of them) and an
    ``uncharacterized.txt`` listing ``skip``."""
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    with tarfile.open(os.path.join(raw, "gdb9.tar.gz"), "w:gz") as tar:
        for gid, atoms in QM9_MOLS:
            props = [157.7 + gid, 157.3, 157.1, 0.1 * gid, 13.2, -0.38,
                     0.11, 0.49, 35.4, 0.044, -40.4 - gid, -40.47, -40.46,
                     -40.49, 6.47]
            lines = [str(len(atoms)), "gdb %d\t" % gid + "\t".join(
                f"{v:.6f}" for v in props)]
            for sym, x, y, z in atoms:
                zs = "0.1*^-5" if gid == 2 and sym == "N" else f"{z:.6f}"
                lines.append(f"{sym}\t{x:.6f}\t{y:.6f}\t{zs}\t0.0")
            data = ("\n".join(lines) + "\n").encode()
            info = tarfile.TarInfo(f"dsgdb9nsd_{gid:06d}.xyz")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    header = ["header"] * 9
    body = [f"{g} x y z" for g in skip]
    with open(os.path.join(raw, "uncharacterized.txt"), "w") as fh:
        fh.write("\n".join(header + body + ["footer"]) + "\n")


@pytest.mark.parametrize("label", ["energy_U0", "dipole_moment", "homo"])
def test_qm9(tmp_path, label):
    port, jax = both(tmp_path, "QM9", write_qm9, label=label)
    assert len(port) == 3  # molecule 3 is uncharacterized
    refs, jrefs = port.get_atomref(), jax.get_atomref()
    assert (refs is None) == (jrefs is None) == (label != "energy_U0")
    if refs is not None:
        np.testing.assert_array_equal(refs, jrefs)
        assert refs.shape == (100, 1) and refs[6, 0] != 0
    assert port[1]["pos"][0, 2] == np.float32(1e-6)
    with pytest.raises(ValueError, match="energy_U0"):
        datasets.QM9(str(tmp_path / "x"), label="nonsense")


def write_spice(root, version="1.1.3"):
    rng = np.random.RandomState(3)
    raw = os.path.join(root, "raw", "spice", version)
    os.makedirs(raw)
    with h5py.File(os.path.join(raw, f"SPICE-{version}.hdf5"), "w") as f:
        for m, (z, subset) in enumerate([([6, 1, 1, 1, 1], b"PubChem"),
                                         ([8, 1, 1], b"Dipeptides"),
                                         ([7, 1, 1, 1], b"PubChem")]):
            mol = f.create_group(f"mol{m}")
            mol["atomic_numbers"] = np.array(z)
            mol["conformations"] = rng.randn(4, len(z), 3).astype(np.float32)
            mol["formation_energy"] = rng.randn(4)
            grad = rng.randn(4, len(z), 3).astype(np.float32) * 0.01
            grad[1] *= 1e4  # past max_gradient
            mol["dft_total_gradient"] = grad
            mol["subset"] = np.array([subset])


@pytest.mark.parametrize("kwargs", [{}, {"subsets": ["PubChem"]},
                                    {"max_gradient": 50.0,
                                     "subsample_molecules": 2}])
def test_spice(tmp_path, kwargs):
    port, _ = both(tmp_path, "SPICE", write_spice, version="1.1.3",
                   **kwargs)
    assert len(port) == {0: 12, 1: 8, 2: 6}[len(kwargs)]
    assert port[0]["neg_dy"].shape == port[0]["pos"].shape


def write_ani1(root):
    rng = np.random.RandomState(2)
    raw = os.path.join(root, "raw", "ANI-1_release")
    os.makedirs(raw)
    for i in range(1, 9):
        with h5py.File(os.path.join(raw, f"ani_gdb_s{i:02d}.h5"), "w") as f:
            g = f.create_group("gdb")
            for m in range(2):
                mol = g.create_group(f"mol{i}_{m}")
                mol["species"] = np.array([b"C", b"H", b"N", b"O"][:3 + m])
                mol["coordinates"] = rng.randn(3, 3 + m, 3).astype(
                    np.float32)
                mol["energies"] = rng.randn(3)


def write_ani1x(root):
    rng = np.random.RandomState(5)
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    with h5py.File(os.path.join(raw, "ani1x-release.h5"), "w") as f:
        for m, z in enumerate([[6, 6, 1, 1], [8, 1, 1]]):
            mol = f.create_group(f"mol{m}")
            mol["atomic_numbers"] = np.array(z)
            mol["coordinates"] = rng.randn(5, len(z), 3).astype(np.float32)
            e = rng.randn(5)
            e[2] = np.nan
            forces = rng.randn(5, len(z), 3)
            forces[4, 1, 0] = np.nan
            mol["wb97x_dz.energy"], mol["wb97x_dz.forces"] = e, forces
            cc = rng.randn(5)
            cc[0] = np.nan
            mol["ccsd(t)_cbs.energy"] = cc


def write_ani2x(root):
    rng = np.random.RandomState(6)
    raw = os.path.join(root, "raw", "final_h5")
    os.makedirs(raw)
    with h5py.File(os.path.join(raw, "ANI-2x-wB97X-631Gd.h5"), "w") as f:
        for n in (3, 5):
            g = f.create_group(f"{n:03d}")
            g["species"] = rng.choice([1, 6, 7, 8, 9, 16, 17], (4, n))
            g["coordinates"] = rng.randn(4, n, 3).astype(np.float32)
            g["energies"] = rng.randn(4)
            g["forces"] = rng.randn(4, n, 3)


def test_ani1(tmp_path):
    port, jax = both(tmp_path, "ANI1", write_ani1)
    assert len(port) == 48 and port.properties == ("y",)
    np.testing.assert_array_equal(port.get_atomref(), jax.get_atomref())


def test_ani1ccx(tmp_path):
    port, jax = both(tmp_path, "ANI1CCX", write_ani1x)
    assert len(port) == 8  # a NaN energy in each molecule
    np.testing.assert_array_equal(port.get_atomref(), jax.get_atomref())


@pytest.mark.parametrize("name, write, count", [("ANI1X", write_ani1x, 6),
                                                ("ANI2X", write_ani2x, 8)])
def test_ani_with_forces(tmp_path, name, write, count):
    """ANI-1x and ANI-2x keep energies and forces, as upstream's
    ``ANIBase`` does.  The JAX classes leave these two on their base's
    five-property default and raise ``KeyError('q')`` while processing (a
    fault of the reference not mirrored): they are held against the JAX
    class given ``properties=("y", "neg_dy")``."""
    write(str(tmp_path / "jax_default"))
    with pytest.raises(KeyError, match="q"):
        getattr(jax_datasets, name)(str(tmp_path / "jax_default"))
    roots = [str(tmp_path / "port"), str(tmp_path / "jax")]
    for root in roots:
        write(root)
    port = getattr(datasets, name)(roots[0])
    jax = getattr(jax_datasets, name)(roots[1],
                                      properties=("y", "neg_dy"))
    assert port.properties == ("y", "neg_dy") and len(port) == count
    same_samples(port, jax)
    same_files(*roots)
    np.testing.assert_array_equal(port.get_atomref(), jax.get_atomref())


def write_maceoff(root):
    raw = os.path.join(root, "raw", "maceoff", "1.0")
    os.makedirs(raw)
    frames = [
        ("-12.5", [("O", 0.0, 0.0, 0.0, 0.1, 0.2, 0.3),
                   ("H", 0.9, 0.0, 0.0, -0.1, 0.0, 0.0),
                   ("H", 0.0, 0.9, 0.0, 0.0, -0.2, 0.0)]),
        ("-40.25", [("C", 0.0, 0.0, 0.0, 90.0, 0.0, 0.0),
                    ("Cl", 1.8, 0.0, 0.0, 0.0, 0.0, 0.0)]),
    ]
    text = ""
    for energy, atoms in frames:
        text += (f"{len(atoms)}\nProperties=species:S:1:pos:R:3 "
                 f"energy={energy} pbc=\"F F F\"\n")
        text += "".join(" ".join(str(v) for v in a) + " 0 0 0\n"
                        for a in atoms)
    data = text.encode()
    with tarfile.open(os.path.join(
            raw, "train_large_neut_no_bad_clean.tar.gz"), "w:gz") as tar:
        info = tarfile.TarInfo("shard0.xyz")
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("max_gradient", [None, 50.0])
def test_maceoff(tmp_path, max_gradient):
    port, _ = both(tmp_path, "MACEOFF", write_maceoff,
                   max_gradient=max_gradient)
    assert len(port) == (2 if max_gradient is None else 1)
    np.testing.assert_array_equal(port[0]["z"], [8, 1, 1])


def write_ace(path, version, seed=2, nmols=3, natoms=4, nconfs=5):
    rng = np.random.RandomState(seed)
    units = {"positions": "Å", "forces": "eV/Å", "partial_charges": "e",
             "dipole_moments": "e*Å", "formation_energies": "eV",
             "dipole_moment": "e*Å", "formation_energy": "eV"}
    with h5py.File(path, "w") as f:
        f.attrs["layout"] = "Ace"
        f.attrs["layout_version"] = version
        f.attrs["name"] = "test"
        top = f.create_group("master") if version == "2.0" else f
        for m in range(nmols):
            mol = top.create_group(f"mol_{m}")
            mol["atomic_numbers"] = rng.randint(1, 9, natoms)
            mol["formal_charges"] = rng.randint(-1, 2, natoms)
            arrays = {"positions": rng.randn(nconfs, natoms, 3),
                      "forces": rng.randn(nconfs, natoms, 3),
                      "partial_charges": rng.randn(nconfs, natoms),
                      "dipole_moments": rng.randn(nconfs, 3),
                      "formation_energies": rng.randn(nconfs)}
            arrays["forces"][1] *= 100.0
            if version == "2.0":
                arrays["formation_energies"][3] = np.nan
                for key, arr in arrays.items():
                    mol[key] = arr
                    mol[key].attrs["units"] = units[key]
                continue
            confs = mol.create_group("conformations")
            for c in range(nconfs):
                conf = confs.create_group(f"conf_{c}")
                for key, arr in arrays.items():
                    name = {"dipole_moments": "dipole_moment",
                            "formation_energies": "formation_energy"}.get(
                                key, key)
                    if name == "formation_energy" and c == 3:
                        continue  # a failed calculation
                    conf[name] = arr[c]
                    conf[name].attrs["units"] = units[name]


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("max_gradient", [None, 50.0])
def test_ace(tmp_path, version, max_gradient):
    raw = tmp_path / "ace"
    raw.mkdir()
    write_ace(str(raw / "a.h5"), version)
    write_ace(str(raw / "b.h5"), version, seed=3)
    roots = [str(tmp_path / "port"), str(tmp_path / "jax")]
    kw = dict(paths=str(raw), max_gradient=max_gradient)
    port, jax = datasets.Ace(roots[0], **kw), jax_datasets.Ace(roots[1], **kw)
    same_samples(port, jax)
    same_files(*roots)
    assert len(port) == (24 if max_gradient is None else 18)
    assert port.properties == ("y", "neg_dy", "q", "pq", "dp")
    with pytest.raises(RuntimeError, match="missing.*nowhere"):
        datasets.Ace(str(tmp_path / "x"), paths=str(tmp_path / "nowhere"))


def test_acehf_parquet(tmp_path):
    hf = pytest.importorskip("datasets")
    rng = np.random.RandomState(0)
    rows = {k: [] for k in ("atomic_numbers", "positions",
                            "formation_energy", "forces", "formal_charges",
                            "partial_charges", "dipole_moment")}
    for i in range(5):
        n = 3 + i % 3
        rows["atomic_numbers"].append(rng.randint(1, 9, n).tolist())
        rows["positions"].append(rng.randn(n, 3).tolist())
        rows["formation_energy"].append(float(rng.randn()))
        rows["forces"].append(rng.randn(n, 3).tolist())
        rows["formal_charges"].append(rng.randint(-1, 2, n).tolist())
        rows["partial_charges"].append(rng.randn(n).tolist())
        rows["dipole_moment"].append(rng.randn(3).tolist())
    path = str(tmp_path / "shard.parquet")
    hf.Dataset.from_dict(rows).to_parquet(path)
    kw = dict(root="parquet", paths=[path], split="train")
    same_samples(datasets.AceHF(**kw), jax_datasets.AceHF(**kw))
    with pytest.raises(RuntimeError, match="gitea"):
        datasets.AceHF(paths=["ssh://gitea.example/u/r/raw/a.parquet"])


@pytest.mark.parametrize("name, kwargs, raw", [
    ("MD17", {"molecules": "revised_aspirin"}, "rmd17_aspirin.npz"),
    ("QM9", {"label": "energy_U0"}, "gdb9.tar.gz"),
    ("SPICE", {"version": "2.0.1"}, "SPICE-2.0.1.hdf5"),
    ("ANI1", {}, "ani_gdb_s01.h5"),
    ("ANI1X", {}, "ani1x-release.h5"),
    ("ANI2X", {}, "ANI-2x-wB97X-631Gd.h5"),
    ("MACEOFF", {}, "train_large_neut_no_bad_clean.tar.gz")])
def test_missing_raw_file_raises_naming_it(tmp_path, monkeypatch, name,
                                           kwargs, raw):
    """Nothing is downloaded: the error names the file to place, and no
    socket is opened."""
    import socket

    def refuse(*a, **k):
        raise AssertionError("a dataset tried the network")

    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)
    with pytest.raises(RuntimeError, match="downloads nothing") as err:
        getattr(datasets, name)(str(tmp_path), **kwargs)
    assert raw in str(err.value) and str(tmp_path) in str(err.value)
