"""The port's last dataset parsers against the JAX package's, on synthetic
raw files in each dataset's own format, seeded: MD22 (npz), the Genentech
torsion scans (SDF), WaterBox (extended XYZ, and ``parse_extxyz`` alone),
the six COMP6 v1 subsets, ``COMP6v1`` and ``COMP6v2`` (HDF5), QM9q (HDF5
with units, charged molecules) and mdCATH (a source catalogue and two
domain files, each filter).  The memory-mapped ones give the same samples
as JAX's and their processed files byte for byte; every ``download()``
raises at once, naming the file to place.  numpy and h5py only: no JAX
model is compiled."""

import os

import h5py
import numpy as np
import pytest

import torchmdnet_tpu.datasets as jax_datasets
import torchmdnet_tpu_torch.datasets as datasets
from test_torch_dataset_parsers import both, same_files, same_samples
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def write_md22(root):
    rng = np.random.RandomState(1)
    raw = os.path.join(root, "DHA", "raw")
    os.makedirs(raw)
    n, frames = 10, 5
    np.savez(os.path.join(raw, "md22_DHA.npz"), z=rng.randint(1, 9, n),
             R=rng.randn(frames, n, 3), E=rng.randn(frames),
             F=rng.randn(frames, n, 3))


def test_md22(tmp_path):
    port, _ = both(tmp_path, "MD22", write_md22, molecules="DHA")
    assert len(port) == 5 and port.name == "MD22-DHA"
    with pytest.raises(ValueError, match="Unknown dataset name"):
        datasets.MD22(str(tmp_path / "x"), molecules="caffeine")


SDF_NAME = ("QM_MM_Gas_Phase_Torsion_Scan_Individual_Results_with_CCSD_T_"
            "CBS_baseline.sdf")


def sdf_record(rng, number, method, atoms=("C", "O", "N", "H")):
    lines = [f"mol{number}", "  prog", "comment",
             f"  {len(atoms)}  1  0  0  0  0  0  0  0  0999 V2000"]
    for el in atoms:
        x, y, z = rng.randn(3)
        lines.append(f"   {x:8.4f}  {y:8.4f}  {z:8.4f} {el}   0  0")
    lines += ["  1  2  1  0", "M  END", ">  <MinMethod>", method, "",
              ">  <deltaE>", f"{rng.uniform(0, 5):.4f}", "",
              ">  <Number>", str(number), "", "$$$$"]
    return "\n".join(lines) + "\n"


def write_genentech(root):
    rng = np.random.RandomState(7)
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    text = "".join(sdf_record(rng, i, "MP2" if i == 2 else "CCSD_T_CBS_MP2",
                              ("C", "O", "N", "H", "H")[:3 + i % 3])
                   for i in range(5))
    with open(os.path.join(raw, SDF_NAME), "w") as fh:
        fh.write(text)


def test_genentech(tmp_path):
    port, _ = both(tmp_path, "GenentechTorsions", write_genentech)
    assert len(port) == 4  # record 2 is of another MinMethod
    assert port.properties == ("y",)


def extxyz_text(rng, frames, lattice=True, energy=True):
    text = ""
    for i in range(frames):
        n = 3 * (i % 2 + 1)
        props = []
        if energy:
            props.append(f"TotEnergy={rng.uniform(-300, -200):.6f}")
        if lattice:
            props.append('Lattice="9.85 0.0 0.0 0.0 9.85 0.0 0.0 0.0 9.85"')
        text += f"{n}\n" + " ".join(props + ['pbc="T T T"']) + "\n"
        for j in range(n):
            el, z = ("O", 8) if j % 3 == 0 else ("H", 1)
            vals = rng.randn(6)
            text += f"{el} " + " ".join(f"{v:.6f}" for v in vals) + f" {z}\n"
    return text


def write_water(root):
    raw = os.path.join(root, "raw", "training-set")
    os.makedirs(raw)
    with open(os.path.join(raw, "dataset_1593.xyz"), "w") as fh:
        fh.write(extxyz_text(np.random.RandomState(8), 4))


def test_waterbox(tmp_path):
    port, jax = both(tmp_path, "WaterBox", write_water)
    assert len(port) == 4
    np.testing.assert_array_equal(port.box, jax.box)
    np.testing.assert_allclose(np.diag(port.box), 9.85)


@pytest.mark.parametrize("lattice, energy", [(True, True), (False, False)])
def test_parse_extxyz(tmp_path, lattice, energy):
    """``parse_extxyz`` alone: a NaN energy and a zero box where a frame's
    comment line has none."""
    from torchmdnet_tpu.datasets.water import parse_extxyz as jax_parse
    from torchmdnet_tpu_torch.datasets.water import parse_extxyz

    path = tmp_path / "frames.xyz"
    path.write_text(extxyz_text(np.random.RandomState(9), 3, lattice,
                                energy))
    got, want = parse_extxyz(str(path)), jax_parse(str(path))
    for a, b in zip(got, want):
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert np.isnan(got[0][0]) != energy
    assert bool(np.asarray(got[4]).any()) == lattice


COMP6_V1 = ("ANIMD", "DrugBank", "GDB07to09", "GDB10to13", "Tripeptides",
            "S66X8")


def write_comp6_v1(root):
    """Every file of the six v1 subsets: one top group of two molecules
    with byte-string species."""
    rng = np.random.RandomState(4)
    raw = os.path.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    for name in COMP6_V1:
        for fname in getattr(datasets, name).raw_file_names:
            with h5py.File(os.path.join(raw, fname), "w") as f:
                g = f.create_group(fname.split(".")[0])
                for m in range(2):
                    mol = g.create_group(f"m{m}")
                    n = 3 + m
                    mol["species"] = np.array([b"C", b"N", b"O", b"H"])[
                        rng.randint(0, 4, n)]
                    mol["coordinates"] = rng.randn(2, n, 3).astype(
                        np.float32)
                    mol["energies"] = rng.randn(2)
                    mol["forces"] = rng.randn(2, n, 3).astype(np.float32)


@pytest.mark.parametrize("name", COMP6_V1)
def test_comp6_v1_subset(tmp_path, name):
    port, jax = both(tmp_path, name, write_comp6_v1)
    files = len(datasets.__dict__[name].raw_file_names)
    assert len(port) == 4 * files
    np.testing.assert_array_equal(port.get_atomref(), jax.get_atomref())
    # the files' gradients are negated into forces
    with h5py.File(port.raw_paths[0], "r") as f:
        grad = next(iter(f.values()))["m0"]["forces"][0]
    np.testing.assert_allclose(port[0]["neg_dy"], -grad * 27.211386246,
                               rtol=1e-6)


def test_comp6_v1(tmp_path):
    """The six subsets in one dataset, processed under one root."""
    roots = [str(tmp_path / "port"), str(tmp_path / "jax")]
    for root in roots:
        write_comp6_v1(root)
    port, jax = datasets.COMP6v1(roots[0]), jax_datasets.COMP6v1(roots[1])
    assert len(port) == 4 * 11  # eleven files
    same_samples(port, jax)
    same_files(*roots)
    np.testing.assert_array_equal(port.subset_indices, jax.subset_indices)
    np.testing.assert_array_equal(port.get_atomref(), jax.get_atomref())


def write_comp6_v2(root):
    rng = np.random.RandomState(6)
    raw = os.path.join(root, "raw", "comp6v2_final_h5")
    os.makedirs(raw)
    with h5py.File(os.path.join(raw, "COMP6v2_wB97X-631Gd.h5"), "w") as f:
        for n in (3, 5):
            g = f.create_group(f"{n:03d}")
            g["species"] = rng.choice([1, 6, 7, 8, 9, 16, 17], (3, n))
            g["coordinates"] = rng.randn(3, n, 3).astype(np.float32)
            g["energies"] = rng.randn(3)
            g["forces"] = rng.randn(3, n, 3)


def test_comp6_v2(tmp_path):
    """COMP6 v2 keeps energies and forces, as upstream's ``ANIBase`` does.
    The JAX class takes its base's five-property default and raises
    ``KeyError('q')`` while processing (a fault of the reference, ROADMAP
    Queue 3, not mirrored): it is held against the JAX class given
    ``properties=("y", "neg_dy")``."""
    write_comp6_v2(str(tmp_path / "jax_default"))
    with pytest.raises(KeyError, match="q"):
        jax_datasets.COMP6v2(str(tmp_path / "jax_default"))
    roots = [str(tmp_path / "port"), str(tmp_path / "jax")]
    for root in roots:
        write_comp6_v2(root)
    port = datasets.COMP6v2(roots[0])
    jax = jax_datasets.COMP6v2(roots[1], properties=("y", "neg_dy"))
    assert port.properties == ("y", "neg_dy") and len(port) == 6
    same_samples(port, jax)
    same_files(*roots)
    np.testing.assert_array_equal(port.get_atomref(), jax.get_atomref())


QM9Q_UNITS = {"positions": "Å : ångströms", "energy": "E_h : hartree",
              "gradient_vector": "vector : Hartree/Bohr ",
              "electronic_charge": "n : fractional electrons",
              "dipole_moment": "\\mu : Debye "}


def write_qm9q(path, seed):
    """Molecules of total charge −1, 0 and +1, each property a group of
    per-conformation datasets with its units; one conformation's gradient
    past 100 eV/Å."""
    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        top = f.create_group("qm9q")
        for m, (z, charge) in enumerate([([6, 1, 1, 1, 1], 0),
                                         ([8, 1], -1), ([7, 1, 1, 1, 1], 1),
                                         ([6, 9, 1, 1, 1], 0)]):
            mol = top.create_group(f"mol{m}")
            mol["atomic_numbers"] = np.array(z)
            groups = {k: mol.create_group(k) for k in QM9Q_UNITS}
            for k, g in groups.items():
                g.attrs["units"] = QM9Q_UNITS[k]
            n = len(z)
            for c in range(3):
                conf = f"conf{c}"
                groups["positions"][conf] = rng.randn(n, 3)
                groups["energy"][conf] = np.float64(-40.0 + rng.randn())
                grad = rng.randn(n, 3) * 0.01
                if m == 3 and c == 1:
                    grad *= 1e4  # past the 100 eV/Å cut
                groups["gradient_vector"][conf] = grad
                pq = rng.uniform(-0.3, 0.3, n)
                groups["electronic_charge"][conf] = pq - pq.mean() + \
                    charge / n
                groups["dipole_moment"][conf] = rng.randn(3)


def test_qm9q(tmp_path):
    raw = tmp_path / "qm9q"
    raw.mkdir()
    write_qm9q(str(raw / "a.h5"), 0)
    write_qm9q(str(raw / "b.h5"), 1)
    roots = [str(tmp_path / "port"), str(tmp_path / "jax")]
    port = datasets.QM9q(roots[0], paths=str(raw))
    jax = jax_datasets.QM9q(roots[1], paths=str(raw))
    same_samples(port, jax)
    same_files(*roots)
    assert len(port) == 2 * 11  # one conformation a file is dropped
    assert port.properties == ("y", "neg_dy", "q", "pq", "dp")
    assert sorted({int(port[i]["q"]) for i in range(len(port))}) == [-1, 0,
                                                                       1]
    with pytest.raises(RuntimeError, match="downloads nothing.*nowhere"):
        datasets.QM9q(str(tmp_path / "x"), paths=str(tmp_path / "nowhere"))


@pytest.mark.parametrize("z, charge", [([6, 1, 1, 1, 1], 0), ([8, 1], -1),
                                       ([7, 1, 1, 1, 1], 1),
                                       ([6, 8, 9, 1], -2), ([6, 7, 8], 2)])
def test_qm9q_reference_energy(z, charge):
    """The greedy ionic assignment (charge-keyed element energies from
    ``INITIAL_CHARGES``) gives the JAX package's reference energy."""
    from torchmdnet_tpu.datasets.qm9q import QM9q as JaxQM9q

    assert datasets.QM9q.INITIAL_CHARGES == JaxQM9q.INITIAL_CHARGES
    got = datasets.QM9q.compute_reference_energy(z, charge)
    assert got == JaxQM9q.compute_reference_energy(z, charge)


DOMAINS = {"1abcA00": dict(numProteinAtoms=40, numResidues=5,
                           numNoHAtoms=20),
           "2xyzB01": dict(numProteinAtoms=60, numResidues=8,
                           numNoHAtoms=30)}


def write_mdcath(root, seed=0):
    """A source catalogue of two domains at two temperatures (two replicas
    each, their attributes seeded) and each domain's trajectory file."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    with h5py.File(os.path.join(root, "mdcath_source.h5"), "w") as src:
        for d, (pdb, attrs) in enumerate(DOMAINS.items()):
            grp = src.create_group(pdb)
            grp.attrs.update(attrs)
            n = attrs["numProteinAtoms"] // 10
            with h5py.File(os.path.join(
                    root, f"mdcath_dataset_{pdb}.h5"), "w") as dom:
                dom[f"{pdb}/z"] = rng.randint(1, 9, n)
                for temp in ("320", "348"):
                    for r in range(2):
                        frames = 4 + 2 * r + d
                        rg = grp.create_group(f"{temp}/{r}")
                        rg.attrs.update(
                            numFrames=frames,
                            min_gyration_radius=1.0 + 0.5 * r + d,
                            max_gyration_radius=2.0 + 0.5 * r + d,
                            alpha=2 + r, beta=1 + d)
                        g = dom.create_group(f"{pdb}/{temp}/{r}")
                        g["coords"] = rng.randn(frames, n, 3)
                        g["forces"] = rng.randn(frames, n, 3)


@pytest.mark.parametrize("kwargs", [
    {}, {"temperatures": ("320", "348"), "skip_frames": 2},
    {"numAtoms": 50}, {"numResidues": 6}, {"numNoHAtoms": 25},
    {"pdb_list": ["2xyzB01"]}, {"min_gyration_radius": 1.2},
    {"max_gyration_radius": 2.6}, {"solid_ss": 50.0}, {"numFrames": 6},
    {"alpha_beta_coil": (0.1, 0.2, 0.7)}])
def test_mdcath(tmp_path, kwargs):
    """Each filter keeps the domains and replicas JAX's does, and every
    sample (``info`` too) is JAX's."""
    root = str(tmp_path / "mdcath")
    write_mdcath(root)
    port = datasets.MDCATH(root, **kwargs)
    jax = jax_datasets.MDCATH(root, **kwargs)
    assert port.processed == jax.processed
    same_samples(port, jax)
    assert len(port) == len(jax) > 0


def test_mdcath_pdb_list_file(tmp_path):
    from torchmdnet_tpu_torch.datasets.mdcath import load_pdb_list

    path = tmp_path / "pdbs.txt"
    path.write_text("1abcA00\n\n2xyzB01\n")
    assert load_pdb_list(str(path)) == ["1abcA00", "2xyzB01"]
    with pytest.raises(ValueError, match="pdb_list"):
        load_pdb_list(3)


@pytest.mark.parametrize("name, kwargs, raw", [
    ("MD22", {"molecules": "DHA"}, "md22_DHA.npz"),
    ("GenentechTorsions", {}, SDF_NAME),
    ("WaterBox", {}, "dataset_1593.xyz"),
    ("ANIMD", {}, "ani_md_bench.h5"),
    ("GDB10to13", {}, "gdb13_13_test1000.h5"),
    ("COMP6v1", {}, "ani_md_bench.h5"),
    ("COMP6v2", {}, "COMP6v2_wB97X-631Gd.h5"),
    ("QM9q", {"paths": "qm9q_files"}, "qm9q_files"),
    ("MDCATH", {}, "mdcath_source.h5")])
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
    assert raw in str(err.value)


def test_mdcath_missing_domain_file(tmp_path):
    root = str(tmp_path / "mdcath")
    write_mdcath(root)
    os.remove(os.path.join(root, "mdcath_dataset_2xyzB01.h5"))
    with pytest.raises(RuntimeError, match="mdcath_dataset_2xyzB01.h5"):
        datasets.MDCATH(root)
