"""The port's training CLI against the JAX package's: every
``examples/*.yaml`` parses to JAX's namespace, the port's ``input.yaml``
(written without ``yaml``) loads to the dict JAX writes, ``to_argv``
carries a recipe without a YAML file, ``DataModule.setup`` builds the
named datasets with JAX's ``standardize`` mean/std (and under Atomref),
and the 13 parsers ported last raise naming a missing raw file.  Then ``main`` trains TensorNet 1
x 16 on a 40-frame revised-MD17 file on the CPU, writes its checkpoints,
splits, metrics and ``input.yaml``, and a restart from a checkpoint
continues the step and the optimizer.  No JAX model is compiled."""

import glob
import os
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from test_torch_dataset_parsers import write_qm9
from torch_parity import one_torch_thread  # noqa: F401
from torchmdnet_tpu.utils import config as jax_config
from torchmdnet_tpu_torch.datasets import NOT_PORTED
from torchmdnet_tpu_torch.utils import config

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
RECIPES = sorted(os.path.basename(p)
                 for p in glob.glob(str(ROOT / "examples" / "*.yaml")))


def test_every_recipe_is_here():
    assert len(RECIPES) == 11


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_parses_to_the_jax_namespace(recipe):
    argv = ["--conf", str(ROOT / "examples" / recipe)]
    got = vars(config.get_argparse().parse_args(argv))
    want = vars(jax_config.get_argparse().parse_args(argv))
    got.pop("conf"), want.pop("conf")
    assert got == want


@pytest.mark.parametrize("recipe", RECIPES)
def test_input_yaml_loads_to_what_jax_writes(tmp_path, recipe):
    """Written by the port's own emitter, read with ``yaml.safe_load``:
    the same dict as JAX's ``yaml.dump``, floats as floats."""
    def written(get_args, log_dir):
        get_args(["--conf", str(ROOT / "examples" / recipe), "--log-dir",
                  str(log_dir), "--lr-min", "1e-08"])
        with open(log_dir / "input.yaml") as fh:
            out = yaml.safe_load(fh)
        assert out.pop("log_dir") == str(log_dir)
        return out

    got = written(config.get_args, tmp_path / "port")
    want = written(jax_config.get_args, tmp_path / "jax")
    assert got == want
    assert isinstance(got["lr_min"], float) and got["lr_min"] == 1e-8


def test_dump_yaml_reads_back():
    conf = {"a": 1e-08, "b": 1e20, "c": float("inf"), "d": -0.0, "e": "1.0",
            "f": "null", "g": None, "h": [1, "x", 2.5, None, True],
            "i": {"molecules": "revised_aspirin", "n": 3}, "j": "O(3)",
            "k": "~/data", "l": "Å", "m": [[1.0, 2.0], [3.0]],
            "n": [{"ZBL": {"cutoff_distance": 4.0}}], "o": False}
    got = yaml.safe_load(config.dump_yaml(conf))
    assert got == conf and list(got) == sorted(conf)
    assert all(type(got[k]) is type(conf[k]) for k in conf)


def test_bool_flags_keep_the_type_bool_quirk():
    """Upstream's ``type=bool``, kept on purpose as JAX keeps it: any
    non-empty string is True, ``--standardize false`` included; only an
    empty string gives False."""
    for parser in (config.get_argparse(), jax_config.get_argparse()):
        assert parser.parse_args(["--standardize", "false"]).standardize
        assert parser.parse_args(["--derivative", "0"]).derivative
        assert not parser.parse_args(["--derivative", ""]).derivative


@pytest.mark.parametrize("recipe", RECIPES)
def test_to_argv_carries_a_recipe_without_yaml(recipe):
    """``to_argv`` gives the flags that parse to the recipe (``dataset_arg``
    as JSON, a single prior name as a one-item list), or names the value
    that needs a YAML file."""
    import json

    with open(ROOT / "examples" / recipe) as fh:
        want = yaml.safe_load(fh)
    parser = config.get_argparse()
    try:
        argv = config.to_argv(want, parser)
    except ValueError as err:
        assert recipe in ("TensorNet-SPICE.yaml", "TensorNet2-AceFF.yaml")
        assert "--conf" in str(err)
        return
    got = vars(parser.parse_args(argv))
    for key, value in want.items():
        if key == "dataset_arg":
            assert json.loads(got[key]) == value
        elif key == "prior_model" and isinstance(value, str):
            assert got[key] == [value]
        else:
            # (an int of the YAML file parses to the flag's float: equal)
            assert got[key] == value, key
            assert isinstance(got[key], bool) == isinstance(value, bool)


def write_rmd17(root, frames=40, seed=0):
    """``root/raw/rmd17/npz_data/rmd17_aspirin.npz``: seeded aspirin
    frames (C9H8O4, atoms ≥ 0.9 Å apart) with random targets."""
    rng = np.random.RandomState(seed)
    z = np.array([6] * 9 + [1] * 8 + [8] * 4)
    base = np.stack(np.meshgrid(*[np.arange(3)] * 3), -1).reshape(-1, 3)
    pos = base[:21] * 1.3 + rng.randn(frames, 21, 3) * 0.05
    d = os.path.join(root, "raw", "rmd17", "npz_data")
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "rmd17_aspirin.npz"), nuclear_charges=z,
             coords=pos, energies=rng.randn(frames) * 3 - 400,
             forces=rng.randn(frames, 21, 3))


def dm_setup(port, hp):
    if port:
        from torchmdnet_tpu_torch.data.datamodule import DataModule
    else:
        from torchmdnet_tpu.data.datamodule import DataModule
    dm = DataModule(hp)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        dm.setup("fit")
    return dm


def hparams(tmp_path, name, **extra):
    return {**dict(dataset=name, dataset_root=str(tmp_path / "data"),
                   dataset_arg=None, train_size=0.6, val_size=0.2,
                   test_size=0.2, seed=1, log_dir=None, batch_size=4,
                   standardize=True), **extra}


@pytest.mark.parametrize("case", ["MD17", "QM9-Atomref", "HDF5", "Custom"])
def test_datamodule_builds_by_name(tmp_path, case):
    """``setup`` builds the named dataset, splits it as JAX does and takes
    the same mean/std (less the atomrefs under Atomref), rtol 1e-6."""
    from test_torch_datasets import make_hdf5, write_custom

    (tmp_path / "data").mkdir()
    if case == "MD17":
        write_rmd17(str(tmp_path / "data"))
        hp = hparams(tmp_path, "MD17",
                     dataset_arg='{"molecules": "revised_aspirin"}')
    elif case == "QM9-Atomref":
        write_qm9(str(tmp_path / "data"), skip=())
        hp = hparams(tmp_path, "QM9", dataset_arg={"label": "energy_U0"},
                     prior_model="Atomref")
    elif case == "HDF5":
        make_hdf5(str(tmp_path / "data" / "d.h5"))
        hp = hparams(tmp_path, "HDF5", dataset_preload_limit=0)
        hp["dataset_root"] = str(tmp_path / "data" / "d.h5")
    else:
        globs = write_custom(tmp_path / "data")
        hp = hparams(tmp_path, "Custom", coord_files=globs[0],
                     embed_files=globs[1], energy_files=globs[2],
                     force_files=globs[3])
    port = dm_setup(True, hp)
    # the JAX package reads dataset_arg as a dict only
    jax_hp = dict(hp, dataset_arg={"molecules": "revised_aspirin"}
                  if case == "MD17" else hp["dataset_arg"])
    if case == "MD17":  # its own files: the memmaps are the port's
        jax_hp["dataset_root"] = str(tmp_path / "jax")
        write_rmd17(jax_hp["dataset_root"])
    jax = dm_setup(False, jax_hp)
    for a, b in ((port.idx_train, jax.idx_train), (port.idx_val, jax.idx_val),
                 (port.idx_test, jax.idx_test)):
        np.testing.assert_array_equal(a, b)
    assert np.isclose(port.mean, jax.mean, rtol=1e-6, atol=0)
    assert np.isclose(port.std, jax.std, rtol=1e-6, atol=0)
    if case == "QM9-Atomref":
        # the atomrefs came out: ~1,000 eV a heavy atom
        plain = dm_setup(True, dict(hp, prior_model=None))
        assert plain.mean - port.mean < -1000
        np.testing.assert_array_equal(port.atomref, jax.atomref)


# the names whose parsers were the last to be ported, and the raw file
# each names when it is missing
LAST_PARSERS = {
    "ANIMD": "ani_md_bench.h5", "COMP6v1": "ani_md_bench.h5",
    "COMP6v2": "COMP6v2_wB97X-631Gd.h5", "DrugBank": "drugbank_testset.h5",
    "GDB07to09": "gdb11_07_test500.h5", "GDB10to13": "gdb11_10_test500.h5",
    "Tripeptides": "tripeptide_full.h5", "S66X8": "s66x8_wb97x6-31gd.h5",
    "MD22": "md22_DHA.npz", "MDCATH": "mdcath_source.h5",
    "QM9q": "qm9q_files", "WaterBox": "dataset_1593.xyz",
    "GenentechTorsions": "CCSD_T_CBS_baseline.sdf"}
LAST_PARSER_ARGS = {"MD22": {"molecules": "DHA"},
                    "QM9q": {"paths": "qm9q_files"}}


@pytest.mark.parametrize("name", LAST_PARSERS)
def test_unported_dataset_raises(tmp_path, name):
    """Every name the JAX package registers builds by its name now
    (``NOT_PORTED`` is empty); without its raw files it raises naming the
    file to place, since nothing is downloaded."""
    from torchmdnet_tpu_torch.data.datamodule import DataModule

    assert NOT_PORTED == ()
    with pytest.raises(RuntimeError, match="downloads nothing") as err:
        DataModule(hparams(tmp_path, name,
                           dataset_arg=LAST_PARSER_ARGS.get(name))
                   ).setup("fit")
    assert LAST_PARSERS[name] in str(err.value)


CLI_ARGS = dict(
    model="tensornet", embedding_dimension=16, num_layers=1, num_rbf=8,
    dataset="MD17", dataset_arg={"molecules": "revised_aspirin"},
    derivative=True, batch_size=4, inference_batch_size=8, train_size=24,
    val_size=8, test_size=8, num_epochs=2, save_interval=1, standardize=True,
    max_num_neighbors=24, cutoff_upper=4.5, lr=1e-3, lr_warmup_steps=3,
    y_weight=0.5, neg_dy_weight=0.5, num_workers=0, ngpus=1, seed=1,
    pallas_embedding=True, pallas_edge_mlp=True)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A YAML run of ``main`` on the CPU, then a restart from its last
    checkpoint for one more epoch (flags only, no YAML)."""
    from torchmdnet_tpu_torch.train.train import main

    tmp = tmp_path_factory.mktemp("cli")
    write_rmd17(str(tmp / "data"))
    conf = dict(CLI_ARGS, dataset_root=str(tmp / "data"),
                log_dir=str(tmp / "logs"))
    with open(tmp / "conf.yaml", "w") as fh:
        yaml.safe_dump(conf, fh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        first = main(["--conf", str(tmp / "conf.yaml")], device="cpu")
        last = sorted(f for f in os.listdir(tmp / "logs")
                      if f.startswith("epoch=1"))[0]
        resume = config.to_argv(dict(conf, log_dir=str(tmp / "logs2"),
                                     num_epochs=1))
        # the checkpoint's hyperparameters first, the flags after them win
        second = main(["--load-model", str(tmp / "logs" / last)] + resume,
                      device="cpu")
    return tmp, first, second, last


def test_cli_trains_from_a_file(cli_run):
    tmp, first, _, _ = cli_run
    names = os.listdir(tmp / "logs")
    for f in ("splits.npz", "metrics.csv", "input.yaml", "best.ckpt",
              "best.ckpt.native"):
        assert f in names, f
    assert sum(n.endswith(".ckpt") and n.startswith("epoch=")
               for n in names) == 2
    assert np.isfinite(first["test_y_l1_loss"])
    assert np.isfinite(first["test_neg_dy_l1_loss"])
    with open(tmp / "logs" / "input.yaml") as fh:
        written = yaml.safe_load(fh)
    assert written["dataset_arg"] == CLI_ARGS["dataset_arg"]
    assert "conf" not in written
    assert os.path.exists(tmp / "data" / "processed"
                          / "MD17-revised_aspirin.idx.mmap")
    splits = np.load(tmp / "logs" / "splits.npz")
    assert len(splits["idx_train"]) == 24


def test_cli_model_carries_the_train_split_stats(cli_run):
    from torchmdnet_tpu_torch.models.model import load_model

    tmp, _, _, last = cli_run
    raw = np.load(tmp / "data" / "raw" / "rmd17" / "npz_data"
                  / "rmd17_aspirin.npz")
    y = raw["energies"][np.load(tmp / "logs" / "splits.npz")["idx_train"]]
    pot = load_model(str(tmp / "logs" / last), device="cpu")
    assert np.isclose(pot.module.mean, y.mean(), rtol=1e-6)
    assert np.isclose(pot.module.std, y.std(ddof=1), rtol=1e-6)
    assert pot.hparams["pallas_embedding"] and pot.hparams["pallas_edge_mlp"]


def test_cli_resume_continues_the_step(cli_run):
    tmp, _, second, last = cli_run
    before = torch.load(tmp / "logs" / (last + ".native"), weights_only=True)
    after_name = [f for f in os.listdir(tmp / "logs2")
                  if f.startswith("epoch=0") and f.endswith(".native")][0]
    after = torch.load(tmp / "logs2" / after_name, weights_only=True)
    steps = 24 // 4
    assert before["step"] == 2 * steps and after["step"] == 3 * steps
    adam_before = before["optimizer"]["state"][0]["step"]
    adam_after = after["optimizer"]["state"][0]["step"]
    assert float(adam_after) == float(adam_before) + steps
    assert np.isfinite(second["test_y_l1_loss"])
