"""``load_model`` of the port against the JAX package's on the CPU.

A small TensorNet2 with the all-to-all Coulomb head (the AceFF recipe's
``coulomb_cutoff: null``), ``derivative``, a ZBL and an Atomref prior,
mean 0.7 and std 2.0, is written by JAX's ``save_torch_checkpoint`` and
read by the port's ``load_model(device="cpu")`` with the serving
overrides ``pallas_embedding=True, pallas_edge_mlp=True``: energies and
forces against JAX's ``load_model``.  Then the old AceFF layout
(``check_errors``, remixed weights) and the ``compatibility_load``
override, a frozen non-default rbf buffer, the port's own checkpoint read
by JAX's ``load_model`` (its mean and std included: the trainer's files
lost them before), the loader's key errors and delta learning."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import ATOL, EV, RTOL, SMALL_ARGS, one_torch_thread, open_molecule
from torchmdnet_tpu.models.model import create_model as jax_create_model
from torchmdnet_tpu.models.model import load_model as jax_load_model
from torchmdnet_tpu.utils.torch_ckpt import save_torch_checkpoint
from torchmdnet_tpu_torch.data.datamodule import DataModule
from torchmdnet_tpu_torch.models.model import create_model, load_model
from torchmdnet_tpu_torch.train.trainer import Trainer
from torchmdnet_tpu_torch.utils.checkpoint import save_checkpoint
from utils_dummy import DummyDataset

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_MOLS = 2
TABLE = [0.0, -13.6, -2.0, -3.0, -4.0, -5.0, -1029.8, -1484.7, -2041.3, -7.0]
ARGS = dict(
    SMALL_ARGS, embedding_dimension=16, num_layers=1, num_rbf=8,
    pallas_embedding=False, pallas_edge_mlp=False,
    q_weights=[[1.0, 0.5, 0.8, 1.2]] * 2, coulomb_cutoff=None,
    prior_model=["ZBL", "Atomref"],
    prior_args=[dict(cutoff_distance=3.0, max_num_neighbors=16,
                     atomic_number=list(range(10)), distance_scale=1e-10,
                     energy_scale=EV),
                dict(max_z=10, initial_atomref=TABLE)])
MEAN, STD = 0.7, 2.0
# the serving overrides (chip_smoke.py's serve phase); on the CPU the
# kernels' wrappers run their plain versions
SERVE = dict(pallas_embedding=True, pallas_edge_mlp=True)


def _system():
    """Two molecules (10 and 8 atoms, total charges 0 and 1) and 3 ghost
    rows in segment ``NUM_MOLS``."""
    parts = [open_molecule(10, seed=1), open_molecule(8, seed=2)]
    pos = np.concatenate([parts[0][1], parts[1][1] + 20.0,
                          np.full((3, 3), 60.0) + np.arange(3)[:, None]])
    z = np.concatenate([parts[0][0], parts[1][0], np.ones(3, np.int32)])
    batch = np.repeat([0, 1, 2], [10, 8, 3])
    q = np.array([0.0, 1.0], np.float32)
    return z.astype(np.int64), pos.astype(np.float32), batch.astype(np.int64), q


def _unremix_linear(weight, bias):
    """Inverse of ``remix_linear``: the new [3·F] row order → the old."""
    a, b = weight.shape
    w = weight.reshape(3, a // 3, b).transpose(1, 0, 2).reshape(a, b)
    return w, bias.reshape(3, a // 3).transpose(1, 0).reshape(a)


def _old_format(path, old_path, model, num_layers):
    """A pre-reorder copy of the checkpoint at ``path``, marked with
    ``check_errors`` (``tests/test_aceff_compat.py``)."""
    ckpt = torch.load(path, weights_only=False)
    sd = ckpt["state_dict"]
    keys = ["model.representation_model.tensor_embedding.linears_scalar.1"]
    if model == "tensornet":
        keys += [f"model.representation_model.layers.{i}.linears_scalar.2"
                 for i in range(num_layers)]
    for key in keys:
        w, b = _unremix_linear(sd[key + ".weight"].numpy(),
                               sd[key + ".bias"].numpy())
        assert not np.allclose(w, sd[key + ".weight"].numpy())
        sd[key + ".weight"], sd[key + ".bias"] = torch.tensor(w), torch.tensor(b)
    ckpt["hyper_parameters"]["check_errors"] = True
    torch.save(ckpt, old_path)
    return old_path


def _jax_eval(path):
    """JAX's ``load_model`` of ``path``: its potential, and its energies
    and forces on the system (jitted)."""
    z, pos, batch, q = _system()
    jpot, variables = jax_load_model(path)
    y, f = jax.jit(lambda v, p: jpot.apply(
        v, jnp.asarray(z, jnp.int32), p, jnp.asarray(batch, jnp.int32),
        num_mols=NUM_MOLS, q=jnp.asarray(q)))(variables, jnp.asarray(pos))
    return jpot, np.asarray(y), np.asarray(f)


def _port_eval(pot):
    z, pos, batch, q = _system()
    y, f = pot.apply(z, pos, batch, num_mols=NUM_MOLS, q=torch.from_numpy(q))
    return y.numpy(), f.numpy()


def _close(got, want, tol=RTOL):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """The JAX-written checkpoint and JAX ``load_model``'s energies and
    forces from it."""
    z, pos, batch, q = _system()
    jpot = jax_create_model(ARGS, mean=MEAN, std=STD)
    variables = jax.jit(lambda key, p: jpot.init(
        key, jnp.asarray(z, jnp.int32), p, jnp.asarray(batch, jnp.int32),
        num_mols=NUM_MOLS, q=jnp.asarray(q)))(jax.random.PRNGKey(3),
                                              jnp.asarray(pos))
    path = str(tmp_path_factory.mktemp("jax") / "new.ckpt")
    save_torch_checkpoint(path, jpot, variables, hparams=ARGS)
    _, y, f = _jax_eval(path)
    return path, y, f


def test_jax_checkpoint_loads_to_jax_energies_and_forces(jax_file):
    path, y, f = jax_file
    pot = load_model(path, device="cpu", **SERVE)
    assert (pot.module.mean, pot.module.std) == pytest.approx((MEAN, STD))
    assert pot.module.output_model.coulomb_cutoff is None
    atomref = pot.module.prior_model[1]
    np.testing.assert_array_equal(atomref.table[:, 0].numpy(),
                                  np.float32(TABLE))
    ty, tf = _port_eval(pot)
    _close(ty, y)
    _close(tf, f)
    assert not tf[18:].any()  # ghosts feel nothing
    # the head's all-to-all Coulomb term takes part in the forces
    pot.module.output_model.qweights[:4] *= 3.0
    assert np.abs(_port_eval(pot)[1] - tf).max() > 1e-3


@pytest.mark.parametrize("model", ["tensornet2", "tensornet"])
def test_old_format_checkpoint(jax_file, model, tmp_path):
    """The old AceFF layout, detected by ``check_errors``, loads to the
    new file's energies and forces (tensornet2: JAX's file, held against
    JAX too; tensornet: the port's, with its per-layer remixes);
    ``compatibility_load`` overrides the detection either way."""
    if model == "tensornet2":
        new, y, f = jax_file
        num_layers = ARGS["num_layers"]
    else:
        args = dict(ARGS, model="tensornet", output_model="Scalar",
                    num_layers=2)
        new = save_checkpoint(str(tmp_path / "new.ckpt"),
                              create_model(args, device="cpu", seed=4))
        num_layers = 2
    old = _old_format(new, str(tmp_path / "old.ckpt"), model, num_layers)
    y_new, f_new = _port_eval(load_model(new, device="cpu"))
    with pytest.warns(UserWarning, match="Old-format checkpoint"):
        y_old, f_old = _port_eval(load_model(old, device="cpu"))
    np.testing.assert_allclose(y_old, y_new, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f_old, f_new, rtol=1e-5, atol=1e-6)
    if model == "tensornet2":
        _close(y_old, y)
        _close(f_old, f)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # an explicit choice: no warning
        y_off, _ = _port_eval(load_model(old, device="cpu",
                                         compatibility_load=False))
    y_on, _ = _port_eval(load_model(new, device="cpu",
                                    compatibility_load=True))
    assert np.abs(y_off - y_new).max() > 1e-4
    assert np.abs(y_on - y_new).max() > 1e-4


def test_frozen_rbf_buffer_loads_from_checkpoint(jax_file, tmp_path):
    """A re-fitted but frozen expnorm basis (the means shifted by 0.1)
    takes effect through ``rbf_initial``, as in JAX
    (``tests/test_wrappers_ensemble.py::
    test_nontrainable_rbf_buffers_load_from_checkpoint``)."""
    path, y, _ = jax_file
    ckpt = torch.load(path, weights_only=False)
    key = "model.representation_model.distance_expansion.means"
    ckpt["state_dict"][key] = ckpt["state_dict"][key] + 0.1
    mod = str(tmp_path / "refit.ckpt")
    torch.save(ckpt, mod)
    pot = load_model(mod, device="cpu")
    np.testing.assert_array_equal(
        pot.module.representation_model.distance_expansion.means.numpy(),
        ckpt["state_dict"][key].numpy())
    ty, tf = _port_eval(pot)
    assert np.abs(ty - y).max() > 1e-3  # the edited buffer takes effect
    _, jy, jf = _jax_eval(mod)
    _close(ty, jy)
    _close(tf, jf)


def test_port_checkpoint_carries_mean_and_std(jax_file, tmp_path):
    """The trainer's checkpoint of a standardized model (mean 0.7, std
    2.0) with a ZBL and an Atomref prior has the key set and the tensor
    shapes of JAX's ``save_torch_checkpoint`` for the same configuration,
    and JAX's ``load_model`` reads it to the port's energies and forces,
    mean and std included."""
    hp = dict(ARGS, batch_size=4, inference_batch_size=4, lr=1e-3,
              log_dir=str(tmp_path), train_size=12, val_size=4, test_size=4,
              seed=0, standardize=False, dataset=None, splits=None)
    pot = create_model(hp, mean=MEAN, std=STD, device="cpu", seed=5)
    tr = Trainer(pot, hp, DataModule(hp, dataset=DummyDataset(20)))
    tr._init_state()
    tr._save_checkpoint(0, 1.0)
    (path,) = tmp_path.glob("epoch=0-*.ckpt")
    ours = torch.load(path, weights_only=False)["state_dict"]
    theirs = torch.load(jax_file[0], weights_only=False)["state_dict"]
    assert sorted(ours) == sorted(theirs)
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in theirs.items()}
    assert (float(ours["model.mean"]), float(ours["model.std"])) == \
        pytest.approx((MEAN, STD))
    jpot, jy, jf = _jax_eval(str(path))
    assert (jpot.module.mean, jpot.module.std) == pytest.approx((MEAN, STD))
    ty, tf = _port_eval(pot)
    _close(ty, jy, RTOL)
    _close(tf, jf, ATOL)
    # and the port reads its own file back whole
    y2, f2 = _port_eval(load_model(str(path), device="cpu"))
    np.testing.assert_array_equal(y2, ty)
    np.testing.assert_array_equal(f2, tf)


def test_aliases_overrides_and_key_errors(tmp_path):
    """A legacy model name loads as tensornet2; an override the
    hyperparameters lack warns, as JAX does; a key left over or one
    missing raises with its name."""
    args = dict(ARGS, prior_model=None, prior_args=None)
    path = save_checkpoint(str(tmp_path / "m.ckpt"),
                           create_model(args, device="cpu"))
    ckpt = torch.load(path, weights_only=False)
    ckpt["hyper_parameters"]["model"] = "tensornet-nqe"
    del ckpt["hyper_parameters"]["pallas_embedding"]
    torch.save(ckpt, tmp_path / "alias.ckpt")
    with pytest.warns(UserWarning, match="Unknown hyperparameter: "
                                         "pallas_embedding=True"):
        pot = load_model(str(tmp_path / "alias.ckpt"), device="cpu", **SERVE)
    assert pot.hparams["model"] == "tensornet2"
    np.testing.assert_array_equal(
        _port_eval(pot)[0], _port_eval(load_model(path, device="cpu"))[0])
    sd = ckpt["state_dict"]
    sd["model.output_model.extra.weight"] = torch.zeros(2)
    torch.save(ckpt, tmp_path / "extra.ckpt")
    with pytest.raises(KeyError, match="output_model.extra.weight"):
        load_model(str(tmp_path / "extra.ckpt"), device="cpu")
    del sd["model.output_model.extra.weight"]
    gone = "model.representation_model.linear.bias"
    del sd[gone]
    torch.save(ckpt, tmp_path / "missing.ckpt")
    with pytest.raises(KeyError, match="representation_model.linear.bias"):
        load_model(str(tmp_path / "missing.ckpt"), device="cpu")


def test_delta_learning_reenables_the_atomref(tmp_path):
    """A model trained on energies minus the atom references (a trailing
    Atomref with ``enable=False``, ``remove_ref_energy``) predicts totals
    when loaded with ``remove_ref_energy=False``."""
    args = dict(ARGS, remove_ref_energy=True, prior_model=["Atomref"],
                prior_args=[dict(max_z=10, initial_atomref=TABLE,
                                 enable=False)])
    pot = create_model(args, device="cpu", seed=6)
    path = save_checkpoint(str(tmp_path / "delta.ckpt"), pot)
    y_delta, f_delta = _port_eval(load_model(path, device="cpu"))
    y_total, f_total = _port_eval(load_model(path, device="cpu",
                                             remove_ref_energy=False))
    z, _, batch, _ = _system()
    ref = [sum(TABLE[t] for t in z[batch == m]) for m in range(NUM_MOLS)]
    _close(y_total[:, 0] - y_delta[:, 0], np.asarray(ref))
    np.testing.assert_array_equal(f_total, f_delta)
