"""``atom_filter``, ``AtomFilter``, ``Ensemble``/``load_ensemble``, the
trainer's ``load_weights`` and TensorNet with the ``DipoleMoment`` head and
``reduce_op="mean"``, end to end against the JAX package on the CPU (JAX
``tests/test_wrappers_ensemble.py``, which its suite marks slow)."""

import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    RTOL, TENSORNET_ARGS, flatten_params, one_torch_thread, open_molecule)
from torchmdnet_tpu.models.model import Ensemble as JaxEnsemble
from torchmdnet_tpu.models.model import create_model as jax_create_model
from torchmdnet_tpu.models.tensornet import TensorNet as JaxTensorNet
from torchmdnet_tpu.models.wrappers import AtomFilter as JaxAtomFilter
from torchmdnet_tpu.utils.torch_ckpt import save_torch_checkpoint
from torchmdnet_tpu_torch.data.datamodule import DataModule
from torchmdnet_tpu_torch.models.model import Ensemble, create_model, load_model
from torchmdnet_tpu_torch.models.wrappers import AtomFilter
from torchmdnet_tpu_torch.train.trainer import Trainer
from torchmdnet_tpu_torch.utils.jax_params import params_from_jax
from utils_dummy import DummyDataset

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGS = dict(TENSORNET_ARGS, embedding_dimension=16, num_layers=1, num_rbf=8,
            max_z=10)
NUM_MOLS = 2


def _system():
    """Two molecules (9 and 7 atoms, hydrogens among them) and 2 ghost
    rows in segment ``NUM_MOLS``."""
    parts = [open_molecule(9, seed=3), open_molecule(7, seed=4)]
    pos = np.concatenate([parts[0][1], parts[1][1] + 20.0,
                          np.array([[60.0, 60, 60], [64.0, 60, 60]])])
    z = np.concatenate([parts[0][0], parts[1][0], np.ones(2, np.int32)])
    assert (z[:16] == 1).any() and (z[:16] > 1).any()
    batch = np.repeat([0, 1, 2], [9, 7, 2])
    return z.astype(np.int64), pos.astype(np.float32), batch.astype(np.int64)


def _jax_fn(jpot):
    z, pos, batch = _system()
    return jax.jit(lambda v, p: jpot.apply(
        v, jnp.asarray(z, jnp.int32), p, jnp.asarray(batch, jnp.int32),
        num_mols=NUM_MOLS))


def _jax_init(jpot, seed=0):
    z, pos, batch = _system()
    return jax.jit(lambda key, p: jpot.init(
        key, jnp.asarray(z, jnp.int32), p, jnp.asarray(batch, jnp.int32),
        num_mols=NUM_MOLS))(jax.random.PRNGKey(seed), jnp.asarray(pos))


def _port(args, variables):
    pot = create_model(args, device="cpu")
    pot.module.load_state_dict(params_from_jax(flatten_params(
        variables["params"])), strict=True)
    return pot


def _close(got, want, tol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def test_atom_filter_matches_jax():
    """``atom_filter=1`` drops the hydrogens after the representation:
    the port's energies against JAX's, and different from the unfiltered
    model's with the same weights."""
    z, pos, batch = _system()
    args = dict(ARGS, derivative=False, atom_filter=1)
    jpot = jax_create_model(args)
    variables = _jax_init(jpot)
    y, _ = _jax_fn(jpot)(variables, jnp.asarray(pos))
    pot = _port(args, variables)
    ty, tf = pot.apply(z, pos, batch, num_mols=NUM_MOLS)
    assert tf is None
    _close(ty, y)
    y0, _ = _port(dict(args, atom_filter=-1), variables).apply(
        z, pos, batch, num_mols=NUM_MOLS)
    assert (ty - y0).abs().max() > 1e-3


def test_atom_filter_wrapper_matches_jax():
    """The standalone ``AtomFilter`` around a TensorNet representation:
    the filtered features, zero on the hydrogens, against JAX's."""
    z, pos, batch = _system()
    kw = dict(hidden_channels=16, num_layers=1, num_rbf=8, max_z=10,
              cutoff_upper=4.5, max_num_neighbors=32)
    jwrap = JaxAtomFilter(model=JaxTensorNet(**kw), remove_threshold=1)
    jz, jb = jnp.asarray(z, jnp.int32), jnp.asarray(batch, jnp.int32)
    variables = jax.jit(lambda key, p: jwrap.init(
        key, jz, p, jb, num_mols=NUM_MOLS))(jax.random.PRNGKey(2),
                                           jnp.asarray(pos))
    x, v = jax.jit(lambda var, p: jwrap.apply(var, jz, p, jb,
                                              num_mols=NUM_MOLS))(
        variables, jnp.asarray(pos))
    assert v is None
    rep = create_model(dict(ARGS, derivative=False), device="cpu") \
        .module.representation_model
    wrap = AtomFilter(rep, remove_threshold=1)
    sd = params_from_jax(flatten_params(variables["params"]))
    wrap.load_state_dict(sd, strict=True)  # keys model.…, as upstream's
    tx, tv = wrap(torch.from_numpy(z), torch.from_numpy(pos),
                  torch.from_numpy(batch), num_mols=NUM_MOLS)
    assert tv is None
    _close(tx, x)
    assert not tx[torch.from_numpy(z) <= 1].any() and tx.abs().max() > 0


def test_derivative_with_atom_filter_raises():
    for create in (jax_create_model, lambda a: create_model(a, device="cpu")):
        with pytest.raises(ValueError, match="atom filter"):
            create(dict(ARGS, atom_filter=1, derivative=True))


def test_ensemble_from_list_and_zip(tmp_path):
    """Three JAX-written checkpoints as an ensemble (a list, then a zip
    with ``return_std``): mean and ``ddof = 1`` std of energies and forces
    against JAX's ``Ensemble`` on the same members; one member gives a NaN
    std in both."""
    z, pos, batch = _system()
    jpot = jax_create_model(ARGS)
    members = [_jax_init(jpot, seed=s) for s in range(3)]
    paths = []
    for i, variables in enumerate(members):
        paths.append(str(tmp_path / f"m{i}.ckpt"))
        save_torch_checkpoint(paths[-1], jpot, variables, hparams=ARGS)

    def jax_ensemble(vs, p):
        return JaxEnsemble([(jpot, v) for v in vs], return_std=True).apply(
            jnp.asarray(z, jnp.int32), p, jnp.asarray(batch, jnp.int32),
            num_mols=NUM_MOLS)
    want = jax.jit(jax_ensemble)(members, jnp.asarray(pos))

    ens = load_model(paths, device="cpu")
    assert isinstance(ens, Ensemble) and len(ens.members) == 3
    got = ens.apply(z, pos, batch, num_mols=NUM_MOLS)
    assert len(got) == 2
    for g, w in zip(got, want[:2]):
        _close(g, w)
    zip_path = str(tmp_path / "ens.zip")
    with zipfile.ZipFile(zip_path, "w") as zf:
        for p in paths:
            zf.write(p, os.path.basename(p))
    got = load_model(zip_path, device="cpu", return_std=True).apply(
        z, pos, batch, num_mols=NUM_MOLS)
    for g, w in zip(got, want):
        _close(g, w)
    assert (got[2] > 0).all() and (got[3][:16] > 0).any()

    one = jax.jit(lambda vs, p: JaxEnsemble(
        [(jpot, vs[0])], return_std=True).apply(
        jnp.asarray(z, jnp.int32), p, jnp.asarray(batch, jnp.int32),
        num_mols=NUM_MOLS))(members[:1], jnp.asarray(pos))
    with pytest.warns(UserWarning):  # torch's "degrees of freedom <= 0"
        got = load_model(paths[:1], device="cpu", return_std=True).apply(
            z, pos, batch, num_mols=NUM_MOLS)
    for g, w in zip(got[2:], one[2:]):
        assert np.isnan(np.asarray(w)).all() and torch.isnan(g).all()


def test_trainer_load_weights_from_a_jax_checkpoint(tmp_path):
    """``load_weights`` puts a JAX-written checkpoint's weights into the
    trainer's model before the optimizer is made: energies and forces are
    JAX's, and the optimizer holds those parameters."""
    z, pos, batch = _system()
    args = dict(ARGS, derivative=True)
    jpot = jax_create_model(args)
    variables = _jax_init(jpot, seed=7)
    path = str(tmp_path / "w.ckpt")
    save_torch_checkpoint(path, jpot, variables, hparams=args)
    y, f = _jax_fn(jpot)(variables, jnp.asarray(pos))
    hp = dict(args, load_weights=path, batch_size=4, inference_batch_size=4,
              lr=1e-3, log_dir=str(tmp_path / "logs"), train_size=12,
              val_size=4, test_size=4, seed=0, standardize=False,
              dataset=None, splits=None)
    pot = create_model(hp, device="cpu", seed=11)
    tr = Trainer(pot, hp, DataModule(hp, dataset=DummyDataset(20)))
    tr._init_state()
    ty, tf = pot.apply(z, pos, batch, num_mols=NUM_MOLS)
    _close(ty, y)
    _close(tf, f)
    held = {id(p) for g in tr.state.optimizer.param_groups for p in g["params"]}
    assert held == {id(p) for p in pot.module.parameters()}


def test_tensornet_dipole_moment_mean_matches_jax():
    """TensorNet with the ``DipoleMoment`` head and ``reduce_op="mean"``
    (no derivative: the norm's gradient at a zero dipole is NaN in both),
    end to end: |Σ q_i (r_i − c)| / (n + 1) per molecule."""
    z, pos, batch = _system()
    args = dict(ARGS, derivative=False, output_model="DipoleMoment",
                reduce_op="mean")
    jpot = jax_create_model(args)
    variables = _jax_init(jpot, seed=5)
    y, _ = _jax_fn(jpot)(variables, jnp.asarray(pos))
    ty, _ = _port(args, variables).apply(z, pos, batch, num_mols=NUM_MOLS)
    assert ty.shape == (NUM_MOLS, 1) and (ty > 0).all()
    _close(ty, y)
