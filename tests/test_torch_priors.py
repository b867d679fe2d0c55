"""The port's priors (``torchmdnet_tpu_torch/priors/``) against the JAX
package's on the CPU: each prior's energies and ∂pos on a ghost-padded
batch of two molecules; a TensorNet with ZBL, D2 and a LearnableAtomref
(its table carried by ``params_from_jax``) against JAX's
``create_model``; and ``standardize`` with the Atomref prior against
JAX's ``DataModule``.  The config forms, which compile nothing, are in
``test_torch_prior_args.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    PRIOR_ARGS, RTOL, TENSORNET_ARGS, flatten_params, lattice_system,
    one_torch_thread, open_molecule)
from torchmdnet_tpu import priors as jpriors
from torchmdnet_tpu.data.datamodule import DataModule as JaxDataModule
from torchmdnet_tpu.models.model import create_model as jax_create_model
from torchmdnet_tpu_torch import priors as tpriors
from torchmdnet_tpu_torch.data.datamodule import DataModule
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.utils.jax_params import params_from_jax
from utils_dummy import DummyDataset

pytestmark = pytest.mark.usefixtures("one_torch_thread")

def _close(got, want, tol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _batch():
    """Two molecules of 10 atoms (types 1-4) and 4 ghost rows (type 0,
    molecule 2); the partial charges sum to 0 per molecule."""
    rng = np.random.RandomState(4)
    parts = [open_molecule(n_atoms=10, seed=s)[1] + off
             for s, off in ((1, 0.0), (2, 30.0))]
    ghosts = 80.0 + rng.uniform(0, 3, (4, 3))
    pos = np.concatenate(parts + [ghosts]).astype(np.float32)
    z = np.concatenate([rng.randint(1, 5, 20), np.zeros(4)]).astype(np.int64)
    batch = np.repeat([0, 1, 2], [10, 10, 4]).astype(np.int64)
    q = rng.uniform(-0.5, 0.5, 24).astype(np.float32)
    q[:10] -= q[:10].mean()
    q[10:20] -= q[10:20].mean()
    q[20:] = 0.0
    return z, pos, batch, q


@pytest.mark.parametrize("name", list(PRIOR_ARGS))
def test_prior_matches_jax(name):
    """Energies (and, for the pair priors, ∂E/∂pos) of one prior, the JAX
    flax module against the port's, ghost rows in the batch."""
    z, pos, batch, q = _batch()
    num_mols, n = 2, len(z)
    rng = np.random.RandomState(7)
    y0 = rng.randn(num_mols, 1).astype(np.float32)
    x0 = rng.randn(n, 1).astype(np.float32)
    jz, jb = jnp.asarray(z.astype(np.int32)), jnp.asarray(batch.astype(np.int32))
    extra = {"partial_charges": jnp.asarray(q)}
    jprior = jpriors.PRIOR_CLASSES[name](**PRIOR_ARGS[name])
    tprior = tpriors.PRIOR_CLASSES[name](**PRIOR_ARGS[name])
    assert tprior.get_init_args().keys() == jprior.get_init_args().keys()
    if "Atomref" in name:
        variables = jprior.init(jax.random.PRNGKey(0), jnp.asarray(x0), jz,
                                jnp.asarray(pos), jb, method="pre_reduce")
        if name == "LearnableAtomref":
            table = rng.randn(5, 1).astype(np.float32)
            variables = {"params": {"atomref": jnp.asarray(table)}}
            tprior.load_state_dict(params_from_jax({"atomref": table}),
                                   strict=True)
        want = jprior.apply(variables, jnp.asarray(x0), jz, jnp.asarray(pos),
                            jb, method="pre_reduce")
        got = tprior.pre_reduce(torch.from_numpy(x0), torch.from_numpy(z),
                                torch.from_numpy(pos), torch.from_numpy(batch))
        _close(got, want)
        return

    def jax_energy(p):
        y = jprior.apply({}, jnp.asarray(y0), jz, p, jb, None, extra,
                         num_mols, method="post_reduce")
        return jnp.sum(y), y

    (jdpos, jy) = jax.grad(jax_energy, has_aux=True)(jnp.asarray(pos))
    p = torch.from_numpy(pos).requires_grad_(True)
    ty = tprior.post_reduce(torch.from_numpy(y0), torch.from_numpy(z), p,
                            torch.from_numpy(batch),
                            extra_args={"partial_charges": torch.from_numpy(q)},
                            num_mols=num_mols)
    (tdpos,) = torch.autograd.grad(ty.sum(), p)
    assert np.abs(np.asarray(jy) - y0).max() > 1e-3  # the prior adds energy
    _close(ty.detach(), jy)
    _close(tdpos, jdpos)
    assert not tdpos[20:].abs().any()  # ghosts feel nothing


def test_tensornet_with_priors_matches_jax():
    """A small TensorNet (F=16, one layer) with ZBL, D2 and a
    LearnableAtomref (random table) from ``create_model``: energy and
    forces against JAX's on the periodic lattice, the weights carried by
    ``params_from_jax``."""
    z, pos, box = lattice_system(seed=3)
    args = dict(TENSORNET_ARGS, embedding_dimension=16, num_layers=1,
                prior_model=["ZBL", "D2", "LearnableAtomref"],
                prior_args=[dict(PRIOR_ARGS["ZBL"], max_num_neighbors=32,
                                 atomic_number=tuple(range(10))),
                            dict(PRIOR_ARGS["D2"], cutoff_distance=5.0,
                                 max_num_neighbors=64,
                                 atomic_number=tuple(range(10))),
                            {"max_z": 10}])
    jpot = jax_create_model(args)
    seg = jnp.zeros((len(z),), jnp.int32)
    variables = jax.jit(lambda key, z_, p_, b_: jpot.init(
        key, z_, p_, seg, num_mols=1, box=b_))(
        jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(pos),
        jnp.asarray(box))
    params = dict(variables["params"])
    table = np.random.RandomState(1).randn(10, 1).astype(np.float32)
    params["prior_models_2"] = {"atomref": jnp.asarray(table)}
    variables = {"params": params}
    jy, jf = jax.jit(lambda v, z_, p_, b_: jpot.apply(
        v, z_, p_, seg, num_mols=1, box=b_))(
        variables, jnp.asarray(z), jnp.asarray(pos), jnp.asarray(box))

    pot = create_model(args, device="cpu")
    pot.module.load_state_dict(params_from_jax(flatten_params(params)),
                               strict=True)
    y, f = pot.apply(z, pos, num_mols=1, box=box)
    no_prior = create_model(dict(args, prior_model=None), device="cpu")
    no_prior.module.load_state_dict(
        {k: v for k, v in pot.module.state_dict().items()
         if not k.startswith("prior_model")}, strict=True)
    y0, f0 = no_prior.apply(z, pos, num_mols=1, box=box)
    assert abs(float(y - y0)) > 1.0  # the priors add energy and forces
    assert float((f - f0).abs().max()) > 1e-2
    _close(y, jy)
    _close(f, jf)


def test_standardize_with_atomref_matches_jax(tmp_path):
    """``standardize`` under the Atomref prior takes each molecule's
    atomref energies out before the mean and std, as JAX's does."""
    hp = dict(prior_model="Atomref", standardize=True, train_size=12,
              val_size=4, test_size=4, seed=0, log_dir=str(tmp_path),
              batch_size=4, splits=None, dataset=None)
    ds = DummyDataset(num_samples=20)
    jdm, tdm = JaxDataModule(hp, dataset=ds), DataModule(hp, dataset=ds)
    with pytest.warns(DeprecationWarning):
        jdm.setup("fit")
    with pytest.warns(DeprecationWarning):
        tdm.setup("fit")
    assert tdm.mean == pytest.approx(jdm.mean, rel=1e-12)
    assert tdm.std == pytest.approx(jdm.std, rel=1e-12)
    plain = DataModule(dict(hp, prior_model=None), dataset=ds)
    with pytest.warns(DeprecationWarning):
        plain.setup("fit")
    assert abs(plain.mean - tdm.mean) > 1.0
