"""The port's inference adapters against the JAX package's, on the CPU:
``External`` (TorchMD's calculator) on the same weights, 1e-4; the unit
``transforms``; ``TMDNETCalculator`` for both packages under a stand-in
``ase.calculators.calculator`` on a duck-typed Atoms, with and without a
periodic cell and a charge, and the "ase is required" error without it;
and ``optimize``'s skin-cached lists against direct calls while the atoms
move less than ``skin/2``, with ``overflow()`` after a move past it.  The
weights are the port's, carried into a JAX tree (``jax.eval_shape``, no
init compile); one JAX module is compiled per jitted JAX step."""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from torchmdnet_tpu.md import calculators as jax_calculators
from torchmdnet_tpu.models.model import create_model as jax_create_model
from torchmdnet_tpu_torch.md import calculators
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.optimize import optimize

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# tests/test_export_optimize.py's TensorNet 1 x 16
ARGS = dict(
    model="tensornet", embedding_dimension=16, num_layers=1, num_rbf=8,
    rbf_type="expnorm", trainable_rbf=False, activation="silu",
    cutoff_lower=0.0, cutoff_upper=5.0, max_z=20, max_num_neighbors=12,
    derivative=True, prior_model=None, output_model="Scalar",
    reduce_op="sum", precision=32, equivariance_invariance_group="O(3)",
    atom_filter=-1)
N = 7  # atoms of a replica


@pytest.fixture(scope="module")
def models():
    """The port's potential and the JAX potential with the same weights."""
    from torchmdnet_tpu.utils.torch_ckpt import convert_state_dict

    pot = create_model(ARGS, device="cpu", seed=2)
    jpot = jax_create_model(ARGS)
    z = jnp.ones((N,), jnp.int32)
    shapes = jax.eval_shape(lambda: jpot.init(
        jax.random.PRNGKey(0), z, jnp.zeros((N, 3)), jnp.zeros((N,),
                                                               jnp.int32),
        num_mols=1))
    params = convert_state_dict(
        {k: v.numpy() for k, v in pot.module.state_dict().items()},
        jax.tree.map(lambda x: np.zeros(x.shape, x.dtype),
                     shapes["params"]))
    return pot, (jpot, {"params": jax.tree.map(jnp.asarray, params)})


def replicas(b, seed=0):
    rng = np.random.RandomState(seed)
    emb = rng.randint(1, 9, (b, N))
    pos = rng.uniform(-2.0, 2.0, (b, N, 3)).astype(np.float32)
    return emb, pos


def test_external_matches_jax(models):
    """Three replicas, no box: energies [B] and forces [B, n, 3] match
    JAX's at 1e-4, and through an output transform; a box reaches the
    potential (against its direct call)."""
    pot, jax_model = models
    emb, pos = replicas(3)
    ext = calculators.External(pot, emb)
    jext = jax_calculators.External(jax_model, emb)
    for transform in (None, "eV/A -> kcal/mol/A"):
        ext.output_transformer = (lambda e, f: (e, f)) if transform is None \
            else calculators.transforms[transform]
        jext.output_transformer = (lambda e, f: (e, f)) \
            if transform is None else jax_calculators.transforms[transform]
        e, f = ext.calculate(pos.reshape(-1, 3))
        je, jf = jext.calculate(pos)
        assert e.shape == (3,) and f.shape == (3, N, 3)
        np.testing.assert_allclose(e.numpy(), je, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(f.numpy(), jf, rtol=1e-4, atol=1e-4)
    box = np.diag([6.0, 6.5, 7.0]).astype(np.float32)
    e, f = calculators.External(pot, emb).calculate(pos, box)
    y, neg_dy = pot.apply(emb.reshape(-1), pos.reshape(-1, 3),
                          np.repeat(np.arange(3), N), num_mols=3, box=box)
    np.testing.assert_array_equal(e.numpy(), y.reshape(3).numpy())
    np.testing.assert_array_equal(f.numpy(), neg_dy.reshape(3, N, 3).numpy())
    with pytest.raises(ValueError, match="use_cuda_graph"):
        calculators.External(pot, emb, use_cuda_graph=True)


def test_transforms():
    e, f = np.array([1.5, -2.0]), np.random.RandomState(1).randn(2, 3, 3)
    assert calculators.transforms.keys() == jax_calculators.transforms.keys()
    for name, fn in calculators.transforms.items():
        got, want = fn(torch.as_tensor(e), torch.as_tensor(f)), \
            jax_calculators.transforms[name](e, f)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)


class Atoms:
    """The part of ``ase.Atoms`` the calculators read."""

    def __init__(self, numbers, positions, charge=None, cell=None):
        self.numbers = numbers
        self.positions = positions
        self.info = {} if charge is None else {"charge": charge}
        self.pbc = np.array([cell is not None] * 3)
        self.cell = types.SimpleNamespace(
            array=np.zeros((3, 3)) if cell is None else cell)


@pytest.fixture
def stand_in_ase(monkeypatch):
    ase = types.ModuleType("ase")
    calc = types.ModuleType("ase.calculators")
    calculator = types.ModuleType("ase.calculators.calculator")
    calculator.Calculator = type("Calculator", (), {})
    calculator.all_changes = ["positions", "numbers", "cell"]
    for name, mod in (("ase", ase), ("ase.calculators", calc),
                      ("ase.calculators.calculator", calculator)):
        monkeypatch.setitem(sys.modules, name, mod)


def test_tmdnet_calculator(models, stand_in_ase):
    """The ASE calculators on Atoms with no cell and no charge, then with
    a periodic cell and a charge (the charge reaches the potential as
    ``q``): the port's against its potential's direct call exactly, and
    on the second (one JAX compile) against JAX's at 1e-4."""
    pot, jax_model = models
    calc = calculators.TMDNETCalculator(pot)
    jcalc = jax_calculators.TMDNETCalculator(jax_model)
    emb, pos = replicas(2, seed=3)
    for atoms in (Atoms(emb[0], pos[0]),
                  Atoms(emb[1], pos[1] + 3.0, charge=1.0,
                        cell=np.diag([6.0, 6.5, 7.0]))):
        e = calc.get_potential_energy(atoms)
        f = calc.get_forces(atoms)
        assert isinstance(e, float) and f.shape == (N, 3)
        if atoms.info:
            np.testing.assert_allclose(
                e, jcalc.get_potential_energy(atoms), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(f, jcalc.get_forces(atoms),
                                       rtol=1e-4, atol=1e-4)
        box = atoms.cell.array if atoms.pbc.any() else None
        y, neg_dy = pot.apply(atoms.numbers, atoms.positions, None,
                              num_mols=1, box=box,
                              q=torch.tensor([atoms.info.get("charge",
                                                             0.0)]))
        assert e == float(y) and np.array_equal(f, neg_dy.numpy())
    assert calc.evals == 4 and calc.atoms is atoms


def test_ase_is_required(monkeypatch):
    monkeypatch.setitem(sys.modules, "ase", None)
    monkeypatch.setitem(sys.modules, "ase.calculators", None)
    monkeypatch.setitem(sys.modules, "ase.calculators.calculator", None)
    for module in (calculators, jax_calculators):
        with pytest.raises(ImportError, match="ase is required"):
            module.TMDNETCalculator("model.ckpt")


def test_optimize_cached_lists(models):
    """``rebuild_every = 4``, ``skin = 1``: while the atoms stay within
    ``skin/2`` of the last rebuild, the cached lists give the direct
    calls' energies and forces to 1e-6 (the cached list's
    extra slots, zero terms, reorder the sums) and ``overflow()`` stays False;
    ``rebuild_every = 1`` is the direct call; a move past ``skin/2``
    sets ``overflow()``."""
    pot = models[0]
    rng = np.random.RandomState(5)
    emb, pos = replicas(2, seed=5)
    z, pos0 = emb.reshape(-1), pos.reshape(-1, 3) + np.repeat(
        [[0.0, 0, 0], [9.0, 0, 0]], N, axis=0).astype(np.float32)
    batch = np.repeat([0, 1], N)
    step = optimize(pot, z, batch, num_mols=2, rebuild_every=4, skin=1.0)
    simple = optimize(pot, z, batch, num_mols=2)
    assert not simple.overflow()
    for i in range(6):
        p = pos0 + rng.uniform(-0.2, 0.2, pos0.shape).astype(np.float32)
        y, f = step(p)
        y_ref, f_ref = pot.apply(z, p, batch, num_mols=2)
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(f.numpy(), f_ref.numpy(), rtol=1e-6,
                                   atol=1e-6)
        ys, fs = simple(p)
        assert torch.equal(ys, y_ref) and torch.equal(fs, f_ref)
    assert not step.overflow()
    p = pos0.copy()
    p[3] += 0.6  # past skin/2 of the last rebuild (call 5 of 8)
    step(p)
    assert step.overflow()
