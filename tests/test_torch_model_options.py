"""What the port's ``create_model`` builds and refuses: the JAX-to-torch
key mapping of ``params_from_jax``, the TensorNet2 options the port does
not cover, the configurations it refuses as invalid, the heads that drop
the priors, TensorNet with a cell_block_spec (the parity runs:
``test_torch_tensornet2.py``, ``test_torch_tensornet.py``,
``test_torch_blocked_tensornet.py``), ``precision=16`` against JAX's
bfloat16 forward, ``precision=64`` against float32, and a checkpoint with
trainable rbf parameters through ``save_checkpoint`` and ``load_model``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (ET_ARGS, GN_ARGS, SMALL_ARGS, T_ARGS,
                          TENSORNET_ARGS, attn_system, jax_and_port,
                          one_torch_thread, open_molecule)
from torchmdnet_tpu_torch.models.model import create_model, load_model
from torchmdnet_tpu_torch.ops.cell_blocks import make_cell_block_spec
from torchmdnet_tpu_torch.utils.jax_params import flax_path_to_torch_key

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_key_mapping():
    assert flax_path_to_torch_key(
        ("representation_model", "layers_1", "linears_scalar_2", "kernel")
    ) == "representation_model.layers.1.linears_scalar.2.weight"
    assert flax_path_to_torch_key(
        ("representation_model", "charge_predict_0", "q_norm", "scale")
    ) == "representation_model.charge_predict_0.q_norm.weight"
    assert flax_path_to_torch_key(
        ("representation_model", "tensor_embedding", "emb", "embedding")
    ) == "representation_model.tensor_embedding.emb.weight"


@pytest.mark.parametrize("key,value", [
    ("remat", True), ("model", "equivariant-transformer"),
    ("precision", 16)])
def test_uncovered_options_raise(key, value):
    """Options that raised ``NotImplementedError`` before they were
    ported build: ``remat`` and ``precision=16`` (Queue 1 [17]), with
    their recomputation and their bfloat16 layers, and
    ``model="equivariant-transformer"`` ([16]) from TensorNet2's args,
    with JAX's name for the head (``EquivariantScalar`` for
    "ScalarPlusWeightedCoulomb" does not exist, so the head is "Scalar")
    and without reading ``equivariance_invariance_group``."""
    args = dict(SMALL_ARGS, **{key: value})
    if key == "model":
        args.update(ET_ARGS, output_model="Scalar")
        del args["equivariance_invariance_group"]
        pot = create_model(args, device="cpu")
        assert type(pot.module.representation_model).__name__ == "TorchMD_ET"
        assert type(pot.module.output_model).__name__ == "EquivariantScalar"
        with pytest.raises(ValueError, match="Unknown architecture"):
            create_model(dict(args, model="painn"), device="cpu")
        return
    rep = create_model(args, device="cpu").module.representation_model
    if key == "remat":
        assert rep.tensor_embedding.remat and rep.layers[0].remat
    else:
        assert rep.linear.compute_dtype == torch.bfloat16
        assert rep.charge_predict_0.q_mlp.layers[0].compute_dtype is None
        assert rep.linear.weight.dtype == torch.float32
    with pytest.raises(ValueError, match="precision"):
        create_model(dict(SMALL_ARGS, precision=8), device="cpu")


@pytest.mark.parametrize("args,match", [
    # JAX's own error (models/model.py:322-323)
    (dict(SMALL_ARGS, atom_filter=3), "atom filter"),
    # JAX builds these and fails at the first evaluation: TensorNet and
    # TensorNet2 produce no vector features, TensorNet no charges
    (dict(SMALL_ARGS, output_model="EquivariantScalar"), "equivariant"),
    (dict(SMALL_ARGS, output_model="EquivariantDipoleMoment"),
     "equivariant"),
    (dict(TENSORNET_ARGS, output_model="EquivariantVectorOutput"),
     "equivariant"),
    (dict(TENSORNET_ARGS, output_model="ScalarPlusWeightedCoulomb"),
     "charges"),
    (dict(SMALL_ARGS, output_model="Dipole"), "Unknown output model"),
    (dict(SMALL_ARGS, rbf_type="bessel"), "Unknown RBF type"),
    # on ET the head is the Equivariant one of its name, and there is no
    # EquivariantScalarPlusWeightedCoulomb (JAX: KeyError) nor a head
    # named twice
    (dict(ET_ARGS, output_model="ScalarPlusWeightedCoulomb"),
     "Unknown output model 'EquivariantScalarPlusWeightedCoulomb'"),
    (dict(ET_ARGS, output_model="EquivariantScalar"),
     "Unknown output model"),
    (dict(T_ARGS, output_model="EquivariantScalar"), "equivariant"),
    (dict(GN_ARGS, output_model="EquivariantVectorOutput"), "equivariant"),
    (dict(ET_ARGS, distance_influence="queries"), "distance_influence"),
    (dict(T_ARGS, distance_influence="queries"), "distance_influence"),
    (dict(GN_ARGS, aggr="min"), "aggr")])
def test_options_refused_with_value_error(args, match):
    with pytest.raises(ValueError, match=match):
        create_model(args, device="cpu")


@pytest.mark.parametrize("model_args", [SMALL_ARGS, TENSORNET_ARGS])
@pytest.mark.parametrize("head", ["DipoleMoment", "ElectronicSpatialExtent",
                                  "EquivariantElectronicSpatialExtent"])
def test_heads_without_priors_drop_them(model_args, head):
    """A head with ``allow_prior_model = False`` drops the priors, as JAX's
    ``create_model`` does (``models/model.py:365-366``); the Scalar head
    keeps them."""
    priors = dict(prior_model=["ZBL", "Atomref"],
                  prior_args=[{"atomic_number": list(range(10))},
                              {"max_z": 10}])
    args = dict(model_args, derivative=False, output_model=head, **priors)
    pot = create_model(args, device="cpu")
    assert len(pot.module.prior_model) == 0
    assert type(pot.module.output_model).__name__ == head
    kept = create_model(dict(args, output_model="Scalar"), device="cpu")
    assert len(kept.module.prior_model) == 2


@pytest.mark.parametrize("grouped", [False, True])
def test_cell_block_spec_builds(grouped):
    """TensorNet takes a cell_block_spec, grouped or not (the blocked tiers
    of ``bench.py::main``); ``test_torch_blocked_tensornet.py`` runs it."""
    spec = make_cell_block_spec([20.0] * 3, 5.5, 64)
    if grouped:
        spec = spec._replace(col_slots=(16,) * 9)
    pot = create_model(dict(TENSORNET_ARGS, cell_block_spec=spec),
                       device="cpu")
    assert pot.module.representation_model.cell_block_spec == spec


# TensorNet2 as in the AceFF recipe, cut down, energies only
PREC_ARGS = dict(SMALL_ARGS, embedding_dimension=16, num_layers=1,
                 num_rbf=8, cutoff_upper=5.0, max_num_neighbors=16,
                 derivative=False, q_weights=[[1.0] * 4] * 2,
                 coulomb_cutoff=None)


def test_precision_16_matches_jax_bfloat16():
    """``precision=16``: the representation's layers compute in bfloat16
    from float32 weights, as JAX's ``Linear(dtype=bfloat16)`` does, and
    the kernel ops give way to the plain chains.  The energy matches
    JAX's bfloat16 forward to 1% relative: bfloat16 keeps 8 significant
    bits and the two packages round their sums in different orders.
    The float32 energy is 8.7% away, so the check sees the bfloat16
    path."""
    z, pos, _ = open_molecule(12, seed=5)
    q = np.array([1.0], np.float32)
    args = dict(PREC_ARGS, precision=16)
    jpot, variables, tpot, _ = jax_and_port(args, z, pos, None)
    want = np.asarray(jax.jit(lambda v, z_, p_: jpot.apply(
        v, z_, p_, jnp.zeros((12,), jnp.int32), num_mols=1,
        q=jnp.asarray(q))[0])(variables, jnp.asarray(z), jnp.asarray(pos)),
        np.float64)
    got = tpot.apply(z, pos, num_mols=1, q=torch.from_numpy(q))[0]
    f32 = create_model(dict(args, precision=32), device="cpu")
    f32.module.load_state_dict(tpot.module.state_dict())
    ref32 = f32.apply(z, pos, num_mols=1, q=torch.from_numpy(q))[0]
    got, ref32 = (float(t.double().sum()) for t in (got, ref32))
    assert abs(got - float(want.sum())) <= 0.01 * abs(float(want.sum()))
    assert abs(ref32 - float(want.sum())) > 0.05 * abs(float(want.sum()))


TN_PREC_ARGS = dict(TENSORNET_ARGS, embedding_dimension=16, num_layers=1,
                    num_rbf=8, cutoff_upper=5.0, max_num_neighbors=16,
                    derivative=False)


@pytest.mark.parametrize("tabulated", [16, 0], ids=["tabulated", "exact"])
def test_tensornet_precision_16_matches_jax_bfloat16(tabulated):
    """TensorNet's ``precision=16`` against JAX's bfloat16 forward, with
    the tabulated filters (their node MLP in float32, the filter's output
    cast to bfloat16) and with the exact edge MLP: the energy within 2.5%
    relative, while the float32 energy with the same weights is at least
    5% away (11.6%).  The bound is wider than TensorNet2's 1%: this
    energy is a sum that cancels (per-atom terms several times the
    total), so each layer's one-ulp bfloat16 roundings (the layers agree
    to 1-4 ulps of their largest value) reach the total magnified; JAX's
    own unjitted bfloat16 evaluation is 0.7% from its jitted one, the
    port 1.7% (exact) and 1.9% (tabulated)."""
    z, pos, _ = open_molecule(12, seed=5)
    args = dict(TN_PREC_ARGS, precision=16, tabulated_edge_mlp=tabulated)
    jpot, variables, tpot, _ = jax_and_port(args, z, pos, None)
    want = float(np.asarray(jax.jit(lambda v, z_, p_: jpot.apply(
        v, z_, p_, jnp.zeros((12,), jnp.int32), num_mols=1)[0])(
        variables, jnp.asarray(z), jnp.asarray(pos)), np.float64).sum())
    got = tpot.apply(z, pos, num_mols=1)[0]
    f32 = create_model(dict(args, precision=32), device="cpu")
    f32.module.load_state_dict(tpot.module.state_dict())
    ref32 = f32.apply(z, pos, num_mols=1)[0]
    got, ref32 = (float(t.double().sum()) for t in (got, ref32))
    assert abs(got - want) <= 0.025 * abs(want), (got, want)
    assert abs(ref32 - want) > 0.05 * abs(want), (ref32, want)


@pytest.mark.parametrize("model_args", [SMALL_ARGS, TENSORNET_ARGS])
def test_precision_64_computes_in_float64(model_args):
    """``precision=64``: float64 weights and inputs (the kernels' float32
    branches give way to the plain chains); energies and forces equal the
    float32 model's with the same weights to 1e-5 relative."""
    z, pos, _ = open_molecule(12, seed=5)
    q = torch.ones(1)
    p64 = create_model(dict(model_args, precision=64), device="cpu", seed=3)
    p32 = create_model(dict(model_args, precision=32), device="cpu", seed=3)
    assert p64.dtype == torch.float64
    assert all(p.dtype == torch.float64 for p in p64.module.parameters())
    y64, f64 = p64.apply(z, pos, num_mols=1, q=q.double())
    y32, f32 = p32.apply(z, pos, num_mols=1, q=q)
    assert y64.dtype == f64.dtype == torch.float64
    np.testing.assert_allclose(y64.numpy(), y32.double().numpy(), rtol=1e-5)
    scale = float(f64.abs().max())
    assert float((f64 - f32.double()).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("rbf_type,names", [("expnorm", ("means", "betas")),
                                            ("gauss", ("offset", "coeff"))])
def test_trainable_rbf_round_trips(tmp_path, rbf_type, names):
    """``trainable_rbf``: the smearing's tensors are parameters under
    upstream's names, a checkpoint keeps them (moved away from their
    defaults here), and ``load_model`` reads them back to the same
    energies and forces."""
    from torchmdnet_tpu_torch.utils.checkpoint import save_checkpoint

    args = dict(SMALL_ARGS, trainable_rbf=True, rbf_type=rbf_type)
    pot = create_model(args, device="cpu", seed=4)
    sd = pot.module.state_dict()
    keys = [f"representation_model.distance_expansion.{n}" for n in names]
    assert all(k in sd for k in keys)
    with torch.no_grad():
        for k in keys:
            sd[k].mul_(1.05)
    pot.module.load_state_dict(sd)
    path = save_checkpoint(tmp_path / "rbf.ckpt", pot)
    back = load_model(path, device="cpu")
    z, pos, _ = open_molecule(12, seed=5)
    q = torch.ones(1)
    for a, b in zip(pot.apply(z, pos, num_mols=1, q=q),
                    back.apply(z, pos, num_mols=1, q=q)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for k in keys:
        np.testing.assert_array_equal(back.module.state_dict()[k].numpy(),
                                      sd[k].numpy())


@pytest.mark.parametrize("args", [ET_ARGS, T_ARGS, GN_ARGS],
                         ids=["et", "t", "gn"])
def test_attention_models_have_no_blocked_tier(args):
    """ET, T and GN take the ``blocked`` keyword ``TorchMDNet`` passes and
    refuse it when true (none has a cell-blocked tier)."""
    z, pos, batch, m = attn_system()
    pot = create_model(args, device="cpu")
    with pytest.raises(ValueError, match="no blocked tier"):
        pot.apply(z, pos, batch, num_mols=m, blocked=True)


def test_et_precision_16_matches_jax_bfloat16():
    """The Equivariant Transformer's ``precision=16`` against JAX's
    bfloat16 forward, on its features: the energy is a sum that cancels,
    and JAX's own bfloat16 energies are 1-16% from its float32 ones here,
    so the energy cannot tell one bfloat16 rounding from another.
    The features ``x`` of the port's bfloat16 layers are within 0.25% of
    JAX's on average (a bfloat16 ulp is 0.39%), the float32 model's with
    the same weights at least twice as far; ``vec`` likewise, within
    0.6%."""
    from torch_parity import attn_jax, attn_port

    z, pos, batch, m = system = attn_system()
    args = dict(ET_ARGS, precision=16, derivative=False)
    flat, _, _ = attn_jax(args, system)
    tree = {}
    for name, value in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(value)
    from torchmdnet_tpu.models.model import create_model as jax_create_model

    rep = jax_create_model(args).module.representation_model
    want = jax.jit(lambda p: rep.apply(
        {"params": p}, jnp.asarray(z), jnp.asarray(pos), jnp.asarray(batch),
        atom_mask=jnp.asarray(batch < m)))(tree["representation_model"])
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    errs = {}
    for precision in (16, 32):
        pot, _, _ = attn_port(dict(args, precision=precision), flat, system)
        got = pot.module.representation_model(
            torch.from_numpy(z).long(), torch.from_numpy(pos),
            torch.from_numpy(batch).long(),
            atom_mask=torch.from_numpy(batch < m))
        if precision == 16:
            assert got[0].dtype == torch.bfloat16
        errs[precision] = [float(np.abs(g.float().numpy() - w).mean()
                                 / np.abs(w).mean())
                           for g, w in zip(got, want)]
    assert errs[16][0] <= 0.0025 and errs[16][1] <= 0.006, errs
    assert errs[32][0] >= 2 * errs[16][0], errs
    assert errs[32][1] >= 1.2 * errs[16][1], errs
