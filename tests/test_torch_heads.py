"""The port's output heads against the JAX package's on the CPU, each head
alone with the same weights and random ``(x, v, z, pos, batch)``, ghost
atoms included: every head of ``OUTPUT_MODULES`` (the ``Equivariant*``
ones as modules: no ported representation produces ``v``), both
reductions, the all-to-all Coulomb head with its forces, the gated
equivariant block, ``segment_mean``'s count+1 quirk and the general
``coulomb_cutoff_energy`` with its VJP.  Flax modules only: no JAX model
is compiled."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import RTOL, flatten_params, lattice_system, one_torch_thread
from torchmdnet_tpu.models import output_modules as jheads
from torchmdnet_tpu.models.common import GatedEquivariantBlock as JaxGated
from torchmdnet_tpu.ops.coulomb import coulomb_cutoff_energy as jax_cce
from torchmdnet_tpu.ops.segment import segment_mean as jax_segment_mean
from torchmdnet_tpu_torch.models import output_modules as theads
from torchmdnet_tpu_torch.models.common import GatedEquivariantBlock
from torchmdnet_tpu_torch.ops.coulomb import coulomb_cutoff_energy
from torchmdnet_tpu_torch.ops.neighbors import build_neighbor_matrix
from torchmdnet_tpu_torch.ops.segment import segment_mean
from torchmdnet_tpu_torch.utils.checkpoint import rename_keys
from torchmdnet_tpu_torch.utils.jax_params import params_from_jax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H = 16  # hidden channels
NUM_MOLS = 2
Q_DIM, LAYERS = 4, 2  # the Coulomb head's charges: (LAYERS + 1) · Q_DIM


def _close(got, want, tol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _inputs(width=H, seed=0):
    """Two molecules (7 and 9 atoms, 6 Å apart) and 3 ghost rows in
    segment ``NUM_MOLS``; ``x [N, width]``, ``v [N, 3, H]``."""
    rng = np.random.RandomState(seed)
    n = 19
    batch = np.repeat([0, 1, 2], [7, 9, 3]).astype(np.int64)
    pos = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    pos[7:16] += 6.0
    pos[16:] += 40.0
    z = np.concatenate([rng.randint(1, 10, 16), np.zeros(3)]).astype(np.int64)
    x = rng.randn(n, width).astype(np.float32)
    v = rng.randn(n, 3, H).astype(np.float32)
    return x, v, z, pos, batch


def _port_head(cls, variables, **kw):
    """The port's head holding the flax head's weights (the JAX package's
    literal ``output_network_0`` names read as upstream's
    ``output_network.0``)."""
    head = cls(hidden_channels=H, **kw)
    sd = params_from_jax(flatten_params(variables["params"]))
    sd = rename_keys({"output_model." + k: t for k, t in sd.items()})
    head.load_state_dict({k[len("output_model."):]: t for k, t in sd.items()},
                         strict=True)
    return head


def _jax_total(head, variables, x, v, z, pos, batch):
    """Σ post_reduce(reduce(pre_reduce)) and the per-molecule output."""
    def total(x_, v_, pos_):
        pre = head.apply(variables, x_, v_, jnp.asarray(z, jnp.int32), pos_,
                         jnp.asarray(batch, jnp.int32), num_mols=NUM_MOLS,
                         method="pre_reduce")
        y = head.apply(variables, pre, jnp.asarray(batch, jnp.int32),
                       NUM_MOLS, method="reduce")
        y = head.apply(variables, y, method="post_reduce")
        return jnp.sum(y), (pre, y)
    (_, (pre, y)), grads = jax.value_and_grad(
        total, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(pos))
    return pre, y, grads


def _port_total(head, x, v, z, pos, batch):
    xt, vt, pt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, v, pos))
    zt, bt = torch.from_numpy(z), torch.from_numpy(batch)
    pre = head.pre_reduce(xt, vt, zt, pt, bt, num_mols=NUM_MOLS)
    y = head.post_reduce(head.reduce(pre, bt, NUM_MOLS))
    grads = torch.autograd.grad(y.sum(), (xt, vt, pt), allow_unused=True)
    return pre, y, grads


HEADS = [name for name in jheads.OUTPUT_MODULES
         if name != "ScalarPlusWeightedCoulomb"]


@pytest.mark.parametrize("reduce_op", ["sum", "mean"])
@pytest.mark.parametrize("name", HEADS)
def test_head_matches_jax(name, reduce_op):
    """Per-atom output, per-molecule output (after ``post_reduce``) and
    the gradients in x, v and pos of their sum."""
    x, v, z, pos, batch = _inputs(seed=len(name))
    jhead = jheads.OUTPUT_MODULES[name](hidden_channels=H,
                                        reduce_op=reduce_op)
    variables = jhead.init(jax.random.PRNGKey(1), jnp.asarray(x),
                           jnp.asarray(v), jnp.asarray(z, jnp.int32),
                           jnp.asarray(pos), jnp.asarray(batch, jnp.int32),
                           num_mols=NUM_MOLS, method="pre_reduce")
    thead = _port_head(theads.OUTPUT_MODULES[name], variables,
                       reduce_op=reduce_op)
    assert thead.allow_prior_model == jhead.allow_prior_model
    jpre, jy, jgrads = _jax_total(jhead, variables, x, v, z, pos, batch)
    tpre, ty, tgrads = _port_total(thead, x, v, z, pos, batch)
    _close(tpre, jpre)
    _close(ty, jy)
    assert ty.shape[0] == NUM_MOLS
    for got, want in zip(tgrads, jgrads):
        if got is None:  # the head does not read this input
            assert not np.asarray(want).any()
        else:
            _close(got, want)


def test_reduce_mean_keeps_the_count_plus_one_quirk():
    """``reduce_op="mean"`` divides by the atom count + 1, as upstream's
    ``scatter(reduce='mean')`` does (``include_self=True`` over zeros),
    and as JAX keeps on purpose: ``segment_mean`` of 2 and 4 is 2."""
    x = torch.tensor([[2.0], [4.0], [9.0]])
    seg = torch.tensor([0, 0, 1])
    assert segment_mean(x, seg, 3).flatten().tolist() == [2.0, 4.5, 0.0]
    assert segment_mean(x, seg, 3, include_zero=False).flatten().tolist() \
        == [3.0, 9.0, 0.0]
    rng = np.random.RandomState(3)
    xs = rng.randn(20, 4).astype(np.float32)
    ids = rng.randint(0, 6, 20)
    for include_zero in (True, False):
        _close(segment_mean(torch.from_numpy(xs), torch.from_numpy(ids), 7,
                            include_zero),
               jax_segment_mean(jnp.asarray(xs), jnp.asarray(ids), 7,
                                include_zero))
    x, v, z, pos, batch = _inputs()
    y = theads.reduce_atoms(torch.from_numpy(x), torch.from_numpy(batch),
                            NUM_MOLS, "mean")
    want = np.stack([x[batch == m].sum(0) / ((batch == m).sum() + 1)
                     for m in range(NUM_MOLS)])
    _close(y, want)


@pytest.mark.parametrize("scalar_activation", [False, True])
def test_gated_equivariant_block_matches_jax(scalar_activation):
    """The block alone, one atom's vector features all zero (the norm's
    zero-safe gradient), with upstream's key names."""
    x, v, *_ = _inputs()
    v[3] = 0.0
    jblock = JaxGated(H, 8, activation="silu",
                      scalar_activation=scalar_activation)
    variables = jblock.init(jax.random.PRNGKey(2), jnp.asarray(x),
                            jnp.asarray(v))
    sd = params_from_jax(flatten_params(variables["params"]))
    assert sorted(sd) == ["update_net.layers.0.bias",
                          "update_net.layers.0.weight",
                          "update_net.layers.2.bias",
                          "update_net.layers.2.weight",
                          "vec1_proj.weight", "vec2_proj.weight"]
    block = GatedEquivariantBlock(H, 8, activation="silu",
                                  scalar_activation=scalar_activation)
    block.load_state_dict(sd, strict=True)

    def jtotal(x_, v_):
        xo, vo = jblock.apply(variables, x_, v_)
        return jnp.sum(xo * xo) + jnp.sum(vo), (xo, vo)
    (_, (jx, jv)), (jdx, jdv) = jax.value_and_grad(
        jtotal, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(v))
    xt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (x, v))
    tx, tv = block(xt, vt)
    tdx, tdv = torch.autograd.grad((tx * tx).sum() + tv.sum(), (xt, vt))
    for got, want in ((tx, jx), (tv, jv), (tdx, jdx), (tdv, jdv)):
        _close(got, want)
    assert torch.isfinite(tdv).all()


def _coulomb_heads(seed=0):
    q_weights = tuple(tuple(float(w) for w in np.random.RandomState(
        seed + i).uniform(0.5, 1.5, Q_DIM)) for i in range(LAYERS + 1))
    kw = dict(hidden_channels=H, q_dim=Q_DIM, num_interaction_layers=LAYERS,
              q_weights=q_weights, coulomb_cutoff=None)
    return jheads.ScalarPlusWeightedCoulomb(**kw), kw


@pytest.mark.parametrize("coincident", [False, True])
def test_all_to_all_coulomb_head_matches_jax(coincident):
    """``coulomb_cutoff=None``: per-atom energies and their gradients in
    x (the charges too) and pos, against JAX, ghosts included; with
    ``coincident`` an atom of molecule 1 sits on one of molecule 0 (a zero
    distance off the diagonal, outside the mask): forces stay finite."""
    x, v, z, pos, batch = _inputs(width=H + (LAYERS + 1) * Q_DIM, seed=11)
    if coincident:
        pos[9] = pos[2]
    jhead, kw = _coulomb_heads()
    variables = jhead.init(jax.random.PRNGKey(4), jnp.asarray(x), None,
                           jnp.asarray(z, jnp.int32), jnp.asarray(pos),
                           jnp.asarray(batch, jnp.int32), num_mols=NUM_MOLS)
    thead = _port_head(theads.ScalarPlusWeightedCoulomb, variables,
                       **{k: w for k, w in kw.items()
                          if k != "hidden_channels"})
    jpre, jy, jgrads = _jax_total(jhead, variables, x, v, z, pos, batch)
    tpre, ty, tgrads = _port_total(thead, x, v, z, pos, batch)
    _close(tpre, jpre)
    _close(ty, jy)
    _close(tgrads[0], jgrads[0])
    _close(tgrads[2], jgrads[2])
    assert torch.isfinite(tgrads[2]).all()
    assert not tgrads[2][16:].any()  # ghosts feel nothing
    # the Coulomb term itself is there: the head differs from its MLP
    mlp = thead.output_network(torch.from_numpy(x[:, :H]))
    assert (tpre - mlp).abs().max() > 1e-3
    with pytest.raises(ValueError, match="PBC"):
        thead.pre_reduce(torch.from_numpy(x), None, torch.from_numpy(z),
                         torch.from_numpy(pos), torch.from_numpy(batch),
                         box=torch.eye(3) * 50.0, num_mols=NUM_MOLS)


@pytest.mark.parametrize("periodic", [False, True])
def test_coulomb_cutoff_energy_and_vjp_match_jax(periodic):
    """The general two-operand op (``Σ_c a_ic b_jc``, no weight vector) on
    a symmetric cutoff list and its VJP (∂pos, ∂a, ∂b) against JAX's
    ``coulomb_cutoff_energy``."""
    z, pos, box = lattice_system(n_side=3, spacing=2.2, seed=5)
    n, c, rc = len(z), 5, 3.5
    rng = np.random.RandomState(6)
    a = rng.randn(n, c).astype(np.float32)
    b = rng.randn(n, c).astype(np.float32)
    ct = rng.randn(n).astype(np.float32)
    boxt = torch.from_numpy(box) if periodic else None
    if not periodic:
        pos = pos * 1.4  # fewer pairs inside rc, no image to wrap
    nbr = build_neighbor_matrix(torch.from_numpy(pos), torch.zeros(n).long(),
                                strategy="brute", k_max=n, cutoff_upper=rc,
                                loop=False, box=boxt)
    assert not bool(nbr.overflow) and int(nbr.num_neighbors.max()) > 2
    args = (rc, 78.3, 7.0)
    jbox = jnp.asarray(box) if periodic else None
    e, vjp = jax.vjp(lambda p_, a_, b_: jax_cce(
        p_, a_, b_, jnp.asarray(nbr.idx.numpy()), jnp.asarray(nbr.mask.numpy()),
        *args, jbox, None), jnp.asarray(pos), jnp.asarray(a), jnp.asarray(b))
    want = vjp(jnp.asarray(ct))
    pt, at, bt = (torch.from_numpy(t).requires_grad_(True) for t in (pos, a, b))
    got_e = coulomb_cutoff_energy(pt, at, bt, nbr.idx, nbr.mask, *args, boxt)
    got = torch.autograd.grad(got_e, (pt, at, bt), torch.from_numpy(ct))
    _close(got_e, e)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("rbf_type", ["gauss", "expnorm"])
def test_smearing_matches_jax(rbf_type):
    """Both radial bases, from their defaults and from a checkpoint's
    frozen values (``initial_values``, JAX's ``rbf_initial``)."""
    from torchmdnet_tpu.models.common import make_rbf as jax_make_rbf
    from torchmdnet_tpu_torch.models.common import make_rbf

    d = np.random.RandomState(8).uniform(0.0, 5.5, (30,)).astype(np.float32)
    for initial in (None, "refit"):
        port = make_rbf(rbf_type, 0.5, 5.0, 12, False)
        values = None
        if initial:
            values = tuple(t.numpy() * 1.1 for t in port.values())
            port = make_rbf(rbf_type, 0.5, 5.0, 12, False, values)
        jrbf = jax_make_rbf(rbf_type, 0.5, 5.0, 12, False, "rbf",
                            initial_values=None if values is None else tuple(
                                tuple(np.ravel(v).tolist()) for v in values))
        want = jrbf.apply({}, jnp.asarray(d))
        _close(port(torch.from_numpy(d)), want)
