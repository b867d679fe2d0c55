"""Shared helpers of the ``test_torch_*`` files: small TensorNet2 + Coulomb
and TensorNet systems, built by the JAX package and carried into the
PyTorch port with the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.models.model import create_model as jax_create_model
from torchmdnet_tpu_torch.models.model import create_model as port_create_model
from torchmdnet_tpu_torch.utils.jax_params import params_from_jax

RTOL = ATOL = 1e-4  # the upstream parity bar (f32, TF32 off)


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module's small CPU ops, so that they
    leave the cores to the suite's other workers; the count is restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SMALL_ARGS = dict(
    model="tensornet2", embedding_dimension=32, num_layers=2, num_rbf=16,
    rbf_type="expnorm", trainable_rbf=False, activation="silu",
    cutoff_lower=0.0, cutoff_upper=4.5, max_z=128, max_num_neighbors=48,
    derivative=True, prior_model=None, reduce_op="sum", precision=32,
    equivariance_invariance_group="O(3)", atom_filter=-1, remat=False,
    pallas_embedding=True, pallas_edge_mlp=True, q_dim=4,
    output_model="ScalarPlusWeightedCoulomb", q_weights=[[1.0] * 4] * 3,
    coulomb_cutoff=5.0)

# TensorNet (the dhfr path of ``bench.py::main``) at a small width; the
# variants switch ``tabulated_edge_mlp``, ``pallas_edge_mlp`` and
# ``pallas_embedding`` on top of it
TENSORNET_ARGS = dict(
    model="tensornet", embedding_dimension=32, num_layers=2, num_rbf=16,
    rbf_type="expnorm", trainable_rbf=False, activation="silu",
    cutoff_lower=0.0, cutoff_upper=4.5, max_z=128, max_num_neighbors=32,
    derivative=True, prior_model=None, output_model="Scalar",
    reduce_op="sum", precision=32, equivariance_invariance_group="O(3)",
    atom_filter=-1, remat=False)


# the priors' arguments in the parity tests (``test_torch_priors.py``,
# ``test_torch_prior_args.py``): energies in eV, atom types 1-4 as H/C/N/O
EV = 1.602176634e-19  # J: energies in eV
ELEMENTS = (0, 1, 6, 7, 8)  # atom type → atomic number; type 0 is a ghost
UNITS = dict(distance_scale=1e-10, energy_scale=EV)
PRIOR_ARGS = {
    "Atomref": dict(max_z=5, initial_atomref=np.array(
        [0.0, -13.6, -1029.8, -1484.7, -2041.3], np.float32)),
    "LearnableAtomref": dict(max_z=5),
    "ZBL": dict(cutoff_distance=4.0, max_num_neighbors=16,
                atomic_number=ELEMENTS, **UNITS),
    "Coulomb": dict(lower_switch_distance=0.1, upper_switch_distance=0.4,
                    max_num_neighbors=16, **UNITS),
    "D2": dict(cutoff_distance=10.0, max_num_neighbors=16,
               atomic_number=ELEMENTS, **UNITS),
}


def lattice_system(n_side=4, spacing=2.6, seed=0):
    """``n_side³`` atoms on a jittered cubic lattice in a periodic box
    (mixed H/C/N/O), as numpy arrays: ``(z, pos, box)``."""
    rng = np.random.RandomState(seed)
    g = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3) + 0.5
    L = n_side * spacing
    pos = (g * spacing + rng.uniform(-0.4, 0.4, g.shape)).astype(np.float32)
    z = rng.choice([1, 1, 6, 7, 8], len(pos)).astype(np.int32)
    box = np.diag([L, L, L]).astype(np.float32)
    return z, pos, box


def open_molecule(n_atoms=20, seed=0):
    """A small open (non-periodic) cluster of mixed H/C/N/O atoms at
    molecular spacing, as numpy arrays: ``(z, pos, None)``."""
    rng = np.random.RandomState(seed)
    pos = np.zeros((n_atoms, 3))
    for i in range(1, n_atoms):  # each atom 1.0-1.6 Å from an earlier one
        while True:
            v = rng.randn(3)
            p = pos[rng.randint(i)] + v / np.linalg.norm(v) * rng.uniform(1.0, 1.6)
            if np.min(np.linalg.norm(pos[:i] - p, axis=1)) > 0.9:
                break
        pos[i] = p
    z = rng.choice([1, 1, 6, 7, 8], n_atoms).astype(np.int32)
    return z, pos.astype(np.float32), None


def flatten_params(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(flatten_params(value, name))
        else:
            out[name] = np.asarray(value)
    return out


def jax_and_port(args, z, pos, box, seed=0):
    """The JAX potential with its variables and the port's potential
    (on the CPU) holding the same weights."""
    jpot = jax_create_model(args)
    init = jax.jit(lambda key, z_, p_, b_: jpot.init(
        key, z_, p_, jnp.zeros((z_.shape[0],), jnp.int32), num_mols=1,
        box=b_))
    variables = init(jax.random.PRNGKey(seed), jnp.asarray(z),
                     jnp.asarray(pos), _maybe(box))
    flat = flatten_params(variables["params"])
    tpot = port_create_model(args, device="cpu")
    tpot.module.load_state_dict(params_from_jax(flat), strict=True)
    return jpot, variables, tpot, flat


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_apply(jpot, variables, z, pos, box):
    """Jitted ``(energy, forces)`` of the JAX potential, as numpy arrays."""
    fn = jax.jit(lambda v, z_, p_, b_: jpot.apply(
        v, z_, p_, jnp.zeros((z_.shape[0],), jnp.int32), num_mols=1, box=b_))
    y, f = fn(variables, jnp.asarray(z), jnp.asarray(pos), _maybe(box))
    return np.asarray(y), np.asarray(f)


def _maybe(box):
    return None if box is None else jnp.asarray(box)


# ---- TensorNet on the gather path, four variants: variant → (args, the
# port op it must run through: module, attribute); the lattice and the open
# molecule (``test_torch_tensornet.py``, ``_tensornet_tabulated.py``)
TN_VARIANTS = {
    "plain": ({}, None),
    "pallas_edge_mlp": (dict(pallas_edge_mlp=True),
                        ("edge_mlp", "edge_mlp_ref")),
    "tabulated": (dict(tabulated_edge_mlp=128), ("cheb_filter", "filter_fwd")),
    "pallas_embedding": (dict(pallas_embedding=True),
                         ("radial_embedding", "radial_embedding_ref")),
}
TN_ROWS = 64  # the lattice's atoms; the open molecule is padded to them
TN_OPEN_BOX = 100.0


def tn_setup():
    """The JAX weights, and both systems as the JAX reference sees them:
    the open molecule padded with ghost rows (segment 1) to the lattice's
    rows, in a box so large that no periodic image comes within the
    cutoff, so that one compiled JAX function per variant serves both."""
    z, pos, box = lattice_system()
    zo, po, _ = open_molecule()
    n_open = len(zo)
    zp = np.concatenate([zo, np.ones(TN_ROWS - n_open, np.int32)])
    ghost = 50.0 + np.random.RandomState(9).uniform(
        0, 30, (TN_ROWS - n_open, 3))
    pp = np.concatenate([po, ghost]).astype(np.float32)
    segp = (np.arange(TN_ROWS) >= n_open).astype(np.int32)
    systems = {
        "lattice": ((z, pos, np.zeros(TN_ROWS, np.int32), box), (z, pos, box)),
        "open": ((zp, pp, segp, np.eye(3, dtype=np.float32) * TN_OPEN_BOX),
                 (zo, po, None)),
    }
    jpot = jax_create_model(TENSORNET_ARGS)
    variables = jax.jit(lambda key, z_, p_, s_, b_: jpot.init(
        key, z_, p_, s_, num_mols=1, box=b_))(
        jax.random.PRNGKey(0), *map(jnp.asarray, systems["lattice"][0]))
    return variables, flatten_params(variables["params"]), systems, {}


def _tn_jax_reference(setup, variant, system):
    variables, _, systems, fns = setup
    if variant not in fns:
        jpot = jax_create_model(dict(TENSORNET_ARGS, **TN_VARIANTS[variant][0]))
        fns[variant] = jax.jit(lambda v, z_, p_, s_, b_: jpot.apply(
            v, z_, p_, s_, num_mols=1, box=b_))
    y, f = fns[variant](variables, *map(jnp.asarray, systems[system][0]))
    return np.asarray(y), np.asarray(f)


def tn_check_against_jax(setup, variant, system, monkeypatch):
    """The port's TensorNet energy and forces against JAX's at rtol = atol
    = 1e-4 on ``system``, through the op of the variant; the JAX ghost
    rows feel no force."""
    import importlib

    _, flat, systems, _ = setup
    extra, spy = TN_VARIANTS[variant]
    calls = []
    if spy is not None:  # the variant goes through its op
        mod = importlib.import_module(f"torchmdnet_tpu_torch.ops.{spy[0]}")
        fn = getattr(mod, spy[1])
        monkeypatch.setattr(mod, spy[1], lambda *a: calls.append(1) or fn(*a))
    y_j, f_j = _tn_jax_reference(setup, variant, system)
    z, pos, box = systems[system][1]
    pot = port_create_model(dict(TENSORNET_ARGS, **extra), device="cpu")
    pot.module.load_state_dict(params_from_jax(flat), strict=True)
    y_t, f_t = pot.apply(z, pos, None, num_mols=1, box=box)
    assert y_t.shape == (1, 1) and f_t.shape == pos.shape
    assert bool(calls) == (spy is not None)
    np.testing.assert_allclose(to_np(y_t), y_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_np(f_t), f_j[:len(z)], rtol=RTOL,
                               atol=ATOL)
    assert not f_j[len(z):].any()  # the JAX ghost rows feel no force


# ---- TensorNet's blocked message passing (rows 8-11): one small system
# with the JAX blocked tests' geometry (200 atoms at 0.08 Å⁻³, a 3.2 Å
# cutoff, 8-row blocks); the list at 3.2 + 0.5 Å, so that fm = (d < 3.2)
# drops some valid slots
BMP_N, BMP_CUTOFF, BMP_RC, BMP_F, BMP_T, BMP_K = 200, 3.2, 3.7, 8, 24, 40
# the JAX specs' TPU run length: it sets only JAX's window plan, not the
# sort; 64-row runs leave fewer window copies for interpret mode to
# unroll, which halves the JAX compile time of these tests
JAX_RLH = 64
BLOCKED_QUANTITIES = ("row8", "row9", "row10", "row11", "sym_dfeats",
                      "sym_dattr", "cheb_dfeats", "cheb_dd")


def blocked_system(n=BMP_N, seed=3):
    """``(pos, box_diag)``: ``n`` atoms uniform at 0.08 Å⁻³ in a cube."""
    rng = np.random.RandomState(seed)
    L = (n / 0.08) ** (1.0 / 3.0)
    return (rng.uniform(0, L, (n, 3)).astype(np.float32),
            np.array([L, L, L], np.float32))


def grouped_list_kwargs(spec, bd, cutoff, n):
    """The grouped tier's list options (JAX ``integrators.py:264-281``)."""
    nz = max(int(bd[2] // cutoff), 3)
    occ = n / (spec.nx * spec.ny * nz)
    return dict(strategy="cell", k_max=sum(spec.col_slots),
                cells_per_dim=(spec.nx, spec.ny, nz),
                cell_capacity=int(np.ceil(occ * 2.5)) + 8,
                column_partition=spec.col_slots)


def blocked_mp_case(layout):
    """Rows 8-11 and both differentiable wrappers of the port (plain
    versions) and of the JAX package (precise spec, interpret mode) on the
    same inputs over the sorted list of :func:`blocked_system`,
    ``layout`` "ungrouped" (brute, K=40) or "grouped" (the tuned
    column-partitioned list).  Returns ``(want, got, mask)``: numpy arrays
    keyed by :data:`BLOCKED_QUANTITIES` and ``"cheb_dcoeffs"``."""
    from torchmdnet_tpu.ops import cell_blocks as jcb
    from torchmdnet_tpu.ops.neighbors import build_neighbor_matrix
    from torchmdnet_tpu.ops.pallas_blocked_mp import (
        blocked_neighbor_sum_sym, blocked_neighbor_sum_sym_cheb)
    from torchmdnet_tpu_torch.ops import blocked_mp as bm
    from torchmdnet_tpu_torch.ops.cheb import cheb_deriv_coeffs

    pos, bd = blocked_system()
    n, hi = BMP_N, BMP_CUTOFF
    spec = jcb.tune_cell_block_spec(jnp.asarray(pos), jnp.asarray(bd), BMP_RC,
                                    cap=8, rlh=JAX_RLH, precise=True,
                                    column_slots=layout == "grouped")
    blocks = jcb.plan_cell_blocks(jnp.asarray(pos), jnp.asarray(bd), spec)
    am = np.asarray(blocks.mask_rows)
    pos_s = np.where(am[:, None], pos[np.minimum(np.asarray(blocks.perm),
                                                 n - 1)], 0.0)
    pos_s = jnp.asarray(pos_s.astype(np.float32))
    kw = (grouped_list_kwargs(spec, bd, BMP_RC, n) if layout == "grouped"
          else dict(strategy="brute", k_max=BMP_K))
    nbr = build_neighbor_matrix(
        pos_s, jnp.asarray((~am).astype(np.int32)), cutoff_upper=BMP_RC,
        loop=True, box=jnp.diag(jnp.asarray(bd)), atom_mask=jnp.asarray(am),
        **kw)
    assert not bool(nbr.overflow)
    rel, eov = jcb.edge_rel(blocks, nbr.idx, nbr.mask, pos_s, jnp.asarray(bd))
    assert not bool(eov)
    idx, mask = np.array(nbr.idx), np.array(nbr.mask)
    delta = np.asarray(pos_s)[:, None, :] - np.asarray(pos_s)[idx]
    delta -= bd * np.round(delta / bd)
    d = np.where(mask, np.sqrt((delta ** 2).sum(-1)), 0.0).astype(np.float32)
    fm = ((d < hi) & mask).astype(np.float32)
    assert 0 < (mask & (fm == 0)).sum() and fm.sum() > 5 * n
    rng = np.random.RandomState(7)
    n_pad, k = idx.shape
    f = BMP_F
    x = dict(attr=rng.randn(n_pad, k, 3 * f) * mask[..., None],
             feats=rng.randn(n_pad, 9 * f),
             g=rng.randn(n_pad, 9 * f) * 0.1,
             # a decaying series, as the fit of a smooth filter is; with
             # O(1) outputs the precise tier's 2^-16 meets the 1e-4 bar
             coeffs=rng.randn(BMP_T, 3 * f) * 0.5 ** np.arange(BMP_T)[:, None])
    x = {key: v.astype(np.float32) for key, v in x.items()}

    def sym_all(a, feats, g):
        out, vjp = jax.vjp(lambda a_, f_: blocked_neighbor_sum_sym(
            a_, f_, rel, blocks.run_starts, spec, True), a, feats)
        return (out,) + vjp(g)

    def cheb_all(c, d_, feats, g):
        out, vjp = jax.vjp(lambda c_, d2, f_: blocked_neighbor_sum_sym_cheb(
            c_, d2, jnp.asarray(fm), f_, rel, blocks.run_starts, spec, 0.0,
            hi, True), c, d_, feats)
        return (out,) + vjp(g)

    j = {key: jnp.asarray(v) for key, v in x.items()}
    s_out, s_da, s_df = jax.jit(sym_all)(j["attr"], j["feats"], j["g"])
    c_out, c_dc, c_dd, c_df = jax.jit(cheb_all)(j["coeffs"], jnp.asarray(d),
                                                j["feats"], j["g"])
    want = dict(row8=s_out, row9=s_da, row10=c_out,
                row11=np.asarray(c_dd) * (hi / 2.0), sym_dfeats=s_df,
                sym_dattr=s_da, cheb_dfeats=c_df, cheb_dd=c_dd,
                cheb_dcoeffs=c_dc)

    t = {key: torch.from_numpy(v) for key, v in x.items()}
    ti, tm = torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(mask)
    td, tf = torch.from_numpy(d), torch.from_numpy(fm)
    got = dict(
        row8=bm.neighbor_sum(t["attr"], t["feats"], ti, tm),
        row9=bm.dattr(t["g"], t["feats"], ti, tm),
        row10=bm.neighbor_sum_cheb(t["coeffs"], td, tf, t["feats"], ti, 0.0,
                                   hi),
        row11=bm.dd_cheb(cheb_deriv_coeffs(t["coeffs"]), td, tf, t["g"],
                         t["feats"], ti, 0.0, hi))
    a = t["attr"].clone().requires_grad_(True)
    fe = t["feats"].clone().requires_grad_(True)
    got["sym_dattr"], got["sym_dfeats"] = torch.autograd.grad(
        bm.blocked_neighbor_sum_sym(a, fe, ti, tm), [a, fe], t["g"])
    c = t["coeffs"].clone().requires_grad_(True)
    dd = td.clone().requires_grad_(True)
    got["cheb_dcoeffs"], got["cheb_dd"], got["cheb_dfeats"] = \
        torch.autograd.grad(bm.blocked_neighbor_sum_sym_cheb(
            c, dd, tf, fe, ti, 0.0, hi), [c, dd, fe], t["g"])
    return ({key: np.asarray(v) for key, v in want.items()},
            {key: v.detach().numpy() for key, v in got.items()}, mask)


# ---- TensorNet2's fused q-tier (rows 12-13) in its four bodies: the
# ungrouped or grouped list of :func:`blocked_system` at BMP_RC, F=16,
# T=24 series terms or R=8 rbf channels
Q_F, Q_T, Q_R = 16, 24, 8


def q_names(exact):
    """The differentiable inputs and the weights of a q op, by the op's
    argument names: ``(diff, weights)``."""
    base, w1 = ("edge_attr", "w1a") if exact else ("d", "coeffs")
    return ((base, "cwfm", "u_i", "u_j", "feats9"),
            (w1, "w2", "b2", "w3", "b3"))


def q_op_case(layout, exact):
    """The port's ``blocked_neighbor_sum_asym_q_tab`` (``exact`` False) or
    ``blocked_neighbor_sum_asym_q`` (plain versions) against the JAX
    package's with a precise spec (Pallas kernels in interpret mode), on
    the sorted list of :func:`blocked_system` (``layout`` "ungrouped":
    brute K=40; "grouped": the tuned column-partitioned K′ list):
    ``(want, got, mask)``, numpy arrays keyed by ``"out"`` and the input
    names of :func:`q_names` (their cotangents)."""
    from torchmdnet_tpu.ops import cell_blocks as jcb
    from torchmdnet_tpu.ops.neighbors import build_neighbor_matrix
    from torchmdnet_tpu.ops.pallas_blocked_mp import (
        blocked_neighbor_sum_asym_q, blocked_neighbor_sum_asym_q_tab)
    from torchmdnet_tpu_torch.ops import blocked_q

    pos, bd = blocked_system()
    n, hi = BMP_N, BMP_CUTOFF
    spec = jcb.tune_cell_block_spec(jnp.asarray(pos), jnp.asarray(bd), BMP_RC,
                                    cap=8, rlh=JAX_RLH, precise=True,
                                    column_slots=layout == "grouped")
    blocks = jcb.plan_cell_blocks(jnp.asarray(pos), jnp.asarray(bd), spec)
    am = np.asarray(blocks.mask_rows)
    pos_s = np.where(am[:, None], pos[np.minimum(np.asarray(blocks.perm),
                                                 n - 1)], 0.0)
    pos_s = jnp.asarray(pos_s.astype(np.float32))
    kw = (grouped_list_kwargs(spec, bd, BMP_RC, n) if layout == "grouped"
          else dict(strategy="brute", k_max=BMP_K))
    nbr = build_neighbor_matrix(
        pos_s, jnp.asarray((~am).astype(np.int32)), cutoff_upper=BMP_RC,
        loop=True, box=jnp.diag(jnp.asarray(bd)), atom_mask=jnp.asarray(am),
        **kw)
    assert not bool(nbr.overflow)
    rel, eov = jcb.edge_rel(blocks, nbr.idx, nbr.mask, pos_s, jnp.asarray(bd))
    assert not bool(eov)
    idx, mask = np.array(nbr.idx), np.array(nbr.mask)
    delta = np.asarray(pos_s)[:, None, :] - np.asarray(pos_s)[idx]
    delta -= bd * np.round(delta / bd)
    d = np.where(mask, np.sqrt((delta ** 2).sum(-1)), 0.0).astype(np.float32)
    cw = np.where(d < hi, 0.5 * (np.cos(d * np.pi / hi) + 1.0), 0.0) * mask
    assert 0 < (mask & (cw == 0)).sum() and (cw > 0).sum() > 5 * n
    rng = np.random.RandomState(11)
    n_pad, f = idx.shape[0], Q_F
    if exact:
        # a smooth function of d, so equal on both slots of a pair
        freq = rng.uniform(0.3, 1.5, Q_R)
        base = np.cos(d[..., None] * freq + rng.uniform(0, 3, Q_R)) * mask[
            ..., None]
        w1 = rng.randn(Q_R, f) / np.sqrt(Q_R)
    else:
        base = d
        # a decaying series, as the fit of a smooth base(d) is
        w1 = rng.randn(Q_T, f) * 0.7 ** np.arange(Q_T)[:, None]
    x = dict(base=base, cwfm=cw, u_i=rng.randn(n_pad, f) * 0.5,
             u_j=rng.randn(n_pad, f) * 0.5, feats9=rng.randn(n_pad, 9 * f),
             w1=w1, w2=rng.randn(f, 2 * f) / np.sqrt(f),
             b2=rng.randn(2 * f) * 0.1,
             w3=rng.randn(2 * f, 3 * f) / np.sqrt(2 * f),
             b3=rng.randn(3 * f) * 0.1)
    diff, weights = q_names(exact)
    x[diff[0]], x[weights[0]] = x.pop("base"), x.pop("w1")
    x = {key: v.astype(np.float32) for key, v in x.items()}
    g = rng.randn(n_pad, 9 * f).astype(np.float32)

    def f_jax(*args):
        if exact:
            return blocked_neighbor_sum_asym_q(
                *args[:5], nbr.mask, nbr.idx, nbr.rev_slot, rel,
                blocks.run_starts, *args[5:], spec, True)
        return blocked_neighbor_sum_asym_q_tab(
            *args[:5], nbr.mask, nbr.idx, nbr.rev_slot, rel,
            blocks.run_starts, *args[5:], spec, 0.0, hi, True)

    def all_jax(*args):
        out, vjp = jax.vjp(f_jax, *args[:-1])
        return (out,) + vjp(args[-1])

    keys = diff + weights
    res = jax.jit(all_jax)(*[jnp.asarray(x[k]) for k in keys],
                           jnp.asarray(g))
    want = {"out": np.asarray(res[0])}
    want.update({k: np.asarray(v) for k, v in zip(keys, res[1:])})

    t = {k: torch.tensor(v, requires_grad=True) for k, v in x.items()}
    ti, tm = torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(mask)
    rev = torch.from_numpy(np.array(nbr.rev_slot).astype(np.int64))
    args = [*(t[k] for k in diff), tm, ti, rev, *(t[k] for k in weights)]
    out_t = (blocked_q.blocked_neighbor_sum_asym_q(*args) if exact else
             blocked_q.blocked_neighbor_sum_asym_q_tab(*args, 0.0, hi))
    grads_t = torch.autograd.grad(out_t, [t[k] for k in keys],
                                  torch.from_numpy(g))
    got = {"out": out_t.detach().numpy()}
    got.update({k: v.numpy() for k, v in zip(keys, grads_t)})
    return want, got, mask


# ---- the blocked TensorNet model (bench.py::main with BENCH_BLOCKED=1) at
# the JAX blocked tests' geometry (tests/test_blocked_model.py): 260 atoms
# at 0.08 Å⁻³, a 3.2 Å cutoff, 8-row blocks, F=16, 8 rbf
BT_N, BT_CUTOFF, BT_SKIN, BT_K, BT_T = 260, 3.2, 0.5, 48, 32
BT_ARGS = dict(
    model="tensornet", embedding_dimension=16, num_layers=2, num_rbf=8,
    rbf_type="expnorm", trainable_rbf=False, activation="silu",
    cutoff_lower=0.0, cutoff_upper=BT_CUTOFF, max_z=100,
    max_num_neighbors=BT_K, derivative=True, prior_model=None,
    output_model="Scalar", reduce_op="sum", precision=32,
    equivariance_invariance_group="O(3)", atom_filter=-1, remat=False)
# variant → (extra args, grouped spec?)
BT_VARIANTS = {
    "tabulated_grouped": (dict(tabulated_edge_mlp=BT_T), True),
    "tabulated_ungrouped": (dict(tabulated_edge_mlp=BT_T), False),
    "exact_grouped": (dict(pallas_edge_mlp=True, pallas_embedding=True),
                      True),
    "exact_ungrouped": (dict(pallas_edge_mlp=True), False)}


def bt_system(n=BT_N, seed=0):
    """``(z, pos, box)``: ``n`` atoms uniform at 0.08 Å⁻³ in a cube."""
    rng = np.random.RandomState(seed)
    L = (n / 0.08) ** (1.0 / 3.0)
    pos = rng.uniform(0, L, (n, 3)).astype(np.float32)
    z = rng.choice([1, 6, 8], n).astype(np.int32)
    return z, pos, np.diag([L, L, L]).astype(np.float32)


def bt_list_kwargs(spec, bd, cutoff=BT_CUTOFF):
    """The sorted-space list of a spec: brute K=48, or the grouped one."""
    if spec.col_slots is None:
        return dict(strategy="brute", k_max=BT_K)
    return grouped_list_kwargs(spec, bd, cutoff, BT_N)


def bt_setup():
    """The system, the JAX weights and the JAX specs (precise, tuned at the
    model cutoff with 8-row blocks; ``specs[grouped]``)."""
    from torchmdnet_tpu.ops import cell_blocks as jcb

    z, pos, box = bt_system()
    bd = np.diag(box).copy()
    jpot = jax_create_model(BT_ARGS)
    variables = jax.jit(lambda key, z_, p_, b_: jpot.init(
        key, z_, p_, jnp.zeros((BT_N,), jnp.int32), num_mols=1, box=b_))(
        jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(pos),
        jnp.asarray(box))
    specs = {grouped: jcb.tune_cell_block_spec(
        jnp.asarray(pos), jnp.asarray(bd), BT_CUTOFF, cap=8, rlh=JAX_RLH,
        precise=True, column_slots=grouped) for grouped in (False, True)}
    return dict(z=z, pos=pos, box=box, bd=bd, variables=variables,
                flat=flatten_params(variables["params"]), specs=specs)


def bt_jax_blocked(setup, variant):
    """Jitted energy and forces (original order) of the JAX blocked model
    on the JAX sort and list."""
    from torchmdnet_tpu.ops import cell_blocks as jcb
    from torchmdnet_tpu.ops.neighbors import build_neighbor_matrix

    extra, grouped = BT_VARIANTS[variant]
    spec = setup["specs"][grouped]
    z, pos, box, bd = setup["z"], setup["pos"], setup["box"], setup["bd"]
    pj, bj = jnp.asarray(pos), jnp.asarray(box)
    jpot = jax_create_model(dict(BT_ARGS, cell_block_spec=spec, **extra))
    blocks = jcb.plan_cell_blocks(pj, jnp.asarray(bd), spec)
    perm_safe = jnp.minimum(blocks.perm, BT_N - 1)
    am = blocks.mask_rows
    pos_s = jnp.where(am[:, None], pj[perm_safe], 0.0)
    zs = jnp.where(am, jnp.asarray(z)[perm_safe], 0)
    batchs = jnp.where(am, 0, 1)
    nbr = build_neighbor_matrix(pos_s, batchs, cutoff_upper=BT_CUTOFF,
                                loop=True, box=bj, atom_mask=am,
                                **bt_list_kwargs(spec, bd))
    assert not bool(nbr.overflow)
    rel, eov = jcb.edge_rel(blocks, nbr.idx, nbr.mask, pos_s,
                            jnp.asarray(bd))
    assert not bool(eov)

    def energy(p):
        p_s = jcb.permute_rows(p, perm_safe, am, blocks.inv_perm)
        return jnp.sum(jpot.energy(
            setup["variables"], zs, p_s, batchs, num_mols=1, box=bj,
            nbr=nbr, blocked=jcb.BlockedMP(rel, blocks.run_starts)))

    e, g = jax.jit(jax.value_and_grad(energy))(pj)
    return float(e), -np.asarray(g)


def bt_port(setup, variant=None, spec=None):
    """The port's TensorNet on the CPU with the JAX weights; ``spec`` (a
    JAX or port spec) builds the blocked model."""
    from torchmdnet_tpu_torch.ops.cell_blocks import CellBlockSpec

    args = dict(BT_ARGS, **(BT_VARIANTS[variant][0] if variant else {}))
    if spec is not None:
        args["cell_block_spec"] = CellBlockSpec(**spec._asdict())
    pot = port_create_model(args, device="cpu")
    pot.module.load_state_dict(params_from_jax(setup["flat"]), strict=True)
    return pot


def bt_port_blocked(setup, variant, monkeypatch):
    """Energy and forces (original order) of the port's blocked model on
    its own sort and sorted-space list, and the set of blocked ops
    (``ops/blocked_mp.py`` dispatchers) it ran."""
    from torchmdnet_tpu_torch.ops import blocked_mp
    from torchmdnet_tpu_torch.ops import cell_blocks as tcb
    from torchmdnet_tpu_torch.ops.neighbors import build_neighbor_matrix

    spec = tcb.CellBlockSpec(
        **setup["specs"][BT_VARIANTS[variant][1]]._asdict())
    pot = bt_port(setup, variant, spec)
    calls = []
    for name in ("neighbor_sum", "neighbor_sum_cheb", "dattr", "dd_cheb"):
        fn = getattr(blocked_mp, name)
        monkeypatch.setattr(blocked_mp, name, lambda *a, _n=name, _f=fn:
                            calls.append(_n) or _f(*a))
    pt, box = torch.from_numpy(setup["pos"]), torch.from_numpy(setup["box"])
    blocks = tcb.plan_cell_blocks(pt, setup["bd"], spec)
    perm = torch.clamp(blocks.perm, max=BT_N - 1)
    am = blocks.mask_rows
    pos_s = torch.where(am[:, None], pt[perm], 0.0)
    zs = torch.where(am, torch.from_numpy(setup["z"]).long()[perm], 0)
    batchs = (~am).long()
    nbr = build_neighbor_matrix(pos_s, batchs, cutoff_upper=BT_CUTOFF,
                                loop=True, box=box, atom_mask=am,
                                **bt_list_kwargs(spec, setup["bd"]))
    assert not bool(nbr.overflow)
    p = pt.clone().requires_grad_(True)
    y = pot.module(zs, tcb.permute_rows(p, perm, am, blocks.inv_perm),
                   batchs, num_mols=1, box=box, nbr=nbr, blocked=True)
    (g,) = torch.autograd.grad(y.sum(), p)
    return float(y.detach()), -g.numpy(), set(calls)


def bt_check_against_jax(setup, variant, monkeypatch):
    """The port's blocked energy and forces against JAX's at rtol = atol =
    1e-4, through the blocked ops of the variant (rows 10 and 11 when
    tabulated, rows 8 and 9 otherwise)."""
    e_j, f_j = bt_jax_blocked(setup, variant)
    e_t, f_t, calls = bt_port_blocked(setup, variant, monkeypatch)
    assert calls == ({"neighbor_sum_cheb", "dd_cheb"}
                     if variant.startswith("tabulated")
                     else {"neighbor_sum", "dattr"})
    assert np.abs(f_j).max() > 1e-2  # non-vacuous
    np.testing.assert_allclose(e_t, e_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(f_t, f_j, rtol=RTOL, atol=ATOL)


# ---- TensorNet2 on the blocked q-tier (bench.py::bench_northstar's
# model, small): 216 atoms at 0.08 Å⁻³, a 3.0 Å cutoff, K=32, 8-row blocks,
# F=16, 8 rbf, q_dim 4, the Coulomb head at 4 Å on its own list; the grouped
# tier with the dual list (tabulated, T=24) and the exact q_tab=0 tier
Q2_N, Q2_CUTOFF, Q2_SKIN, Q2_K, Q2_T = 216, 3.0, 0.5, 32, 24
Q2_ARGS = dict(
    model="tensornet2", embedding_dimension=16, num_layers=2, num_rbf=8,
    rbf_type="expnorm", trainable_rbf=False, activation="silu",
    cutoff_lower=0.0, cutoff_upper=Q2_CUTOFF, max_z=100,
    max_num_neighbors=Q2_K, derivative=True, prior_model=None,
    reduce_op="sum", precision=32, equivariance_invariance_group="O(3)",
    atom_filter=-1, remat=False, pallas_embedding=True,
    pallas_edge_mlp=True, q_dim=4, q_tab=Q2_T,
    output_model="ScalarPlusWeightedCoulomb", q_weights=[[1.0] * 4] * 3,
    coulomb_cutoff=4.0)
# variant → (q_tab, grouped spec?, dual list?)
Q2_VARIANTS = {"grouped_dual": (Q2_T, True, True),
               "grouped": (Q2_T, True, False),
               "ungrouped": (Q2_T, False, False),
               "exact_ungrouped": (0, False, False),
               "exact_grouped": (0, True, False)}


def q2_setup(num_layers=2):
    """The system at ``Q2_ARGS`` with ``num_layers`` interaction layers
    (``args``), the weights (the port's, seeded, carried into a JAX
    params tree: the JAX init's shapes come from ``jax.eval_shape``, which
    compiles nothing; shared by every variant, as the q-tier and the spec
    change no parameter) and the JAX specs (precise, tuned at the model
    cutoff, ``specs[grouped]``)."""
    from torchmdnet_tpu.ops import cell_blocks as jcb
    from torchmdnet_tpu.utils.torch_ckpt import convert_state_dict

    args = dict(Q2_ARGS, num_layers=num_layers,
                q_weights=[[1.0] * 4] * (num_layers + 1))
    z, pos, box = bt_system(n=Q2_N, seed=4)
    bd = np.diag(box).copy()
    jpot = jax_create_model(args)
    shapes = jax.eval_shape(lambda: jpot.init(
        jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(pos),
        jnp.zeros((Q2_N,), jnp.int32), num_mols=1, box=jnp.asarray(box),
        q=jnp.zeros((1,), jnp.float32)))
    sd = port_create_model(args, device="cpu", seed=3).module.state_dict()
    params = convert_state_dict(
        {k: v.numpy() for k, v in sd.items()},
        jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes["params"]))
    params = jax.tree.map(jnp.asarray, params)
    specs = {grouped: jcb.tune_cell_block_spec(
        jnp.asarray(pos), jnp.asarray(bd), Q2_CUTOFF, cap=8, rlh=JAX_RLH,
        precise=True, column_slots=grouped) for grouped in (False, True)}
    return dict(args=args, z=z, pos=pos, box=box, bd=bd,
                variables={"params": params}, flat=flatten_params(params),
                specs=specs)


def q2_lists(build, spec, bd, box, pos_s, batchs, am):
    """``(nbr, nbr_emb)`` in sorted space with ``build`` (either package's
    ``build_neighbor_matrix``, ``box`` its array): brute K for an
    ungrouped spec; the grouped K′ list and, for the dual list, the
    compact brute K one."""
    common = dict(cutoff_upper=Q2_CUTOFF, loop=True, box=box, atom_mask=am)
    compact = build(pos_s, batchs, strategy="brute", k_max=Q2_K, **common)
    if spec.col_slots is None:
        return compact, None
    return build(pos_s, batchs, **common,
                 **grouped_list_kwargs(spec, bd, Q2_CUTOFF, Q2_N)), compact


def q2_jax(setup, variant):
    """Jitted energy and forces (original order) of the JAX blocked model
    on its sort and lists."""
    from torchmdnet_tpu.ops import cell_blocks as jcb
    from torchmdnet_tpu.ops.neighbors import build_neighbor_matrix

    q_tab, grouped, dual = Q2_VARIANTS[variant]
    spec = setup["specs"][grouped]
    pj, bj = jnp.asarray(setup["pos"]), jnp.asarray(setup["box"])
    jpot = jax_create_model(dict(setup["args"], cell_block_spec=spec,
                                 q_tab=q_tab))
    blocks = jcb.plan_cell_blocks(pj, jnp.asarray(setup["bd"]), spec)
    perm = jnp.minimum(blocks.perm, Q2_N - 1)
    am = blocks.mask_rows
    pos_s = jnp.where(am[:, None], pj[perm], 0.0)
    zs = jnp.where(am, jnp.asarray(setup["z"])[perm], 0)
    batchs = jnp.where(am, 0, 1)
    nbr, nbr_emb = q2_lists(build_neighbor_matrix, spec, setup["bd"], bj,
                            pos_s, batchs, am)
    assert not bool(nbr.overflow)
    rel, eov = jcb.edge_rel(blocks, nbr.idx, nbr.mask, pos_s,
                            jnp.asarray(setup["bd"]))
    assert not bool(eov)
    q = jnp.zeros((1,), jnp.float32)

    def energy(p):
        p_s = jcb.permute_rows(p, perm, am, blocks.inv_perm)
        return jnp.sum(jpot.energy(
            setup["variables"], zs, p_s, batchs, num_mols=1, box=bj, q=q,
            nbr=nbr, blocked=jcb.BlockedMP(rel, blocks.run_starts),
            nbr_emb=nbr_emb if dual else None))

    e, g = jax.jit(jax.value_and_grad(energy))(pj)
    return float(e), -np.asarray(g)


def q2_port(setup, variant):
    """The port's blocked TensorNet2 of ``variant`` on the CPU with the JAX
    weights, and its spec."""
    from torchmdnet_tpu_torch.ops.cell_blocks import CellBlockSpec

    q_tab, grouped, _ = Q2_VARIANTS[variant]
    spec = CellBlockSpec(**setup["specs"][grouped]._asdict())
    pot = port_create_model(dict(setup["args"], cell_block_spec=spec,
                                 q_tab=q_tab), device="cpu")
    pot.module.load_state_dict(params_from_jax(setup["flat"]), strict=True)
    return pot, spec


def q2_port_blocked(setup, variant):
    """Energy and forces (original order) of the port's blocked model on its
    own sort and lists, and the set of q-tier dispatchers
    (``ops/blocked_q.py``) it ran."""
    from torchmdnet_tpu_torch.ops import blocked_q
    from torchmdnet_tpu_torch.ops import cell_blocks as tcb
    from torchmdnet_tpu_torch.ops.neighbors import build_neighbor_matrix

    pot, spec = q2_port(setup, variant)
    pt = torch.from_numpy(setup["pos"])
    blocks = tcb.plan_cell_blocks(pt, setup["bd"], spec)
    perm = torch.clamp(blocks.perm, max=Q2_N - 1)
    am = blocks.mask_rows
    pos_s = torch.where(am[:, None], pt[perm], 0.0)
    zs = torch.where(am, torch.from_numpy(setup["z"]).long()[perm], 0)
    batchs = (~am).long()
    box = torch.from_numpy(setup["box"])
    nbr, nbr_emb = q2_lists(build_neighbor_matrix, spec, setup["bd"], box,
                            pos_s, batchs, am)
    assert not bool(nbr.overflow)
    p = pt.clone().requires_grad_(True)
    calls = set()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("q_fwd", "q_dq", "q_fwd_rbf", "q_dq_rbf"):
            fn = getattr(blocked_q, name)
            mp.setattr(blocked_q, name, lambda *a, _n=name, _f=fn, **kw:
                       calls.add(_n) or _f(*a, **kw))
        y = pot.module(zs, tcb.permute_rows(p, perm, am, blocks.inv_perm),
                       batchs, num_mols=1, box=box, q=torch.zeros(1), nbr=nbr,
                       blocked=True,
                       nbr_emb=nbr_emb if Q2_VARIANTS[variant][2] else None)
        (g,) = torch.autograd.grad(y.sum(), p)
    return float(y.detach()), -g.numpy(), calls


# ---- training (bench.py::bench_train's step at a small width): TensorNet
# F=16, 2 layers, 8 rbf, 5 Å, K=16 brute neighbors, the Scalar head; a
# batch of three molecules with ghost rows
TRAIN_ARGS = dict(
    model="tensornet", embedding_dimension=16, num_layers=2, num_rbf=8,
    rbf_type="expnorm", trainable_rbf=False, activation="silu",
    cutoff_lower=0.0, cutoff_upper=5.0, max_z=128, max_num_neighbors=16,
    derivative=True, prior_model=None, output_model="Scalar",
    reduce_op="sum", precision=32, equivariance_invariance_group="O(3)",
    atom_filter=-1, pallas_edge_mlp=False)
TRAIN_MOLS, TRAIN_ROWS = 3, 32
TRAIN_STEPS = 3
# the step's hyperparameters: the defaults, and everything turned on
TRAIN_HP = {
    "default": dict(lr=1e-3),
    "all_on": dict(lr=1e-3, weight_decay=0.05, lr_warmup_steps=2,
                   ema_alpha_y=0.7, ema_alpha_neg_dy=0.4,
                   gradient_clipping=0.5, y_weight=0.3, neg_dy_weight=0.9),
}


def train_batch(seed=0, q=None):
    """``bench.py:404-419``'s batch, small: molecules of 6-9 H/C/N/O atoms
    at uniform positions in a 5 Å cube, 12 Å apart, ghost rows (segment
    ``TRAIN_MOLS``) after them; random y and neg_dy (0 on ghosts); with
    ``q`` the molecules' total charges (``batch["q"]``, what TensorNet2
    with ``charge: true`` trains on)."""
    rng = np.random.RandomState(seed)
    z = np.zeros(TRAIN_ROWS, np.int32)
    seg = np.full(TRAIN_ROWS, TRAIN_MOLS, np.int32)
    pos = np.zeros((TRAIN_ROWS, 3), np.float32)
    o = 0
    for m, n in enumerate((6, 9, 7)):
        z[o:o + n] = rng.choice([1, 1, 6, 7, 8], n)
        pos[o:o + n] = rng.uniform(-2.5, 2.5, (n, 3)) + 12.0 * m
        seg[o:o + n] = m
        o += n
    pos[o:] = rng.uniform(-2.0, 2.0, (TRAIN_ROWS - o, 3)) + 50.0
    out = dict(z=z, pos=pos, batch=seg,
               y=rng.randn(TRAIN_MOLS, 1).astype(np.float32),
               neg_dy=(rng.randn(TRAIN_ROWS, 3)
                       * (seg < TRAIN_MOLS)[:, None]).astype(np.float32),
               mol_mask=np.ones(TRAIN_MOLS, bool))
    if q is not None:
        out["q"] = np.asarray(q, np.float32)
    return out


def train_steps_jax(args, hp, batch):
    """``TRAIN_STEPS`` jitted JAX ``make_train_step`` updates from the
    initial weights: ``(initial flat params, [metrics per step], final
    flat params, flat first-step gradients)``.  The gradients are the
    ones the first update handed AdamW (after the EMA scale and the clip),
    read back from its first moment, which is ``(1 − b1)·g`` after one
    update."""
    from torchmdnet_tpu.train.step import create_train_state, make_train_step

    jpot = jax_create_model(args)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda key: jpot.init(
        key, jb["z"], jb["pos"], jb["batch"], num_mols=TRAIN_MOLS))(
        jax.random.PRNGKey(0))
    hp = dict(hp)
    state = create_train_state(
        variables["params"], lr=hp["lr"],
        weight_decay=hp.get("weight_decay", 0.0),
        gradient_clipping=hp.get("gradient_clipping", 0.0))
    step = jax.jit(make_train_step(jpot, num_mols=TRAIN_MOLS, **hp))
    metrics = []
    grads = None
    for _ in range(TRAIN_STEPS):
        state, m = step(state, jb)
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {k: v / (1.0 - ADAM_B1) for k, v in
                     flatten_params(_adam_mu(state.opt_state)).items()}
    return (flatten_params(variables["params"]), metrics,
            flatten_params(state.params), grads)


ADAM_B1 = 0.9  # optax.adamw's default, which the JAX step uses


def _adam_mu(opt_state):
    """The first-moment tree of the Adam state inside an optax state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu
    if isinstance(opt_state, tuple):
        for item in opt_state:
            mu = _adam_mu(item)
            if mu is not None:
                return mu
    return None


def train_steps_port(args, hp, batch, flat):
    """The same steps through the port on the CPU from the same weights:
    ``([metrics per step], final state dict, first-step gradients)``, the
    gradients read from the parameters when the first update calls
    ``optimizer.step`` (after the step's clipping)."""
    from torchmdnet_tpu_torch.train.step import (
        create_train_state, make_train_step)

    pot = port_create_model(args, device="cpu")
    pot.module.load_state_dict(params_from_jax(flat), strict=True)
    hp = dict(hp)
    state = create_train_state(pot, lr=hp.pop("lr"),
                               weight_decay=hp.pop("weight_decay", 0.0))
    step = make_train_step(pot, num_mols=TRAIN_MOLS, **hp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    update = state.optimizer.step

    def recording_update(*a, **kw):
        if not grads:
            grads.update((name, p.grad.detach().numpy().copy())
                         for name, p in pot.module.named_parameters())
        return update(*a, **kw)

    state.optimizer.step = recording_update
    metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, tb)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: v.detach().numpy() for k, v in
                     pot.module.state_dict().items()}, grads


# the port's weights by the module that holds them, for the parity cases
TRAIN_GROUPS = ("representation_model.tensor_embedding",
                "representation_model.layers.0",
                "representation_model.layers.1",
                "representation_model.out_norm", "representation_model.linear",
                "output_model")


def check_train_losses(want, got):
    """Every step's losses and LR at rtol = atol = 1e-4."""
    for a, b in zip(got[0], want[1]):
        for key in ("loss", "loss_y", "loss_neg_dy", "lr"):
            np.testing.assert_allclose(a[key], b[key], rtol=RTOL, atol=ATOL,
                                       err_msg=key)


def check_train_weights(want, got, group):
    """The updated weights under ``group`` at rtol = atol = 1e-4, and that
    training moved them by more than the tolerance (non-vacuous)."""
    flat0, _, flat_j, _ = want
    sd_t = got[1]
    sd_j, sd_0 = params_from_jax(flat_j), params_from_jax(flat0)
    assert sd_t.keys() == sd_j.keys()
    keys = [k for k in sd_j if k.startswith(group + ".")]
    assert keys
    moved = max(float((sd_j[k] - sd_0[k]).abs().max()) for k in keys)
    assert moved > 10 * ATOL
    for key in keys:
        np.testing.assert_allclose(sd_t[key], sd_j[key].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=key)


def check_train_grads(want, got, group):
    """The first update's gradients under ``group``, each within 1e-4 of
    that gradient's max |·| (a gradient off by a factor, a missing or
    wrong clip or EMA scale fails here even where Adam's normalised
    update hides it), and not all zero."""
    g_j = params_from_jax(want[3])
    g_t = got[2]
    assert g_t.keys() == g_j.keys()
    keys = [k for k in g_j if k.startswith(group + ".")]
    assert keys
    assert max(float(g_j[k].abs().max()) for k in keys) > 0
    for key in keys:
        ref = g_j[key].numpy()
        scale = float(np.abs(ref).max())
        err = float(np.abs(g_t[key] - ref).max())
        assert err <= 1e-4 * scale, (key, err, scale)


def check_ghost_rows_inert(args, flat, q=None):
    """Ghost rows (segment ``TRAIN_MOLS``) move neither the losses nor the
    weight gradients: new ghost positions, species and neg_dy targets
    give the same step (``q``: the molecules' charges, as
    :func:`train_batch`)."""
    batch = train_batch(q=q)
    other = dict(batch)
    rng = np.random.RandomState(11)
    ghost = batch["batch"] == TRAIN_MOLS
    other["pos"] = np.where(ghost[:, None], rng.uniform(
        40, 60, batch["pos"].shape), batch["pos"]).astype(np.float32)
    other["z"] = np.where(ghost, 6, batch["z"]).astype(np.int32)
    other["neg_dy"] = np.where(ghost[:, None], 5.0,
                               batch["neg_dy"]).astype(np.float32)
    (m_a, sd_a, g_a), (m_b, sd_b, g_b) = [
        train_steps_port(args, TRAIN_HP["default"], b, flat)
        for b in (batch, other)]
    for key, value in g_a.items():
        np.testing.assert_allclose(g_b[key], value, rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    for a, b in zip(m_a, m_b):
        for key in a:
            np.testing.assert_allclose(b[key], a[key], rtol=RTOL, atol=ATOL,
                                       err_msg=key)
    for key, value in sd_a.items():
        np.testing.assert_allclose(sd_b[key], value, rtol=RTOL, atol=ATOL,
                                   err_msg=key)


# ---- the attention models and the graph network (ET, T, GN) at a small
# width: 2 layers x 32, 4 heads, 16 rbf, 4.5 Å, K = 16; ET with
# vector_cutoff as the ET recipes set it
ATTN_ARGS = dict(
    embedding_dimension=32, num_layers=2, num_rbf=16, rbf_type="expnorm",
    trainable_rbf=False, activation="silu", cutoff_lower=0.0,
    cutoff_upper=4.5, max_z=100, max_num_neighbors=16, derivative=True,
    prior_model=None, output_model="Scalar", reduce_op="sum",
    precision=32, atom_filter=-1, attn_activation="silu", num_heads=4,
    distance_influence="both", neighbor_embedding=True, vector_cutoff=True,
    aggr="add")
ET_ARGS = dict(ATTN_ARGS, model="equivariant-transformer")
T_ARGS = dict(ATTN_ARGS, model="transformer")
GN_ARGS = dict(ATTN_ARGS, model="graph-network")


def attn_system():
    """Three molecules, of 12 and 9 atoms and one atom that no other
    reaches, and two ghost rows (segment 3): ``(z, pos, batch,
    num_mols)``, numpy.  No atom has more than 12 neighbors, so K = 16
    holds."""
    (za, pa, _), (zb, pb, _) = open_molecule(12, seed=3), open_molecule(
        9, seed=4)
    pos = np.concatenate([pa, pb + 20.0, [[40.0, 0.0, 0.0]],
                          [[60.0, 0.0, 0.0], [60.0, 0.0, 1.5]]])
    z = np.concatenate([za, zb, [8, 1, 1]])
    batch = np.repeat([0, 1, 2, 3], [12, 9, 1, 2])
    return (z.astype(np.int32), pos.astype(np.float32),
            batch.astype(np.int32), 3)


def attn_jax(args, system, seed=0, box=None):
    """The JAX model of ``args`` on ``system`` (jitted init and
    energy+forces, in the periodic ``box`` if given): ``(flat params, y,
    forces)`` as numpy."""
    z, pos, batch, m = system
    jpot = jax_create_model(args)
    if args.get("precision") == 64:  # under jax.enable_x64
        pos = pos.astype(np.float64)
    z, pos, batch = (jnp.asarray(a) for a in (z, pos, batch))
    box = _maybe(box)
    variables = jax.jit(lambda key: jpot.init(key, z, pos, batch,
                                              num_mols=m, box=box))(
        jax.random.PRNGKey(seed))
    y, f = jax.jit(lambda v, p: jpot.apply(v, z, p, batch, num_mols=m,
                                           box=box))(variables, pos)
    return flatten_params(variables["params"]), np.asarray(y), np.asarray(f)


def attn_port(args, flat, system, box=None):
    """The port's model of ``args`` with the JAX weights ``flat`` and its
    ``(y, forces)`` on ``system`` as numpy."""
    z, pos, batch, m = system
    pot = port_create_model(args, device="cpu")
    pot.module.load_state_dict(params_from_jax(flat), strict=True)
    y, f = pot.apply(z, pos, batch, num_mols=m, box=box)
    return pot, to_np(y), to_np(f)


def close_to_scale(got, want, tol=RTOL):
    """``got`` within rtol = ``tol`` and atol = ``tol`` · max(1, max
    |want|) of ``want``: float32 sums of terms ~100 round at ~1e-5, so
    the absolute part scales with the largest value, as
    ``test_torch_load_model.py::_close`` does."""
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def attn_check(args, seed=0, tol=RTOL, system=None, box=None):
    """The port's energies and forces against JAX's on ``system``
    (:func:`attn_system` when None; in ``box`` if given) with the same
    weights, to ``tol`` (1e-4) by :func:`close_to_scale`; the ghost rows
    feel no force.  Returns the port's potential and forces."""
    system = attn_system() if system is None else system
    flat, y_j, f_j = attn_jax(args, system, seed, box)
    pot, y_t, f_t = attn_port(args, flat, system, box)
    assert y_t.dtype == y_j.dtype and f_t.dtype == f_j.dtype
    assert y_t.shape == y_j.shape and f_t.shape == f_j.shape
    close_to_scale(y_t, y_j, tol)
    close_to_scale(f_t, f_j, tol)
    assert not f_t[system[2] == system[3]].any()
    assert np.abs(f_t).max() > 10 * ATOL  # not vacuous
    return pot, f_t
