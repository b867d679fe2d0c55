"""The port's ``make_adaptive_md_step`` and ``run_md`` on the CPU, with no
JAX: a grouped spec busted by a density spike re-specs and recovers (the
grouped list's overflow is transient), the JAX package's ungrouped spike
(``tests/test_blocked_model.py::test_adaptive_md_respec_on_density_spike``)
needs no re-spec here, ``max_respecs=0`` falls back to the gather path,
and ``run_md`` is ``init_state`` plus chunks on packed batches and on the
cell strategy (the counterparts of ``tests/test_md.py:84-160``)."""

import warnings

import numpy as np
import pytest
import torch

from torch_parity import TENSORNET_ARGS, one_torch_thread  # noqa: F401
from torchmdnet_tpu_torch.md.integrators import (
    make_adaptive_md_step, make_md_step, run_md)
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.ops.cell_blocks import tune_cell_block_spec

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CUTOFF, SKIN = 3.2, 0.5
ARGS = dict(TENSORNET_ARGS, embedding_dimension=16, num_layers=1, num_rbf=4,
            cutoff_upper=CUTOFF, max_num_neighbors=80)
KW = dict(dt=0.2, num_mols=1, rebuild_every=2, skin=SKIN)
FORCE_TOL = 1e-4  # of max |F|, against the gather path


def _system(n=260, density=0.08, seed=5):
    """The JAX test's system: ``n`` atoms uniform in a cube."""
    rng = np.random.RandomState(seed)
    L = (n / density) ** (1.0 / 3.0)
    pos = rng.uniform(0, L, (n, 3)).astype(np.float32)
    z = rng.choice([1, 6, 8], n).astype(np.int64)
    return z, pos, np.diag([L, L, L]).astype(np.float32), L


def _column_spike(pos, L, m=18, r=2.2, seed=0):
    """``m`` atoms (the farthest from it) moved into a 1.0-2.2 Å shell
    around the atom nearest the middle of xy-column (0, 0): its own stencil
    column then holds more neighbors than the tuned budget, while no cell
    exceeds its capacity and no row exceeds K."""
    rng = np.random.RandomState(seed)
    c = int(np.argmin(np.linalg.norm(pos - [L / 8, L / 8, L / 2], axis=1)))
    d = np.linalg.norm((pos - pos[c] + L / 2) % L - L / 2, axis=1)
    pts = []
    while len(pts) < m:
        v = rng.uniform(-r, r, 3)
        q = pos[c] + v
        if 1.0 < np.linalg.norm(v) < r and all(
                np.linalg.norm(q - x) > 1.0 for x in pts):
            pts.append(q)
    out = pos.copy()
    out[np.argsort(d)[-m:]] = np.array(pts) % L
    return out


def _gather_forces(pot, z, pos, box):
    init, _, _ = make_md_step(pot.with_spec(None), z, np.zeros(len(z)),
                              np.full(len(z), 12.0), box=box, **KW)
    st = init(pos, seed=1)
    assert not bool(st.overflow)
    return st.force


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def grouped():
    z, pos, box, L = _system()
    spec = tune_cell_block_spec(pos, [L] * 3, CUTOFF + SKIN, cap=8,
                                column_slots=True)
    pot = create_model(dict(ARGS, cell_block_spec=spec), device="cpu")
    spiked = _column_spike(pos, L)
    return z, spiked, box, spec, pot, _gather_forces(pot, z, spiked, box)


def _record(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in rec]


def test_make_md_step_folds_the_grouped_overflow(grouped):
    """Without the adaptive wrapper the grouped list's overflow is folded
    into the sticky flag after the rebuild (JAX ``_fold_transient``)."""
    z, spiked, box, spec, pot, _ = grouped
    init, chunk, _ = make_md_step(pot, z, np.zeros(len(z)),
                                  np.full(len(z), 12.0), box=box,
                                  cell_block_spec=spec, **KW)
    st = chunk.init_raw(spiked, seed=1)
    assert bool(st.blk_overflow) and not bool(st.overflow)
    assert bool(init(spiked, seed=1).overflow)


def test_grouped_spike_respecs_and_recovers(grouped):
    """The spike busts a column budget tuned on the uniform system: the
    wrapper warns, grows the budgets on the live geometry, carries no
    sticky overflow, and its forces match the gather path's; a chunk
    then runs on the new spec."""
    z, spiked, box, spec, pot, f_gather = grouped
    init, chunk, _ = make_adaptive_md_step(
        pot, z, np.zeros(len(z)), np.full(len(z), 12.0), box=box,
        cell_block_spec=spec, **KW)
    st, msgs = _record(lambda: init(spiked, seed=1))
    assert any("re-spec'd col_slots" in m for m in msgs), msgs
    new = chunk.current["spec"]
    assert new.col_slots != spec.col_slots
    assert all(a >= b for a, b in zip(new.col_slots, spec.col_slots))
    assert not bool(st.overflow)
    assert _rel(st.force, f_gather) < FORCE_TOL
    st = chunk(st)
    assert st.step == 2 and not bool(st.overflow)
    assert torch.isfinite(st.pos).all()


def test_max_respecs_zero_falls_back_to_gather(grouped):
    z, spiked, box, spec, pot, f_gather = grouped
    init, chunk, _ = make_adaptive_md_step(
        pot, z, np.zeros(len(z)), np.full(len(z), 12.0), box=box,
        cell_block_spec=spec, max_respecs=0, **KW)
    st, msgs = _record(lambda: init(spiked, seed=1))
    assert any("falling back to the exact gather path" in m for m in msgs)
    assert chunk.current["spec"] is None and st.perm is None
    assert not bool(st.overflow)
    assert _rel(st.force, f_gather) < 1e-6
    assert not bool(chunk(st).overflow)


def test_ungrouped_spike_needs_no_respec():
    """The JAX test's spike (80 atoms on a dense z-line in one xy-column)
    busts the JAX tier's window budget.  The port plans exact row pieces
    and has no window budget, so on its ungrouped tier nothing overflows
    and nothing is re-spec'd: that is the port's design.  Forces match
    the gather path."""
    z, pos, box, L = _system()
    spec = tune_cell_block_spec(pos, [L] * 3, CUTOFF + SKIN, cap=8)
    spiked = pos.copy()
    spiked[:80, 0] = 0.125 * L
    spiked[:80, 1] = 0.125 * L
    spiked[:80, 2] = np.linspace(0.1, L - 0.1, 80)
    pot = create_model(dict(ARGS, cell_block_spec=spec), device="cpu")
    init, chunk, _ = make_adaptive_md_step(
        pot, z, np.zeros(len(z)), np.full(len(z), 12.0), box=box,
        cell_block_spec=spec, **KW)
    st, msgs = _record(lambda: init(spiked, seed=1))
    assert not msgs and chunk.current["spec"] is spec
    assert st.blk_overflow is None and not bool(st.overflow)
    assert _rel(st.force, _gather_forces(pot, z, spiked, box)) < FORCE_TOL


def test_run_md_is_init_state_plus_chunks():
    z, pos, box, L = _system(n=60, seed=2)
    pot = create_model(dict(ARGS, max_num_neighbors=48), device="cpu")
    kw = dict(dt=0.2, box=box, rebuild_every=3, skin=SKIN, temperature=300.0)
    st = run_md(pot, z, pos, np.full(len(z), 12.0), n_steps=7, seed=4, **kw)
    init, chunk, _ = make_md_step(pot, z, np.zeros(len(z)),
                                  np.full(len(z), 12.0), **kw)
    ref = chunk(chunk(init(pos, seed=4)))
    assert st.step == ref.step == 6 and not bool(st.overflow)
    assert torch.equal(st.pos, ref.pos) and torch.equal(st.vel, ref.vel)
    one = run_md(pot, z, pos, np.full(len(z), 12.0), n_steps=2, seed=4, **kw)
    assert one.step == 3  # at least one chunk


def test_run_md_forces_every_segment():
    """A packed batch of two molecules and ghost rows: both molecules feel
    forces, the ghosts stay where they are and trip no overflow."""
    pot = create_model(dict(ARGS, max_num_neighbors=16, cutoff_upper=4.5),
                       device="cpu")
    rng = np.random.RandomState(7)
    n1, n2, n_pad = 5, 6, 16
    z = np.zeros(n_pad, np.int64)
    pos = np.zeros((n_pad, 3), np.float32)
    seg = np.full(n_pad, 2, np.int64)
    z[:n1] = rng.randint(1, 9, n1)
    pos[:n1] = rng.uniform(-1.5, 1.5, (n1, 3))
    seg[:n1] = 0
    z[n1:n1 + n2] = rng.randint(1, 9, n2)
    pos[n1:n1 + n2] = rng.uniform(-1.5, 1.5, (n2, 3)) + 50.0
    seg[n1:n1 + n2] = 1
    st = run_md(pot, z, pos, np.full(n_pad, 12.0), n_steps=10, dt=0.5,
                batch=seg, num_mols=2, rebuild_every=5, skin=1.0)
    assert not bool(st.overflow)
    moved = (st.pos.numpy() - pos)
    assert np.abs(moved[:n1]).max() > 1e-5
    assert np.abs(moved[n1:n1 + n2]).max() > 1e-5, "molecule 1 saw no forces"
    assert np.abs(moved[n1 + n2:]).max() == 0.0


def test_run_md_cell_strategy_infers_grid():
    """``neighbor_strategy="cell"`` without ``cells_per_dim``: the grid
    comes from the box."""
    pot = create_model(dict(ARGS, max_num_neighbors=32, cutoff_upper=4.5),
                       device="cpu")
    rng = np.random.RandomState(5)
    m, spacing = 5, 3.2
    g = np.arange(m) * spacing + spacing / 2
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pos = (pos + rng.uniform(-0.1, 0.1, pos.shape)).astype(np.float32)
    z = rng.randint(1, 9, len(pos)).astype(np.int64)
    box = np.diag([m * spacing] * 3).astype(np.float32)
    st = run_md(pot, z, pos, np.full(len(z), 12.0), n_steps=20, dt=0.2,
                box=box, rebuild_every=10, skin=1.0, neighbor_strategy="cell")
    assert torch.isfinite(st.pos).all() and not bool(st.overflow)
    assert st.step == 20
