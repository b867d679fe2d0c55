"""Molecular dynamics on the port's potentials.

Counterpart of ``torchmdnet_tpu/md/integrators.py``: velocity Verlet with
the force carried in the state (one gradient per step, ``vv_step``
``:373-397``), an optional Langevin (OU) thermostat, and a neighbor
rebuild with a ``skin`` every ``rebuild_every`` steps (``_rebuild``
``:405-493``).  Between rebuilds the model and the Coulomb head consume
their skin-cached lists; edges beyond the true cutoffs contribute exactly
zero.  One ``chunk`` is one rebuild and ``rebuild_every`` steps
(``:507-511``).  The loop is plain Python; the Langevin noise and the
initial velocities come from a ``torch.Generator`` seeded by ``seed``.

With a ``cell_block_spec`` (the blocked path, ``:245-290``) every rebuild
sorts the atoms into cell-blocked order (``ops/cell_blocks.py``); the
model runs in that sorted row space on its blocked tier (the q-tier on
TensorNet2, rows 8-11 on TensorNet), the state stays in the original
order, and forces come back through ``permute_rows``, whose backward is
the inverse gather.  A grouped spec (``col_slots``) makes the
sorted-space list a column-partitioned cell list on the spec's xy grid
with ``K′ = Σ col_slots`` slots (``:264-281``); on a TensorNet2 with the
θ-tabulated q-tier every rebuild also makes the compact ``K`` list of the
dual-list embedding on the same grid (``enbr_*``, ``:282-289``,
``:443-450``), whose overflow is ORed in.
``coulomb_window_spec`` (a ``StencilWindowSpec``, or ``"auto"`` to tune
it from the ``init_state`` positions at the skin-padded Coulomb cutoff)
replaces the Coulomb list with stencil windows over the same sort
(kernels C and D); without it the Coulomb list is built in sorted space.
K overflow stays sticky, but for the grouped list: its per-column
budgets are part of the spec, so its overflow is transient
(``blk_overflow``, JAX ``:418-428``) and folded into the sticky flag
after the rebuild (``_fold_transient``, ``:501-505``), unless
:func:`make_adaptive_md_step` recovers from it first.  :func:`run_md`
is the one-call entry point.

Units: Å, eV, amu, fs.  ``ACC_FACTOR`` converts (eV/Å)/amu → Å/fs².
"""

import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from torchmdnet_tpu_torch.ops.cell_blocks import (
    CellBlockSpec, StencilWindowSpec, lane_quantum, permute_rows,
    plan_cell_blocks_and_windows, tune_cell_block_spec,
    tune_stencil_window_spec)
from torchmdnet_tpu_torch.ops.neighbors import (
    NeighborMatrix, build_neighbor_matrix, pick_cell_grid)
from torchmdnet_tpu_torch.ops.windowed_coulomb import (
    CoulombWindows, make_coulomb_windows)

ACC_FACTOR = 9.648533212331024e-3  # (eV/Å)/amu → Å/fs²
KB_EV = 8.617333262e-5  # Boltzmann constant, eV/K
# velocity variance at temperature T: v² ~ kT/m with kT in eV → Å²/fs²
VEL2_FACTOR = KB_EV * ACC_FACTOR


class MDState(NamedTuple):
    pos: torch.Tensor  # [N, 3] Å
    vel: torch.Tensor  # [N, 3] Å/fs
    force: torch.Tensor  # [N, 3] eV/Å at ``pos`` (carried: 1 grad/step)
    energy: torch.Tensor  # [num_mols, 1] eV at ``pos``
    nbr_idx: torch.Tensor
    nbr_mask: torch.Tensor
    nbr_rev: torch.Tensor
    generator: torch.Generator
    step: int
    overflow: torch.Tensor  # [] bool, sticky across rebuilds
    # skin-cached Coulomb-head list (None without a cutoff-Coulomb head)
    cnbr_idx: Optional[torch.Tensor] = None
    cnbr_mask: Optional[torch.Tensor] = None
    # blocked path: the rebuild's sort, the sorted-space atom types and
    # molecules (ghost rows: type 0, molecule num_mols) and the Coulomb
    # windows; the neighbor lists above are then in sorted space
    perm: Optional[torch.Tensor] = None       # [n_pad] sorted row → atom
    inv_perm: Optional[torch.Tensor] = None   # [N] atom → sorted row
    mask_rows: Optional[torch.Tensor] = None  # [n_pad] real-atom rows
    zs: Optional[torch.Tensor] = None
    batchs: Optional[torch.Tensor] = None
    cwin: Optional[CoulombWindows] = None
    # grouped blocked path on TensorNet2 (q_tab > 0): the compact list of
    # the dual-list embedding, in sorted space
    enbr_idx: Optional[torch.Tensor] = None
    enbr_mask: Optional[torch.Tensor] = None
    enbr_rev: Optional[torch.Tensor] = None
    # grouped blocked path: the column-partitioned list's overflow of this
    # rebuild, not yet folded into ``overflow``
    blk_overflow: Optional[torch.Tensor] = None


def maxwell_boltzmann_velocities(generator, masses, temperature, like):
    sigma = torch.sqrt(VEL2_FACTOR * temperature / masses)[:, None]
    return sigma * torch.randn(like.shape, generator=generator,
                               dtype=like.dtype, device=like.device)


def kinetic_energy(vel, masses):
    """Kinetic energy in eV."""
    return 0.5 * torch.sum(masses[:, None] * vel * vel) / ACC_FACTOR


def _box_diag(box) -> np.ndarray:
    b = box.detach().cpu().numpy()
    if b.ndim == 3:
        b = b[0]
    return np.diag(b).astype(np.float64)


def make_md_step(potential, z, batch, masses, *, dt: float, num_mols: int = 1,
                 box=None, q=None, rebuild_every: int = 25, skin: float = 1.0,
                 k_max: Optional[int] = None,
                 temperature: Optional[float] = None, gamma: float = 0.01,
                 neighbor_strategy: str = "brute", cells_per_dim=None,
                 cell_block_spec=None, coulomb_window_spec=None):
    """Build ``(init_state, chunk, energy)`` for ``potential`` (a
    :class:`~torchmdnet_tpu_torch.models.model.Potential`).

    ``chunk(state)`` rebuilds the neighbor lists and advances
    ``rebuild_every`` steps; ``state.overflow`` is sticky.  ``energy(pos,
    state)`` is the potential energy on the state's cached lists.
    ``cell_block_spec`` (the spec the potential was built with) and
    ``coulomb_window_spec`` select the blocked path (module docstring);
    it needs an orthogonal ``box``.
    """
    dev = potential.device
    rep = potential.module.representation_model
    use_blocked = cell_block_spec is not None
    if use_blocked:
        spec = CellBlockSpec(**cell_block_spec._asdict())
        if box is None:
            raise ValueError("cell_block_spec requires an orthogonal box")
    out_mod = potential.module.output_model
    cutoff = float(rep.cutoff_upper)
    z = torch.as_tensor(z, device=dev).long()
    batch = torch.as_tensor(batch, device=dev).long()
    masses = torch.as_tensor(masses, dtype=torch.float32, device=dev)
    inv_m = (1.0 / masses)[:, None]
    if box is not None:
        box = torch.as_tensor(box, dtype=torch.float32, device=dev)
    # ghosts (extra segment num_mols) are kept out of the neighbor lists
    atom_mask = batch < num_mols
    n_atoms = int(z.shape[0])
    if use_blocked:
        bd = _box_diag(box)
        bd_t = torch.as_tensor(bd, dtype=torch.float32, device=dev)

    k_cap = int(k_max if k_max is not None else rep.max_num_neighbors)
    nbr_kwargs = dict(strategy=neighbor_strategy, k_max=k_cap,
                      cutoff_upper=cutoff + skin,
                      cutoff_lower=float(rep.cutoff_lower), loop=True, box=box)
    if neighbor_strategy == "cell":
        if box is None:
            raise ValueError("neighbor_strategy='cell' requires a box")
        if cells_per_dim is None:
            dims = np.maximum(np.floor(_box_diag(box) / (cutoff + skin)), 3)
            cells_per_dim = tuple(int(d) for d in dims)
        nbr_kwargs["cells_per_dim"] = cells_per_dim
    if use_blocked and spec.col_slots is not None:
        # the grouped tier's list: the spec's xy grid, one slot budget per
        # stencil column, K' = Σ budgets in place of the model's K
        nz = max(int(bd[2] // (cutoff + skin)), 3)
        occ = int(atom_mask.sum()) / (spec.nx * spec.ny * nz)
        nbr_kwargs.update(strategy="cell", k_max=sum(spec.col_slots),
                          cells_per_dim=(spec.nx, spec.ny, nz),
                          cell_capacity=int(np.ceil(occ * 2.5)) + 8,
                          column_partition=spec.col_slots)
    # the dual-list embedding's compact K list on the same grid, made only
    # when the interactions need no rbf array (the θ-tabulated q-tier)
    emb_kwargs = None
    if use_blocked and spec.col_slots is not None and getattr(rep, "q_tab",
                                                              0):
        emb_kwargs = dict(nbr_kwargs, k_max=k_cap)
        del emb_kwargs["column_partition"]

    coulomb_rc = getattr(out_mod, "coulomb_cutoff", None)
    use_cwin = (use_blocked and coulomb_rc is not None
                and coulomb_window_spec is not None)
    wspec = {"spec": None}  # "auto": tuned by init_state
    if use_cwin and not isinstance(coulomb_window_spec, str):
        wspec["spec"] = StencilWindowSpec(**coulomb_window_spec._asdict())
    # Cutoff-Coulomb head without windows: a second skin-cached list at
    # coulomb_cutoff + skin.  Its budget scales the head's default (which
    # already carries ×1.35+16 headroom) by the skin volume and adds
    # ×1.35+16 again — the JAX package's doubled headroom
    # (integrators.py:213-214), mirrored on purpose so both build the same
    # lists.
    ckwargs = None
    if coulomb_rc is not None and not use_cwin:
        rc_skin = coulomb_rc + skin
        ckwargs = dict(
            strategy=neighbor_strategy,
            k_max=int(out_mod.coulomb_max_neighbors()
                      * (rc_skin / coulomb_rc) ** 3 * 1.35) + 16,
            cutoff_upper=rc_skin, cutoff_lower=0.0, loop=False, box=box)
        if neighbor_strategy == "cell":
            dims, stencil, cap = pick_cell_grid(
                _box_diag(box), rc_skin, int(atom_mask.sum()))
            ckwargs.update(cells_per_dim=dims, stencil=stencil,
                           cell_capacity=cap)

    def _nbr(st: MDState):
        return NeighborMatrix(st.nbr_idx, st.nbr_mask, rev_slot=st.nbr_rev)

    def _enbr(st: MDState):
        if st.enbr_idx is None:
            return None
        return NeighborMatrix(st.enbr_idx, st.enbr_mask, rev_slot=st.enbr_rev)

    def _cnbr(st: MDState):
        if st.cnbr_idx is None:
            return None
        return NeighborMatrix(st.cnbr_idx, st.cnbr_mask)

    def energy_forces(pos, st: MDState):
        if not use_blocked:
            return potential.apply(z, pos, batch, num_mols=num_mols, box=box,
                                   q=q, nbr=_nbr(st), coulomb_nbr=_cnbr(st))
        # the model in sorted space; forces in the original order
        pos = pos.detach().requires_grad_(True)
        with torch.enable_grad():
            y = energy_state(pos, st)
            (dy,) = torch.autograd.grad(y.sum(), pos)
        return y.detach(), -dy

    def energy_state(pos, st: MDState):
        pos_s = permute_rows(pos, st.perm, st.mask_rows, st.inv_perm)
        return potential.module(st.zs, pos_s, st.batchs, num_mols=num_mols,
                                box=box, q=q, nbr=_nbr(st),
                                coulomb_nbr=_cnbr(st), blocked=True,
                                coulomb_win=st.cwin, nbr_emb=_enbr(st))

    def energy(pos, st: MDState):
        with torch.no_grad():
            if use_blocked:
                return energy_state(pos, st)
            return potential.energy(z, pos, batch, num_mols=num_mols, box=box,
                                    q=q, nbr=_nbr(st), coulomb_nbr=_cnbr(st))

    def vv_step(st: MDState) -> MDState:
        vel_half = st.vel + 0.5 * dt * st.force * inv_m * ACC_FACTOR
        pos_new = st.pos + dt * vel_half
        e2, f2 = energy_forces(pos_new, st)
        vel_new = vel_half + 0.5 * dt * f2 * inv_m * ACC_FACTOR
        if temperature is not None:
            c1 = math.exp(-gamma * dt)
            sigma = (math.sqrt(VEL2_FACTOR * temperature * (1.0 - c1 * c1))
                     * torch.sqrt(inv_m))
            vel_new = c1 * vel_new + sigma * torch.randn(
                vel_new.shape, generator=st.generator, dtype=vel_new.dtype,
                device=vel_new.device)
        return st._replace(pos=pos_new, vel=vel_new, force=f2, energy=e2,
                           step=st.step + 1)

    def rebuild_blocked(st: MDState) -> MDState:
        blocks, win = plan_cell_blocks_and_windows(
            st.pos, bd_t, spec, wspec["spec"] if use_cwin else None)
        perm = torch.clamp(blocks.perm, max=n_atoms - 1)
        batch_perm = batch[perm]
        am_s = blocks.mask_rows & (batch_perm < num_mols)
        pos_s = torch.where(am_s[:, None], st.pos[perm], 0.0)
        batchs = torch.where(am_s, batch_perm, num_mols)
        nbr = build_neighbor_matrix(pos_s, batchs, atom_mask=am_s,
                                    **nbr_kwargs)
        # the grouped list's overflow is a spec parameter (per-column
        # budgets), so it stays transient; any other K overflow is sticky
        if spec.col_slots is not None:
            sticky, blk = st.overflow, nbr.overflow
        else:
            sticky, blk = st.overflow | nbr.overflow, None
        st = st._replace(
            nbr_idx=nbr.idx, nbr_mask=nbr.mask, nbr_rev=nbr.rev_slot,
            overflow=sticky, blk_overflow=blk, perm=perm,
            inv_perm=blocks.inv_perm, mask_rows=am_s,
            zs=torch.where(am_s, z[perm], 0), batchs=batchs)
        if emb_kwargs is not None:
            enbr = build_neighbor_matrix(pos_s, batchs, atom_mask=am_s,
                                         **emb_kwargs)
            st = st._replace(enbr_idx=enbr.idx, enbr_mask=enbr.mask,
                             enbr_rev=enbr.rev_slot,
                             overflow=st.overflow | enbr.overflow)
        if use_cwin:
            st = st._replace(cwin=make_coulomb_windows(win, am_s, bd_t))
        elif ckwargs is not None:
            cnbr = build_neighbor_matrix(pos_s, batchs, atom_mask=am_s,
                                         **ckwargs)
            st = st._replace(cnbr_idx=cnbr.idx, cnbr_mask=cnbr.mask,
                             overflow=st.overflow | cnbr.overflow)
        return st

    def rebuild(st: MDState) -> MDState:
        if use_blocked:
            return rebuild_blocked(st)
        nbr = build_neighbor_matrix(st.pos, batch, atom_mask=atom_mask,
                                    **nbr_kwargs)
        st = st._replace(nbr_idx=nbr.idx, nbr_mask=nbr.mask,
                         nbr_rev=nbr.rev_slot,
                         overflow=st.overflow | nbr.overflow)
        if ckwargs is not None:
            cnbr = build_neighbor_matrix(st.pos, batch, atom_mask=atom_mask,
                                         **ckwargs)
            st = st._replace(cnbr_idx=cnbr.idx, cnbr_mask=cnbr.mask,
                             overflow=st.overflow | cnbr.overflow)
        return st

    def steps(st: MDState) -> MDState:
        for _ in range(rebuild_every):
            st = vv_step(st)
        return st

    def folded_rebuild(st: MDState) -> MDState:
        return _fold_transient(rebuild(st))

    def chunk(st: MDState) -> MDState:
        return steps(folded_rebuild(st))

    def init_raw(pos, vel=None, seed: int = 0) -> MDState:
        """The first rebuild's state, its transient flag not yet folded and
        no force yet (the adaptive wrapper checks the flag first)."""
        pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        if vel is None:
            vel = (maxwell_boltzmann_velocities(gen, masses, temperature, pos)
                   if temperature is not None else torch.zeros_like(pos))
        vel = torch.as_tensor(vel, dtype=torch.float32, device=dev)
        st = MDState(pos, vel, None, None, None, None, None, gen, 0,
                     torch.zeros((), dtype=torch.bool, device=dev))
        if use_cwin and wspec["spec"] is None:
            wspec["spec"] = tune_stencil_window_spec(
                pos, bd, spec, float(coulomb_rc) + skin)
        return rebuild(st)

    def with_force(st: MDState) -> MDState:
        e, f = energy_forces(st.pos, st)
        return st._replace(force=f, energy=e)

    def init_state(pos, vel=None, seed: int = 0) -> MDState:
        return with_force(_fold_transient(init_raw(pos, vel, seed)))

    # one rebuild (its transient flag folded), and one energy+forces
    # evaluation on a state's lists
    chunk.rebuild = folded_rebuild
    chunk.energy_forces = energy_forces
    # the pieces the adaptive wrapper composes
    chunk.raw_rebuild = rebuild
    chunk.steps = steps
    chunk.init_raw = init_raw
    chunk.with_force = with_force
    return init_state, chunk, energy


def _fold_transient(st: MDState) -> MDState:
    if st.blk_overflow is None:
        return st
    return st._replace(overflow=st.overflow | st.blk_overflow)


def make_adaptive_md_step(potential, z, batch, masses, *, cell_block_spec,
                          max_respecs: int = 4, **kw):
    """Blocked MD that recovers from a transient overflow (JAX
    ``:553-706``): :func:`make_md_step` with ``cell_block_spec``, whose
    grouped list's overflow is checked on the host at every rebuild.  When
    it fires (a density fluctuation puts more neighbors in one stencil
    column than the budget tuned at t=0), the spec's ``col_slots`` are
    re-tuned on the live geometry (grown by a lane quantum each where the
    tune finds the old ones enough), the potential is rebuilt on the new
    spec with the same weights, the rebuild re-runs from the state's
    original-order variables, and a warning says so.  After
    ``max_respecs`` re-specs it warns and runs the exact gather path for
    the rest of the run (the JAX package's documented behaviour, not a
    device fallback).  K overflow of any other list stays sticky.

    The port has no run, window or Coulomb-window budgets
    (``ops/cell_blocks.py``), so an ungrouped spec never overflows here
    and the JAX wrapper's window re-tune (``_recwin``) has nothing to do.
    ``kw`` are :func:`make_md_step`'s options; ``box`` is required."""
    if kw.get("box") is None:
        raise ValueError("make_adaptive_md_step requires an orthogonal box")
    rep = potential.module.representation_model
    cutoff_pad = float(rep.cutoff_upper) + float(kw.get("skin", 1.0))
    bd = _box_diag(torch.as_tensor(kw["box"]))
    cur = {"respecs": 0}

    def build(spec):
        pot = potential
        if spec is not cell_block_spec:
            # the spec is baked into the model: rebuild it, same weights
            pot = potential.with_spec(spec)
        _, cur["chunk"], cur["energy"] = make_md_step(
            pot, z, batch, masses, cell_block_spec=spec, **kw)
        cur["spec"] = spec

    build(cell_block_spec)

    def fresh(st: MDState) -> MDState:
        """Original-order dynamical variables only; the new closures'
        rebuild derives the rest."""
        return MDState(st.pos, st.vel, st.force, st.energy, None, None, None,
                       st.generator, st.step, st.overflow)

    def respec(st: MDState) -> MDState:
        while True:
            old = cur["spec"]
            if cur["respecs"] >= max_respecs:
                warnings.warn(
                    "blocked MD: overflow persists after "
                    f"{max_respecs} respecs; falling back to the exact "
                    "gather path")
                build(None)
                return cur["chunk"].raw_rebuild(fresh(st))
            cur["respecs"] += 1
            try:
                new = tune_cell_block_spec(
                    st.pos, bd, cutoff_pad, cap=old.cap, rlh=old.rlh,
                    precise=old.precise, column_slots=True)
            except ValueError:
                cur["respecs"] = max_respecs
                continue
            if all(a <= b for a, b in zip(new.col_slots, old.col_slots)):
                # the live tune says the old budgets suffice: grow them,
                # so that every pass makes progress
                q = lane_quantum(old.cap)
                new = old._replace(
                    col_slots=tuple(c + q for c in old.col_slots))
            warnings.warn(
                f"blocked MD: column-budget overflow at step {st.step}; "
                f"re-spec'd col_slots {old.col_slots} -> {new.col_slots} "
                "(rebuild)")
            build(new)
            nxt = cur["chunk"].raw_rebuild(fresh(st))
            if not bool(nxt.blk_overflow):
                return nxt

    def ensure(st: MDState, before: MDState) -> MDState:
        if st.blk_overflow is not None and bool(st.blk_overflow):
            st = respec(before)
        return _fold_transient(st)

    def chunk(st: MDState) -> MDState:
        nxt = ensure(cur["chunk"].raw_rebuild(st), st)
        return cur["chunk"].steps(nxt)

    def init_state(pos, vel=None, seed: int = 0) -> MDState:
        st = cur["chunk"].init_raw(pos, vel, seed)
        st = ensure(st, st)
        return cur["chunk"].with_force(st)

    def energy(pos, st: MDState):
        return cur["energy"](pos, st)

    chunk.current = cur
    return init_state, chunk, energy


def run_md(potential, z, pos, masses, *, n_steps: int, dt: float = 1.0,
           batch=None, num_mols: int = 1, box=None, q=None,
           temperature: Optional[float] = None, gamma: float = 0.01,
           rebuild_every: int = 25, skin: float = 1.0, seed: int = 0,
           neighbor_strategy: str = "brute", cells_per_dim=None,
           cell_block_spec=None) -> MDState:
    """Run ``max(n_steps // rebuild_every, 1)`` chunks of MD on the
    potential's device from ``pos`` (JAX ``:709-736``) and return the final
    :class:`MDState`; check ``state.overflow``.  ``num_mols`` must cover
    every real segment of ``batch`` (entries equal to ``num_mols`` are
    ghost atoms)."""
    if batch is None:
        batch = np.zeros(len(z), np.int64)
    init_state, chunk, _ = make_md_step(
        potential, z, batch, masses, dt=dt, num_mols=num_mols, box=box, q=q,
        rebuild_every=rebuild_every, skin=skin, temperature=temperature,
        gamma=gamma, neighbor_strategy=neighbor_strategy,
        cells_per_dim=cells_per_dim, cell_block_spec=cell_block_spec)
    state = init_state(pos, seed=seed)
    for _ in range(max(n_steps // rebuild_every, 1)):
        state = chunk(state)
    if state.pos.is_cuda:
        torch.cuda.synchronize(state.pos.device)
    return state
