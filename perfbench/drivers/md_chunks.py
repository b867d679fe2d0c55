"""Condensed-phase MD: back-to-back chunks of the program's
``make_md_step`` (one neighbour rebuild and ``rebuild_every`` Langevin
velocity-Verlet steps each) on a periodic system made from the seed.

Set-up makes the system and the weights, builds the potential on the
configuration's path, runs ``init_state`` and ``warmup_chunks`` chunks.
The window runs chunks until ``seconds`` have passed (the last one runs
to its end), and ``md_steps_per_s`` is the steps over the window's time,
rebuilds included, ending at a device sync.  A chunk whose rebuild
overflowed a neighbour list, or whose energy is not finite, counts its
steps in ``failed``.

The check, once the window has closed and the program's state is freed:

- ``force_err``, ``energy_err``: the forces and energy that the last step
  of the window produced, at the positions it produced, against the
  reference at those positions (the widest force gap over the largest
  reference force; the energy's gap over the reference's sum of
  ``|per-atom energy|``, since a random-weight box's energy may lie near
  0).  A list that missed a pair within the cutoff, a wrong head or a
  wrong force pass shows here.
- ``motion_err``: whether the atoms moved as their velocities say.  Over
  every chunk of the window the displacement is held against the
  trapezoid ``T (v_start + v_end) / 2`` of the chunk's time ``T``:
  ``|D - T (v_s + v_e) / 2| / |T (v_s + v_e) / 2|`` over all atoms and
  chunks.  A step that returns its state unchanged (or moves it twice)
  reads about 1; the thermostat's noise leaves a few % in a sound run.
"""

import gc
import sys
import time

import numpy as np
import torch

from perfbench import systems
from perfbench.harness import Outcome, device_peaks, gap, memory_peak, sync
from perfbench.readers import Span
from perfbench.reference import tensornet2 as ref
from perfbench.trace import capture
from perfbench.work.pairs import geometry


class System:
    """The traffic's periodic system and the weights, made from the seed."""

    def __init__(self, cell, seed, device):
        t = cell.traffic
        self.cfg = cell.config["model"]
        self.z, self.pos, self.masses, self.length = systems.jittered_lattice(
            seed, t["atoms"], t["density"], t["elements"], t["jitter"])
        self.weights = ref.make_weights(self.cfg, seed, device)
        self.device = device


def build_chunk(cell, system, seed):
    """The program's ``(state, chunk)`` after ``init_state`` on the
    configuration's path."""
    from torchmdnet_tpu_torch.md.integrators import make_md_step
    from torchmdnet_tpu_torch.models.model import create_model
    from torchmdnet_tpu_torch.ops.cell_blocks import (
        tune_cell_block_spec, tune_stencil_window_spec)

    t, cfg, path = cell.traffic, system.cfg, cell.config["path"]
    dev = system.device
    box3 = [system.length] * 3
    spec = tune_cell_block_spec(system.pos, box3,
                                cfg["cutoff_upper"] + t["skin"],
                                cap=path["block_rows"])
    pot = create_model(dict(cfg, cell_block_spec=spec), device=dev)
    pot.module.load_state_dict(system.weights)
    wspec = tune_stencil_window_spec(system.pos, box3, spec,
                                     cfg["coulomb_cutoff"] + t["skin"])
    init_state, chunk, _ = make_md_step(
        pot, system.z, np.zeros(len(system.z), np.int64), system.masses,
        dt=t["dt_fs"], num_mols=1, box=np.diag(box3).astype(np.float32),
        q=torch.zeros(1, device=dev), rebuild_every=t["rebuild_every"],
        skin=t["skin"], temperature=t["temperature_k"],
        gamma=t["gamma_per_fs"], neighbor_strategy="cell",
        cell_block_spec=spec, coulomb_window_spec=wspec)
    return init_state(system.pos, seed=seed), chunk


def motion_err(pos, vel, chunk_fs):
    """The displacement of every chunk against its velocities' trapezoid
    (module docstring), from the states at the chunk boundaries."""
    pos, vel = torch.stack(pos).double(), torch.stack(vel).double()
    moved = pos[1:] - pos[:-1]
    trapezoid = 0.5 * chunk_fs * (vel[1:] + vel[:-1])
    return float((moved - trapezoid).norm() / trapezoid.norm())


def run(cell, seed, seconds, trace, t_start, device):
    t = cell.traffic
    out = Outcome()
    marks = [("start", time.perf_counter() - t_start)]
    system = System(cell, seed, device)
    marks.append(("inputs and weights", time.perf_counter() - t_start))
    st, chunk = build_chunk(cell, system, seed)
    sync(device)
    marks.append(("spec, model, init_state", time.perf_counter() - t_start))
    for _ in range(t["warmup_chunks"]):
        st = chunk(st)
    sync(device)
    out.metrics["setup_s"] = time.perf_counter() - t_start
    marks.append(("warm-up", out.metrics["setup_s"]))
    print("set-up s: " + ", ".join(f"{k} {v:.2f}" for k, v in marks),
          file=sys.stderr)

    if trace:
        span_pos = st.pos.clone()

        def span():
            nonlocal st
            with torch.profiler.record_function("md.rebuild"):
                nxt = chunk.rebuild(st)
            with torch.profiler.record_function("md.steps"):
                st = chunk.steps(nxt)

        out.span = Span(capture(torch, span), system.cfg, None,
                        evaluations=t["rebuild_every"],
                        units=t["rebuild_every"],
                        peak=device_peaks(device))

    # the window: chunks back to back; the host waits for chunk c - 1
    # while chunk c runs, so the queue never runs ahead by more than one
    sync(device)
    first_step = st.step
    pos, vel, flags, done = [st.pos.clone()], [st.vel.clone()], [], []
    t0 = time.perf_counter()
    while True:
        st = chunk(st)
        pos.append(st.pos.clone())
        vel.append(st.vel.clone())
        flags.append(st.overflow | ~torch.isfinite(st.energy).all())
        if device.type == "cuda":
            done.append(torch.cuda.Event())
            done[-1].record()
            if len(done) > 1:
                done[-2].synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    steps = st.step - first_step
    bad = torch.stack(flags).cpu()
    out.metrics["md_steps_per_s"] = steps / elapsed
    out.attempted = steps
    out.failed = int(bad.sum()) * t["rebuild_every"]
    out.memory_peak = memory_peak(device)
    if trace:
        # the work the span's inputs asked for, counted once the
        # program's peak is read
        out.span.geom = geometry(
            system.cfg, span_pos,
            torch.zeros(len(system.z), dtype=torch.long, device=device),
            torch.full((3,), system.length, device=device))

    # the check, on the program's last state, with its objects freed
    final = (st.pos.detach().clone(), st.force.detach().clone(),
             st.energy.detach().clone())
    motion = motion_err(pos, vel, t["rebuild_every"] * t["dt_fs"])
    report(system, pos, vel, t)
    del st, chunk, pos, vel
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    out.checks = compare(cell, system, *final) + [
        ("motion_err", motion, cell.limits["motion_err"])]
    print(f"reference_s {time.perf_counter() - t_ref:.3f}", file=sys.stderr)
    return out


def report(system, pos, vel, t):
    """The window's kinetic temperature at its ends and the largest move
    of an atom in one chunk, against half the skin (standard error)."""
    m = torch.as_tensor(system.masses, dtype=torch.float64,
                        device=pos[0].device)[:, None]
    # (A/fs)^2 amu -> eV: 1 / 9.648533212331024e-3; k_B in eV/K
    temp = [float((m * v.double() ** 2).sum() / 9.648533212331024e-3
                  / (3 * len(m) * 8.617333262e-5)) for v in (vel[0], vel[-1])]
    move = max(float((b - a).norm(dim=1).max()) for a, b in zip(pos, pos[1:]))
    box = torch.full((3,), system.length, device=pos[-1].device)
    most = most_within(pos[-1], box, system.cfg["cutoff_upper"] + t["skin"])
    print(f"window temperature_k {temp[0]:.1f} -> {temp[1]:.1f}; largest "
          f"move in a chunk {move:.4f} A (half the skin {t['skin'] / 2}); "
          f"most atoms within cutoff + skin {most} (K "
          f"{system.cfg['max_num_neighbors']})", file=sys.stderr)


@torch.no_grad()
def most_within(pos, box, cutoff, rows=1024):
    """The most atoms (itself included) any atom has within ``cutoff``."""
    most = 0
    for s in range(0, len(pos), rows):
        d = pos[s:s + rows, None] - pos[None]
        d = d - torch.round(d / box) * box
        most = max(most, int(((d * d).sum(-1) < cutoff * cutoff).sum(1).max()))
    return most


def control(cell, seed, device):
    """The control's readings at a state of the program after the
    warm-up: the reference in TF32 in the program's place."""
    system = System(cell, seed, device)
    st, chunk = build_chunk(cell, system, seed)
    for _ in range(cell.traffic["warmup_chunks"]):
        st = chunk(st)
    pos = st.pos.detach().clone()
    del st, chunk
    gc.collect()
    z = torch.as_tensor(system.z, device=device)
    batch = torch.zeros(len(z), dtype=torch.long, device=device)
    box = torch.full((3,), system.length, device=device)
    with ref.precision(True):
        e_low, f_low, _ = ref.energy_forces(
            system.weights, system.cfg, z, pos, batch,
            torch.zeros(1, device=device), 1, box=box)
    return compare(cell, system, pos, f_low, e_low)


def compare(cell, system, pos, force, energy):
    """``[(name, value, limit)]`` of the program's forces and energy at
    ``pos`` against the reference's there."""
    dev = system.device
    z = torch.as_tensor(system.z, device=dev)
    batch = torch.zeros(len(z), dtype=torch.long, device=dev)
    box = torch.full((3,), system.length, device=dev)
    with ref.precision(False):
        e_ref, f_ref, scale = ref.energy_forces(
            system.weights, system.cfg, z, pos, batch,
            torch.zeros(1, device=dev), 1, box=box)
    return [("force_err", gap(force, f_ref), cell.limits["force_err"]),
            ("energy_err", gap(energy.flatten(), e_ref, scale),
             cell.limits["energy_err"])]
