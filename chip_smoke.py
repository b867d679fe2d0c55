#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``torchmdnet_tpu_torch/csrc`` with
``nvcc`` (all sources at once), holds each kernel against its plain
PyTorch version on the card at the main path's shapes (N=25,088 atoms,
K=96 slots, F=128 channels, R=32 rbf), then drives the main path:
TensorNet2 (2 layers x 128) + the 10 Å ScalarPlusWeightedCoulomb head on
a 25,088-atom periodic lattice, energy+forces once with the kernels and
once through the plain versions, and a Langevin MD chunk (rebuild every
25 steps, 1 Å skin).  Weights are random, drawn from a seed.

Each phase prints one JSON line; the card's name and power limit (as
``nvidia-smi`` gives them) and a ``{"kernels": [...]}`` line follow, and
the last line is ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero before that line.  All float32 matmuls run in full float32
(TF32 off).  Long logs (compiler output, the profile) go to ``logs/`` in
the checkout, or to the directory named by ``SMOKE_LOG_DIR``.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / os.environ.get("SMOKE_LOG_DIR", "logs")
TOL = 1e-4  # max |kernel − plain| / max |plain|, float32 with reordered sums

N_ATOMS, K, F, R, Q_DIM = 25088, 96, 128, 32, 16
COULOMB_RC = 10.0

# Published peaks, NVIDIA data sheets (dense, no sparsity): float32 outside
# the tensor cores in FLOP/s and device memory in B/s, by board.
PEAKS = {"H100 PCIe": (51.2e12, 2.0e12), "H100 NVL": (60.0e12, 3.9e12),
         "H100": (67.0e12, 3.35e12), "H200": (67.0e12, 4.8e12)}


def emit(obj):
    print(json.dumps(obj), flush=True)


def peaks(name):
    for key in ("H100 PCIe", "H100 NVL", "H200", "H100"):
        if key in name or key.replace(" ", "-") in name:
            return key, PEAKS[key]
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak[0] * 1e3, nbytes / peak[1] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, reps=10, warmup=2):
    """Median device time of ``fn`` over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got, want):
    """(max abs error, max abs error / max |want|)."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------- phase 1
def phase_device():
    from torchmdnet_tpu_torch.ops import edge_mlp, radial_embedding
    from torchmdnet_tpu_torch.ops.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    board, peak = peaks(name)
    t0 = time.perf_counter()
    logs = build([radial_embedding.SOURCE, edge_mlp.SOURCE],
                 extra_flags=("-Xptxas", "-v"))
    secs = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "nvcc.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "kind": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_from": board,
          "peak_fp32_tflops": peak[0] / 1e12, "peak_tb_s": peak[1] / 1e12,
          "tf32": bool(torch.backends.cuda.matmul.allow_tf32
                       or torch.backends.cudnn.allow_tf32),
          "build_s": round(secs, 3), "ptxas": ptxas})
    return smi, name, peak


# ---------------------------------------------------------------- phase 2
def embedding_inputs(gen, dev):
    """Main-path shapes; 60-84 valid slots per row, valid first."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    count = torch.randint(60, 85, (N_ATOMS, 1), generator=gen, device=dev)
    em = (torch.arange(K, device=dev)[None, :] < count).float()
    v = randn(N_ATOMS, K, 3)
    v = v / v.norm(dim=-1, keepdim=True)
    return [rand(N_ATOMS, K, R), rand(N_ATOMS, K) * em,
            v[..., 0].contiguous(), v[..., 1].contiguous(),
            v[..., 2].contiguous(), randn(N_ATOMS, F),
            randn(N_ATOMS, K, F) * em[..., None], em,
            randn(R, 3 * F) / math.sqrt(R), randn(3 * F) * 0.1]


def phase_kernels(peak):
    from torchmdnet_tpu_torch.ops import edge_mlp as em_ops
    from torchmdnet_tpu_torch.ops import radial_embedding as re_ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = {}

    # kernel 1: embedding forward
    x = embedding_inputs(gen, dev)
    valid = float(x[7].sum())
    out_k = re_ops.radial_embedding_fwd_cuda(*x)
    out_p = re_ops.radial_embedding_ref(*x)
    torch.cuda.synchronize()
    err, rel = rel_err(out_k, out_p)
    check(torch.isfinite(out_k).all(), "radial_embedding_fwd: non-finite")
    flops = valid * (2 * R * 3 * F + 23 * F)
    b_ms, b_by = bound(flops, nbytes(*x, out_k), peak)
    rows["radial_embedding_fwd"] = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=time_ms(lambda: re_ops.radial_embedding_fwd_cuda(*x)),
        plain_ms=time_ms(lambda: re_ops.radial_embedding_ref(*x)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, gflop=flops / 1e9,
        gbytes=nbytes(*x, out_k) / 1e9)
    del out_k, out_p

    # kernel 2: embedding backward, without and with dkall/dball
    g = torch.randn((N_ATOMS, 9 * F), generator=gen, device=dev)
    names = ("dea", "dC", "dvx", "dvy", "dvz", "dzw1", "dzw2g", "dkall",
             "dball")
    for want_dk in (False, True):
        needs = [True] * 7 + [False] + [want_dk] * 2
        got = re_ops.radial_embedding_bwd_cuda(x, g, True, want_dk)
        ref = re_ops.radial_embedding_bwd_ref(x, g, needs)
        torch.cuda.synchronize()
        errs = {n: rel_err(a, b) for n, a, b in zip(names, got, ref)
                if b is not None}
        err = max(e[0] for e in errs.values())
        rel = max(e[1] for e in errs.values())
        check(all(torch.isfinite(t).all() for t in got if t is not None),
              "radial_embedding_bwd: non-finite")
        outs = [t for t in got if t is not None]
        flops = valid * ((6 if want_dk else 4) * R * 3 * F + 50 * F)
        b_ms, b_by = bound(flops, nbytes(*x, g, *outs), peak)
        row = dict(
            max_abs_err=err, max_rel_err=rel,
            worst_output=max(errs, key=lambda n: errs[n][1]),
            ms=time_ms(lambda: re_ops.radial_embedding_bwd_cuda(
                x, g, True, want_dk)),
            plain_ms=time_ms(lambda: re_ops.radial_embedding_bwd_ref(
                x, g, needs)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            gflop=flops / 1e9, gbytes=nbytes(*x, g, *outs) / 1e9)
        rows["radial_embedding_bwd" + ("_dkall" if want_dk else "")] = row
        del got, ref
    del x, g

    # kernel 3: edge MLP tail, one of the four calls of an evaluation
    count = torch.randint(60, 85, (N_ATOMS, 1), generator=gen, device=dev)
    mask = (torch.arange(K, device=dev)[None, :] < count).float()
    w = [torch.randn((N_ATOMS, K, F), generator=gen, device=dev),
         torch.rand((N_ATOMS, K), generator=gen, device=dev) * mask,
         (torch.rand((F, 2 * F), generator=gen, device=dev) * 2 - 1)
         / math.sqrt(F),
         (torch.rand(2 * F, generator=gen, device=dev) * 2 - 1) / math.sqrt(F),
         (torch.rand((2 * F, 3 * F), generator=gen, device=dev) * 2 - 1)
         / math.sqrt(2 * F),
         (torch.rand(3 * F, generator=gen, device=dev) * 2 - 1)
         / math.sqrt(2 * F)]
    out_k = em_ops.edge_mlp_pre_cuda(*w)
    out_p = em_ops.edge_mlp_pre_ref(*w)
    torch.cuda.synchronize()
    err, rel = rel_err(out_k, out_p)
    check(torch.isfinite(out_k).all(), "edge_mlp_pre: non-finite")
    valid = float(mask.sum())
    flops = valid * (2 * F * 2 * F + 2 * 2 * F * 3 * F)
    b_ms, b_by = bound(flops, nbytes(*w, out_k), peak)
    plain_ms = time_ms(lambda: em_ops.edge_mlp_pre_ref(*w))
    rows["edge_mlp_pre"] = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=time_ms(lambda: em_ops.edge_mlp_pre_cuda(*w)), plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by,
        # the cuBLAS-backed plain chain is the library yardstick here
        library_ms=time_ms(lambda: em_ops.edge_mlp_pre_ref(*w)),
        gflop=flops / 1e9, gbytes=nbytes(*w, out_k) / 1e9)
    del out_k, out_p, w
    torch.cuda.empty_cache()

    emit({"phase": "kernels", "tolerance": TOL, "rows": rows})
    for name, row in rows.items():
        check(row["max_rel_err"] <= TOL,
              f"{name}: max rel err {row['max_rel_err']:.3g} > {TOL}")
    return rows


def phase_shapes():
    """Every compiled rbf width and a range of channel counts, at small
    ragged sizes: each kernel against its plain version on the card."""
    from torchmdnet_tpu_torch.ops import edge_mlp as em_ops
    from torchmdnet_tpu_torch.ops import radial_embedding as re_ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    worst = {}
    for n, k, r, f in ((37, 13, 8, 64), (50, 20, 16, 256), (33, 7, 32, 32)):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        em = (torch.rand((n, k), generator=gen, device=dev) < 0.7).float()
        v = randn(n, k, 3)
        v = v / v.norm(dim=-1, keepdim=True)
        x = [torch.rand((n, k, r), generator=gen, device=dev), em * 0.5,
             v[..., 0].contiguous(), v[..., 1].contiguous(),
             v[..., 2].contiguous(), randn(n, f), randn(n, k, f),
             em, randn(r, 3 * f) * 0.3, randn(3 * f) * 0.1]
        g = randn(n, 9 * f)
        errs = [rel_err(re_ops.radial_embedding_fwd_cuda(*x),
                        re_ops.radial_embedding_ref(*x))[1]]
        needs = [True] * 7 + [False, True, True]
        got = re_ops.radial_embedding_bwd_cuda(x, g, True, True)
        ref = re_ops.radial_embedding_bwd_ref(x, g, needs)
        errs += [rel_err(a, b)[1] for a, b in zip(got, ref)]
        w = [randn(n, k, f), torch.rand((n, k), generator=gen, device=dev),
             randn(f, 2 * f) * 0.1, randn(2 * f) * 0.1,
             randn(2 * f, 3 * f) * 0.1, randn(3 * f) * 0.1]
        errs.append(rel_err(em_ops.edge_mlp_pre_cuda(*w),
                            em_ops.edge_mlp_pre_ref(*w))[1])
        worst[f"n{n}_k{k}_r{r}_f{f}"] = max(errs)
    torch.cuda.synchronize()
    emit({"phase": "shapes", "max_rel_err": worst, "tolerance": TOL})
    check(max(worst.values()) <= TOL, "a kernel disagrees at a small shape")


# ---------------------------------------------------------------- phase 3
def near_cubic_dims(n):
    best = None
    for nx in range(2, int(round(n ** (1 / 3))) + 9):
        if n % nx:
            continue
        m = n // nx
        for ny in range(2, int(np.sqrt(m)) + 2):
            if m % ny:
                continue
            nz = m // ny
            spread = max(nx, ny, nz) / min(nx, ny, nz)
            if best is None or spread < best[0]:
                best = (spread, (nx, ny, nz))
    return best[1]


def northstar_system(n=N_ATOMS, seed=0):
    """The jittered cubic lattice at liquid density of the JAX package's
    north-star benchmark (``bench.py:254-266``)."""
    rng = np.random.RandomState(seed)
    L = (n / 0.1) ** (1.0 / 3.0)
    dims = near_cubic_dims(n)
    g = (np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij"),
                  -1).reshape(-1, 3)[:n] + 0.5)
    a = L / np.array(dims, np.float64)
    pos = (g * a + rng.uniform(-0.3 * a.min(), 0.3 * a.min(), (n, 3))
           ).astype(np.float32)
    z = rng.choice([1, 1, 6, 7, 8], n).astype(np.int64)
    masses = np.where(z == 1, 1.008, 12.011).astype(np.float64)
    box = np.diag([L, L, L]).astype(np.float32)
    return z, pos, masses, box, L


def northstar_args(L):
    """``bench.py::bench_northstar`` args (``:270-286``) on the gather
    path: no cell_block_spec, remat off."""
    from torchmdnet_tpu_torch.ops.neighbors import pick_cell_grid

    cd, cs, cc = pick_cell_grid([L] * 3, COULOMB_RC, N_ATOMS)
    return dict(
        model="tensornet2", embedding_dimension=F, num_layers=2,
        num_rbf=R, rbf_type="expnorm", trainable_rbf=False,
        activation="silu", cutoff_lower=0.0, cutoff_upper=4.5, max_z=128,
        max_num_neighbors=K, derivative=True, prior_model=None,
        reduce_op="sum", precision=32,
        equivariance_invariance_group="O(3)", atom_filter=-1,
        remat=False, pallas_embedding=True, pallas_edge_mlp=True,
        q_dim=Q_DIM, output_model="ScalarPlusWeightedCoulomb",
        q_weights=[[1.0] * Q_DIM] * 3, coulomb_cutoff=COULOMB_RC,
        coulomb_neighbor_strategy="cell", coulomb_cells_per_dim=list(cd),
        coulomb_cell_stencil=cs, coulomb_cell_capacity=cc)


def phase_small():
    """Kernels on the card against the plain versions on the CPU, at a
    small size whose edge counts are not tile multiples."""
    from torchmdnet_tpu_torch.models.model import create_model

    args = dict(northstar_args(40.0), embedding_dimension=32, num_rbf=16,
                max_num_neighbors=48, q_dim=4, q_weights=[[1.0] * 4] * 3,
                coulomb_cutoff=5.0, coulomb_neighbor_strategy="brute")
    rng = np.random.RandomState(3)
    g = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"),
                 -1).reshape(-1, 3) + 0.5  # 125 atoms x 48 slots: ragged
    pos = (g * 2.6 + rng.uniform(-0.4, 0.4, g.shape)).astype(np.float32)
    z = rng.choice([1, 1, 6, 7, 8], len(pos))
    box = np.diag([13.0] * 3).astype(np.float32)
    gpu = create_model(args, device="cuda", seed=5)
    cpu = create_model(args, device="cpu", seed=5)
    y_g, f_g = gpu.apply(z, pos, None, num_mols=1, box=box)
    y_c, f_c = cpu.apply(z, pos, None, num_mols=1, box=box)
    e_err = abs(float(y_g.cpu()) - float(y_c)) / max(abs(float(y_c)), 1e-30)
    _, f_rel = rel_err(f_g.cpu(), f_c)
    emit({"phase": "small_vs_cpu", "atoms": len(z), "energy": float(y_c),
          "energy_rel_err": e_err, "force_rel_err": f_rel,
          "tolerance": TOL})
    check(e_err <= TOL and f_rel <= TOL, "small system: GPU vs CPU mismatch")


def phase_energy(system):
    from torchmdnet_tpu_torch.models.model import create_model
    from torchmdnet_tpu_torch.ops.neighbors import build_neighbor_matrix

    z, pos, masses, box, L = system
    dev = torch.device("cuda")
    args = northstar_args(L)
    pot = create_model(args, device=dev, seed=0)
    zt = torch.as_tensor(z, device=dev)
    pt = torch.as_tensor(pos, device=dev)
    bt = torch.as_tensor(box, device=dev)
    batch = torch.zeros(len(z), dtype=torch.long, device=dev)
    q = torch.zeros(1, device=dev)

    def lists():
        nbr = build_neighbor_matrix(
            pt, batch, strategy="cell", k_max=K, cutoff_upper=4.5, loop=True,
            box=bt, cells_per_dim=tuple(max(int(L // 4.5), 3)
                                        for _ in range(3)))
        cnbr = pot.module.output_model.build_coulomb_neighbors(pt, batch, bt,
                                                               1)
        return nbr, cnbr

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbr, cnbr = lists()
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    check(not bool(nbr.overflow) and not bool(cnbr.overflow),
          "neighbor list overflow")

    def run(p):
        return p.apply(zt, pt, batch, num_mols=1, box=bt, q=q, nbr=nbr,
                       coulomb_nbr=cnbr)

    torch.cuda.reset_peak_memory_stats()
    y_k, f_k = run(pot)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(pot)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak_k = torch.cuda.max_memory_allocated()

    plain = create_model(dict(args, pallas_embedding=False,
                              pallas_edge_mlp=False), device=dev, seed=0)
    plain.module.load_state_dict(pot.module.state_dict())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    y_p, f_p = run(plain)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    peak_p = torch.cuda.max_memory_allocated()

    check(y_k.shape == (1, 1) and f_k.shape == (N_ATOMS, 3), "bad shapes")
    check(torch.isfinite(y_k).all() and torch.isfinite(f_k).all(),
          "non-finite energy or forces")
    e_err = abs(float(y_k) - float(y_p)) / max(abs(float(y_p)), 1e-30)
    f_abs, f_rel = rel_err(f_k, f_p)
    emit({"phase": "energy_forces", "atoms": N_ATOMS, "energy": float(y_k),
          "energy_plain": float(y_p), "energy_rel_err": e_err,
          "force_max_abs_err": f_abs, "force_rel_err": f_rel,
          "max_abs_force": float(f_p.abs().max()), "tolerance": TOL,
          "list_build_ms": build_ms, "ms_per_eval": statistics.median(times),
          "ms_per_eval_all": times, "plain_ms_per_eval": plain_ms,
          "peak_mem_gb": peak_k / 1e9, "plain_peak_mem_gb": peak_p / 1e9,
          "model_slots_valid": float(nbr.mask.float().mean()),
          "coulomb_k": int(cnbr.idx.shape[1])})
    check(e_err <= TOL, f"energy: kernels vs plain rel err {e_err:.3g}")
    check(f_rel <= TOL, f"forces: kernels vs plain rel err {f_rel:.3g}")
    del plain, y_p, f_p
    torch.cuda.empty_cache()
    return pot, nbr, cnbr, run


def phase_profile(pot, run):
    """Device time by kernel over one energy+forces evaluation, and the
    device's idle share of the (profiled) wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(pot)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_ms(e):  # the attribute was renamed from cuda to device
        t = getattr(e, "self_device_time_total", None)
        return (t if t is not None else e.self_cuda_time_total) / 1e3

    # device-side events only: a host op's self device time repeats its
    # kernels' time
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and dev_ms(e) > 0),
                     key=lambda e: -dev_ms(e))
    total = sum(dev_ms(e) for e in kernels)
    groups = {}
    for e in kernels:
        name = e.key
        group = next((g for g, keys in PROFILE_GROUPS if any(
            k in name for k in keys)), "elementwise and other")
        groups[group] = groups.get(group, 0.0) + dev_ms(e)
    (OUT_DIR / "profile_eval.txt").write_text("\n".join(
        f"{dev_ms(e):12.3f} ms {e.count:6d} calls  {e.key}" for e in kernels))
    emit({"phase": "profile_eval", "wall_ms": wall_ms,
          "device_ms": total, "idle_share": max(0.0, 1 - total / wall_ms),
          "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
          "top": [{"name": e.key[:80], "ms": dev_ms(e), "calls": e.count}
                  for e in kernels[:10]]})


PROFILE_GROUPS = (
    ("kernel 3 edge_mlp_pre", ("edge_mlp_pre_kernel",)),
    ("kernel 2 embedding bwd", ("emb_bwd_kernel", "sum_partials_kernel")),
    ("kernel 1 embedding fwd", ("emb_fwd_kernel",)),
    ("cuBLAS matmul", ("gemm", "sgemm")),
    ("gather", ("gather", "index_elementwise", "index_kernel")),
    ("scatter (index backward, index_add)", ("indexing_backward",
                                             "indexFunc")),
    ("reductions", ("reduce_kernel",)),
)


# ---------------------------------------------------------------- phase 4
def phase_md(pot, system):
    from torchmdnet_tpu_torch.md.integrators import (
        KB_EV, kinetic_energy, make_md_step)

    z, pos, masses, box, _ = system
    init_state, chunk, _ = make_md_step(
        pot, z, np.zeros(len(z)), masses, dt=0.05, num_mols=1, box=box,
        q=torch.zeros(1, device="cuda"), rebuild_every=25, skin=1.0,
        temperature=300.0, neighbor_strategy="cell")
    t0 = time.perf_counter()
    st = init_state(pos, seed=1)
    st = chunk(st)  # warm-up chunk
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    e_warm = float(st.energy)
    t0 = time.perf_counter()
    st = chunk(st)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 25
    ok = (not bool(st.overflow) and bool(torch.isfinite(st.pos).all())
          and bool(torch.isfinite(st.energy).all())
          and bool(torch.isfinite(st.force).all()))
    m = torch.as_tensor(masses, dtype=torch.float32, device=st.vel.device)
    temp_k = float(2.0 * kinetic_energy(st.vel, m) / (3.0 * len(z) * KB_EV))
    emit({"phase": "md", "steps": st.step, "rebuild_every": 25,
          "kinetic_temperature_k": temp_k,
          "ms_per_step": ms, "warmup_chunk_s": warm_s,
          "energy_after_warmup": e_warm, "energy_final": float(st.energy),
          "overflow": bool(st.overflow), "finite": ok,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(ok, "MD: overflow or non-finite state")
    return st.step


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from torchmdnet_tpu_torch.ops import edge_mlp, radial_embedding
    from torchmdnet_tpu_torch.ops.config import set_matmul_precision

    set_matmul_precision("highest")
    smi, name, peak = phase_device()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 must be off")
    rows = phase_kernels(peak)
    phase_shapes()
    phase_small()
    system = northstar_system()
    pot, nbr, cnbr, run = phase_energy(system)
    phase_profile(pot, run)
    del nbr, cnbr
    torch.cuda.empty_cache()

    counted = {"radial_embedding_fwd": radial_embedding.FORWARD,
               "radial_embedding_bwd": radial_embedding.BACKWARD,
               "edge_mlp_pre": edge_mlp.FORWARD}
    for kern in counted.values():
        kern.launches = 0
    steps = phase_md(pot, system)
    launches = {k: kern.launches for k, kern in counted.items()}
    emit({"phase": "launches", "md_steps": steps, "launches": launches,
          "per_step": {k: v / steps for k, v in launches.items()}})
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")

    sources = {"radial_embedding_fwd": ("torchmdnet_tpu_torch/csrc/"
                                        "radial_embedding.cu",
                                        "torchmdnet_tpu/ops/"
                                        "pallas_embedding.py:80"),
               "radial_embedding_bwd": ("torchmdnet_tpu_torch/csrc/"
                                        "radial_embedding.cu",
                                        "torchmdnet_tpu/ops/"
                                        "pallas_embedding.py:178"),
               "edge_mlp_pre": ("torchmdnet_tpu_torch/csrc/edge_mlp.cu",
                                "torchmdnet_tpu/ops/pallas_kernels.py:182")}
    kernels = []
    for k, (src, tpu) in sources.items():
        row = rows[k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[k], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # report the failed phase; never exit 0 after it
        traceback.print_exc()
        code = 1
    sys.exit(code)
