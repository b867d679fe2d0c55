#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``torchmdnet_tpu_torch/csrc`` with
``nvcc`` (one process per source, all at once) and holds each kernel
against its plain PyTorch version on the card at the main paths' shapes:
the embedding kernels at N=25,088 atoms, K=96 slots, F=128 channels, R=32
rbf (kernel 2 in its three forms: the main path's, with dzw1/dzw2g and
with dkall/dball too), held to 1e-5 of max |plain| per output; TensorNet2's edge-MLP tail (kernel 3) on the slot weights of the
same lattice's gather MD list (K=96 at 4.5 + 1 Å) and with every slot
live; the q-tier kernels A/B at the 27,024 cell-blocked
rows of the same lattice with T=64 series terms, and again with the exact
rbf base (R=32) and on the grouped tier's column-partitioned K′ list of
that lattice (rows 12-13 in their four bodies); the windowed-Coulomb
kernels C/D at 48 charge channels over the lattice's real stencil
windows, held to 1e-5 of max |plain| per output; TensorNet's fused edge MLP (kernel 4) and Chebyshev filters
(kernels 5 and 7) on the real brute K=64 list of the dhfr system (2,489
atoms in 2,560 rows, T=128); TensorNet's blocked message passing (rows
8-11) on the dhfr system's cell-blocked sort (3,136 rows of 16-row blocks)
with the grouped K′=224 list and the brute K=64 list, and kernel 4 on the
grouped list too (kernel 4 and rows 8 and 9 held to 1e-5 of max |plain|
per output, their dead slots and empty rows exact zeros); the coefficient
gradient of the Chebyshev filters (row 6) on the brute K=40 list of
``bench.py::bench_train``'s training batch (1,664 rows, T=128), beside
the plain version's float64 error and bitwise equal across two calls.  Then it
drives both
paths of the port on the north star, TensorNet2 (2 layers x 128) + the
10 Å ScalarPlusWeightedCoulomb head on the 25,088-atom periodic lattice,
weights random from a seed:

- the gather path (no cell_block_spec, Coulomb list): energy+forces with
  the kernels and through the plain versions, a profile, and a short MD
  run (a 5-step chunk timed after a 5-step warm-up chunk);
- the blocked path (the JAX north-star default: cell-blocked q-tier and
  windowed Coulomb): energy+forces with the kernels and through the plain
  versions, against the gather path, with TF32 allowed (a record), a
  profile, and a Langevin MD chunk (rebuild every 25 steps, 1 Å skin)
  timed after a warm-up chunk;
- its other q-tiers on the same weights: the grouped tier
  (``BENCH_MD_GROUPED=1``: the column-partitioned K′ list for the
  interactions, the compact K list for the embedding) and ``q_tab=0``
  (the exact rbf operand) on the ungrouped spec, each with the kernels
  and through the plain versions, against the blocked path, with a
  warm-up and a timed 25-step MD chunk (and a profile of the grouped
  tier), and ``q_tab=0`` on the grouped spec (no dual list: the
  embedding on K′), one evaluation;

and the dhfr path of ``bench.py::main``, TensorNet (2 layers x 128, 32
expnorm rbf, 4.5 Å, K=64 brute neighbors rebuilt every evaluation, the
Scalar head) on its 2,489-atom periodic system, in the default variant
(tabulated filters, T=128) and the exact one (fused edge MLP and
embedding): energy+forces with the kernels and through the plain
versions, tabulated against exact, ms per evaluation of the bench chain
(positions fed back as pos + 1e-24·F, 30 evaluations after a warm-up),
the forces with TF32 allowed (a record), a profile of each, and a Langevin MD chunk (brute lists rebuilt every 25
steps, 1 Å skin, K=128) timed after a warm-up chunk; and its cell-blocked
tiers (``BENCH_BLOCKED=1``): each evaluation sorts the atoms into cell
blocks, builds the sorted-space list (grouped: column-partitioned with the
tuned per-column budgets; ungrouped: brute K=64) and evaluates with
``blocked=True``, in four variants (tabulated grouped, the bench default;
tabulated ungrouped; exact grouped; exact ungrouped) against their plain
versions and the gather path, the kernels each launches (kernel 4 and
rows 8-9 for the exact ones, rows 10-11 for the tabulated ones), ms per
evaluation of the bench chain alternated with the gather chain, profiles
of the tabulated and the exact grouped tier, and a Langevin MD chunk on a
grouped spec tuned
at 4.5 + 1 Å for the tabulated and the exact variant; and training,
``bench.py::bench_train``'s TensorNet (2 layers x 128, 5 Å, K=40, the
Scalar head) on its batch of 64 molecules of 24 atoms, energy+force MSE
and AdamW at lr 1e-4, tabulated (T=128: rows 5, 6 and 7 in the forward,
the force pass and the parameter gradient) and exact: one step's loss and
weight gradients with the kernels against the plain versions, 20 timed
steps on the fixed batch after two (the loss must fall), launches per
step, mol/s, peak memory and a profiled step; then ``Trainer.fit`` for 2
epochs on 384 synthetic QM9-scale molecules in batches of 64 and
``Trainer.test``, with its ``metrics.csv`` columns and its checkpoints
checked and reloaded on the card.

It also holds the edge geometry's position gather (phase ``pair_deltas``,
after the kernels): ∂pos through ``gather_pair_deltas`` (a row sum minus
a reverse gather) against plain indexing (an atomic scatter) on the
lattice's K=96 and grouped K′=320 sorted lists, held to 1e-5 of max
|plain|, and the charge equilibration's per-molecule gather through
``index_select`` against plain indexing, held to 1e-4, with the device
time of each backward; and it drives the rest
of the port's entry points: the priors (``priors``: the dhfr tabulated
model with ZBL, D2 and Atomref, and the training batch's model with the
Coulomb prior on seeded partial charges, each against the same model
and weights on the CPU, with ms per evaluation with and without them)
and the adaptive MD (``md_adaptive``: a dhfr grouped spec whose densest
column is packed past its budget re-specs, its forces against the gather
path, a timed 25-step chunk; then ``run_md`` for 25 steps on the dhfr
brute path); and serving (``serve``, last): the AceFF recipe
(``examples/TensorNet2-AceFF.yaml``: TensorNet2 2 x 128 with the
all-to-all Coulomb head) written by ``save_checkpoint`` and read by
``load_model(..., pallas_embedding=True, pallas_edge_mlp=True)`` (kernels
1, 2 and 3), energies and forces of 16 and of 128 seeded molecules
against the plain versions on the CPU and against the writing potential,
with ms per evaluation, peak memory, profiles of both batches (their
device ms) and of the 128 batch's all-to-all term; the old AceFF layout of the same
weights, a zip of 3 checkpoints as an ``Ensemble``, and TensorNet 2 x 128
with the ``DipoleMoment`` head and with ``atom_filter``, card against CPU.
After the AceFF training (``train_aceff``) come the models with no
kernel, in plain PyTorch: the Equivariant Transformer's recipes
(``et_serve``: ``examples/ET-SPICE.yaml``, ET 5 x 128 at 10 Å and K=128,
through ``save_checkpoint`` and ``load_model`` on 16 seeded SPICE-like
molecules, energies and forces against float64 on the card, ms, peak and
a profile, ``profile_et_spice``; then ``examples/ET-QM9.yaml``, ET 8 x
256 with the Atomref prior, on 128 QM9-sized molecules; ``et_train``:
``examples/ET-MD17.yaml`` trained on batches of 8 aspirin-shaped
molecules, its gradients against float64, timed steps, ``Trainer.fit``
and its checkpoint served; ``et_md``: ``run_md`` on one such molecule at
300 K), and TorchMD-T and TorchMD-GN at upstream's defaults (``t_gn``).
Last, ``data_cli``: ``examples/TensorNet-rMD17.yaml`` (TensorNet 2 x 128)
trained through the CLI (``train.main``) from an rMD17-format file of
100,000 seeded aspirin frames, processed into memory-mapped files and
packed by the native packer, with kernels 1, 2 and 4 in the force pass;
its restart from a checkpoint; ms a step and mol/s fed by the
memory-mapped loader and by an in-memory dataset of the same frames; and
kernels 1-4 at F = 30, R = 50 (widths they run padded to multiples of 4)
against their plain versions, extra forms on the ``kernels`` line.
Before it, ``adapters``: the TorchMD ``External`` calculator on 16
replicas of one seeded AceFF molecule (phase ``serve``'s seed-0
checkpoint), eager and captured into a CUDA graph (the graph against
eager to 1e-5, the card against the CPU to 1e-4, ms a call both ways,
the kernels' launches a capture), ``optimize`` on the dhfr system
(TensorNet exact, kernels 1, 2 and 4) rebuilding its lists every call
and every 25 calls at a 1 Å skin (each graphed; against a direct
``Potential.apply`` to 1e-5, ms a call), and the AceFF potential
exported with ``torch.export`` at 16 molecules and loaded back (against
the direct call to 1e-5, the kernels it launches, ms a call); then
``data_parallel``: a world of 1 over NCCL steps AceFF through
``make_data_parallel_train_step`` to the single-device step's weights
(1e-6), and ``Trainer`` with ``ngpus=2`` trains on this one card.

Before the kernels phase, ``tc_attributes`` gives the tensor-core kernels
(rows 1, 2, 3, 5, 7, 10, 11 and kernels A-D) as compiled: registers, spill bytes,
shared memory and blocks an SM; the kernels phase also holds rows 5 and 7
against float64, and reads the device time (no host time) of each kernel
that has a library yardstick and of that yardstick, and of the q-tier
and windowed-Coulomb kernels.
Each phase prints one JSON line; the card's name and power limit (as
``nvidia-smi`` gives them) and a ``{"kernels": [...]}`` line follow, and
the last line is ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero before that line.  All float32 matmuls run in full float32
(TF32 off) but in the TF32 records.  Long logs (compiler output, the profiles) go to ``logs/`` in
the checkout, or to the directory named by ``SMOKE_LOG_DIR``.
"""

import contextlib
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / os.environ.get("SMOKE_LOG_DIR", "logs")
TOL = 1e-4  # max |kernel − plain| / max |plain|, float32 with reordered sums
# kernels 5 and 7 (cheb_filter, cheb_filter_dot), max |kernel − plain| /
# max |plain|: their 3xTF32 product with each stage summed in fp32 reads
# 0.7-1.4e-6 on an H100, the same product summed on the tensor cores read
# 2.1-2.4e-6, and single-pass TF32 reads ~1e-3
CHEB_TOL = 2e-6
# kernels 3 and 4 (edge_mlp_pre, edge_mlp), max |kernel − plain| / max
# |plain|: two (kernel 4: three) 3xTF32 products summed on the tensor cores
# over K = F and K = 2F (and R), each through a silu; the limit leaves room
# for the tensor cores' own accumulation (~2e-6 of a product's max at K =
# 128, rows 5 and 10)
EDGE_TOL = 1e-5
# rows 8 and 9 (blocked_mp_sum, blocked_mp_dattr), max |kernel − plain| /
# max |plain| per output: fp32 sums of a row's valid slots' products in
# slot order (row 9: of a slot's irreps), another order than the plain
# chain's
SUM_TOL = 1e-5
# kernels A and B (blocked_q_*, both bases and layouts), max |kernel −
# plain| / max |plain| per output (out, du, dd or drbf, dcw): up to five
# 3xTF32 products chained through silu and dsilu, the same product family
# as kernel 3
DQ_TOL = 1e-5
# kernels 1 and 2 (radial_embedding_*, every backward form), max |kernel −
# plain| / max |plain| per output: 3xTF32 products (ea·kall, dd·kallᵀ and
# for dkall eaᵀ·dd) summed on the tensor cores over K = R, 3F and 64
# slots, then fp32 sums over slots and channels in another order than the
# plain chain's
EMB_TOL = 1e-5
# kernels C and D (windowed_coulomb_*), max |kernel − plain| / max |plain|
# per output (Φ; dpos and S2): 3xTF32 products on the tensor cores (Φ,
# S2 over a block's window rows, pd over the channels), then fp32 sums
# over warps and, for dpos, over the pairs, in another order than the
# plain chain's
WC_TOL = 1e-5
# blocked against gather path forces, relative to max |F|: the q_tab
# series approximation of the edge-MLP base is the difference.  Two runs
# on an H100 read 3.3e-6 and 2.5e-6; the limit leaves 30x room for the
# reordered sums and stays 10x inside the 1e-3 the series is held to.
BLOCKED_VS_GATHER_TOL = 1e-4
# ∂pos through gather_pair_deltas (the reverse gather) against plain
# indexing (its atomic scatter), relative to max |plain|: the same fp32
# sums of a row's ~96 slots in another order (2.2e-7 on an H100).  The
# charge equilibration's gather sums 27,024 atoms a molecule in two
# orders and is held to TOL (5.9e-6 and 7.0e-6 on an H100)
PAIR_TOL = 1e-5

N_ATOMS, K, F, R, Q_DIM = 25088, 96, 128, 32, 16
COULOMB_RC, SKIN, CAP, Q_TAB, C_CH = 10.0, 1.0, 16, 64, 48
# the dhfr path (bench.py::main): atoms, rows, slots, series terms, timed
# evaluations of the bench chain, and the MD list's slots at 4.5 + 1 Å
DHFR_ATOMS, DHFR_PAD, DHFR_K, DHFR_T, DHFR_ITERS = 2489, 2560, 64, 128, 30
DHFR_MD_K = 128
# the dhfr blocked tiers (bench.py:104-117): 16-row blocks, grouped spec
DHFR_CAP = 16
# the training path (bench.py::bench_train): molecules of 24 atoms in a
# batch, their rows, brute slots, series terms (BENCH_TRAIN_TAB=128) and
# timed train steps after two warm-up steps
TRAIN_MOLS, TRAIN_APM, TRAIN_ROWS, TRAIN_K, TRAIN_T = 64, 24, 1664, 40, 128
TRAIN_STEPS, TRAIN_LR, TRAIN_CUTOFF = 20, 1e-4, 5.0
# tabulated against exact TensorNet forces, relative to max |F|: T = 128
# fits the exact edge MLP to ~3e-6 relative (the JAX package's reading,
# torchmdnet_tpu/models/tensornet.py:475-478); the limit leaves 30x room
TAB_VS_EXACT_TOL = 1e-4
# the Chebyshev sweep (cheb_seed_errors): kernels 5 and 7 on every case of
# dhfr_shape_errors, drawn from the generators of CHEB_SEED0 + each seed,
# each draw held to CHEB_TOL against the plain version, and each case's
# worst error against float64 to CHEB_F64_RATIO times the plain
# version's: the kernel no farther from the exact function than float32's
# own chain (the two read within 1.11x of each other over 8 seeds, my
# chip run 6, PR 21)
CHEB_SEEDS, CHEB_SEED0, CHEB_F64_RATIO = tuple(range(8)), 7000, 1.5

# Published peaks, NVIDIA data sheets (dense, no sparsity): float32 outside
# the tensor cores in FLOP/s, device memory in B/s and TF32 on the tensor
# cores in FLOP/s, by board.
PEAKS = {"H100 PCIe": (51.2e12, 2.0e12, 378e12),
         "H100 NVL": (60.0e12, 3.9e12, 417.5e12),
         "H100": (67.0e12, 3.35e12, 495e12),
         "H200": (67.0e12, 4.8e12, 495e12)}

SRC = "torchmdnet_tpu_torch/csrc/"
# kernel name → (source, TPU kernel it replaces, path whose MD run counts it)
KERNELS = {
    "radial_embedding_fwd": (SRC + "radial_embedding.cu",
                             "torchmdnet_tpu/ops/pallas_embedding.py:80",
                             "blocked"),
    "radial_embedding_bwd": (SRC + "radial_embedding.cu",
                             "torchmdnet_tpu/ops/pallas_embedding.py:178",
                             "blocked"),
    "edge_mlp_pre": (SRC + "edge_mlp.cu",
                     "torchmdnet_tpu/ops/pallas_kernels.py:182", "gather"),
    "blocked_q_fwd": (SRC + "blocked_q.cu",
                      "torchmdnet_tpu/ops/pallas_blocked_mp.py:1211",
                      "blocked"),
    "blocked_q_fwd_du": (SRC + "blocked_q.cu",
                         "torchmdnet_tpu/ops/pallas_blocked_mp.py:1211",
                         "blocked"),
    "blocked_q_dq": (SRC + "blocked_q.cu",
                     "torchmdnet_tpu/ops/pallas_blocked_mp.py:1504",
                     "blocked"),
    # rows 12-13 on the grouped K′ list (one kernel for both layouts: the
    # same launch counters, counted on the grouped path's run) and with the
    # exact rbf base (tab=False), ungrouped and grouped
    "blocked_q_fwd_grouped": (SRC + "blocked_q.cu",
                              "torchmdnet_tpu/ops/pallas_blocked_mp.py:1324",
                              "blocked_grouped"),
    "blocked_q_fwd_du_grouped": (
        SRC + "blocked_q.cu", "torchmdnet_tpu/ops/pallas_blocked_mp.py:1324",
        "blocked_grouped"),
    "blocked_q_dq_grouped": (SRC + "blocked_q.cu",
                             "torchmdnet_tpu/ops/pallas_blocked_mp.py:1623",
                             "blocked_grouped"),
    "blocked_q_fwd_rbf": (SRC + "blocked_q.cu",
                          "torchmdnet_tpu/ops/pallas_blocked_mp.py:1211",
                          "blocked_exact"),
    "blocked_q_fwd_du_rbf": (SRC + "blocked_q.cu",
                             "torchmdnet_tpu/ops/pallas_blocked_mp.py:1211",
                             "blocked_exact"),
    "blocked_q_dq_rbf": (SRC + "blocked_q.cu",
                         "torchmdnet_tpu/ops/pallas_blocked_mp.py:1504",
                         "blocked_exact"),
    "blocked_q_fwd_rbf_grouped": (
        SRC + "blocked_q.cu", "torchmdnet_tpu/ops/pallas_blocked_mp.py:1324",
        "blocked_exact_grouped"),
    "blocked_q_fwd_du_rbf_grouped": (
        SRC + "blocked_q.cu", "torchmdnet_tpu/ops/pallas_blocked_mp.py:1324",
        "blocked_exact_grouped"),
    "blocked_q_dq_rbf_grouped": (
        SRC + "blocked_q.cu", "torchmdnet_tpu/ops/pallas_blocked_mp.py:1623",
        "blocked_exact_grouped"),
    "windowed_coulomb_fwd": (SRC + "windowed_coulomb.cu",
                             "torchmdnet_tpu/ops/pallas_coulomb.py:280",
                             "blocked"),
    "windowed_coulomb_bwd": (SRC + "windowed_coulomb.cu",
                             "torchmdnet_tpu/ops/pallas_coulomb.py:297",
                             "blocked"),
    "edge_mlp": (SRC + "edge_mlp.cu",
                 "torchmdnet_tpu/ops/pallas_kernels.py:59", "dhfr_exact"),
    "cheb_filter": (SRC + "cheb_filter.cu",
                    "torchmdnet_tpu/ops/pallas_cheb.py:86", "dhfr"),
    "cheb_filter_dot": (SRC + "cheb_filter.cu",
                        "torchmdnet_tpu/ops/pallas_cheb.py:95", "dhfr"),
    "cheb_project": (SRC + "cheb_filter.cu",
                     "torchmdnet_tpu/ops/pallas_cheb.py:105", "train"),
    # rows 8-11: one kernel for the ungrouped body and the grouped one
    # (:224, :435, :723, :843)
    "blocked_mp_sum": (SRC + "blocked_mp.cu",
                       "torchmdnet_tpu/ops/pallas_blocked_mp.py:187",
                       "dhfr_blocked_exact"),
    "blocked_mp_dattr": (SRC + "blocked_mp.cu",
                         "torchmdnet_tpu/ops/pallas_blocked_mp.py:381",
                         "dhfr_blocked_exact"),
    "blocked_mp_sum_cheb": (SRC + "blocked_mp.cu",
                            "torchmdnet_tpu/ops/pallas_blocked_mp.py:687",
                            "dhfr_blocked"),
    "blocked_mp_dd_cheb": (SRC + "blocked_mp.cu",
                           "torchmdnet_tpu/ops/pallas_blocked_mp.py:783",
                           "dhfr_blocked"),
}


def counters():
    """Kernel name → its launch counter (``Kernel`` objects)."""
    from torchmdnet_tpu_torch.ops import (
        blocked_mp, blocked_q, cheb_filter, edge_mlp, radial_embedding,
        windowed_coulomb)
    return {"radial_embedding_fwd": radial_embedding.FORWARD,
            "radial_embedding_bwd": radial_embedding.BACKWARD,
            "edge_mlp_pre": edge_mlp.FORWARD,
            "blocked_q_fwd": blocked_q.FORWARD,
            "blocked_q_fwd_du": blocked_q.FORWARD_DU,
            "blocked_q_dq": blocked_q.DQ,
            "blocked_q_fwd_grouped": blocked_q.FORWARD,
            "blocked_q_fwd_du_grouped": blocked_q.FORWARD_DU,
            "blocked_q_dq_grouped": blocked_q.DQ,
            "blocked_q_fwd_rbf": blocked_q.FORWARD_RBF,
            "blocked_q_fwd_du_rbf": blocked_q.FORWARD_DU_RBF,
            "blocked_q_dq_rbf": blocked_q.DQ_RBF,
            "blocked_q_fwd_rbf_grouped": blocked_q.FORWARD_RBF,
            "blocked_q_fwd_du_rbf_grouped": blocked_q.FORWARD_DU_RBF,
            "blocked_q_dq_rbf_grouped": blocked_q.DQ_RBF,
            "windowed_coulomb_fwd": windowed_coulomb.FORWARD,
            "windowed_coulomb_bwd": windowed_coulomb.BACKWARD,
            "edge_mlp": edge_mlp.FUSED,
            "cheb_filter": cheb_filter.FILTER,
            "cheb_filter_dot": cheb_filter.FILTER_DOT,
            "cheb_project": cheb_filter.PROJECT,
            "blocked_mp_sum": blocked_mp.SUM,
            "blocked_mp_dattr": blocked_mp.DATTR,
            "blocked_mp_sum_cheb": blocked_mp.SUM_CHEB,
            "blocked_mp_dd_cheb": blocked_mp.DD_CHEB}


def launch_counts():
    """Kernel name → its launches so far."""
    return {k: c.launches for k, c in counters().items()}


def check_launched(names, before):
    """Each kernel of ``names`` launched since the counts ``before``: the
    CUDA kernel ran, not a plain chain."""
    now = launch_counts()
    for name in names:
        check(now[name] > before[name], f"{name}: the kernel did not launch")


def emit(obj):
    """Print one JSON line, and keep a copy in ``OUT_DIR/smoke.jsonl`` (the
    end of a long standard output may be all a caller gets back)."""
    line = json.dumps(obj)
    print(line, flush=True)
    if OUT_DIR.is_dir():
        with open(OUT_DIR / "smoke.jsonl", "a") as log:
            log.write(line + "\n")


def peaks(name):
    for key in ("H100 PCIe", "H100 NVL", "H200", "H100"):
        if key in name or key.replace(" ", "-") in name:
            return key, PEAKS[key]
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def bound(flops, nbytes, peak, tc_flops=0.0):
    """Least ms for ``flops`` and ``nbytes``: the larger of the bytes over
    the memory rate and the operations over their peak.  ``tc_flops`` of
    the ``flops`` are a product the kernel runs on the tensor cores in
    3xTF32 (three TF32 products for each fp32 one, at the TF32 peak); the
    rest run at the fp32 peak, the two units side by side."""
    t_ops = max((flops - tc_flops) / peak[0], 3 * tc_flops / peak[2]) * 1e3
    t_bytes = nbytes / peak[1] * 1e3
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


def device_ms(fn, reps=10, warmup=2, spin_ms=2.0):
    """Median device time of ``fn`` over ``reps`` calls, without the host
    time of its wrapper: a spin kernel holds the stream while the host
    enqueues the call, so that the CUDA events around it bracket the
    call's own kernels and no host gap.  The spin is doubled until it
    outlasts the host's enqueue.  (Short ``torch.profiler`` sessions lose
    all device activity on the card once unprofiled work has run: PERF.md
    §7.)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < reps:
        before, start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(3))
        t0 = time.perf_counter()
        before.record()
        torch.cuda._sleep(int(spin_ms * 1e6))  # spin_ms · 10^6 clock cycles
        start.record()
        fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if host_ms >= before.elapsed_time(start):
            spin_ms *= 2
            check(spin_ms < 1e3, "device_ms: the host's enqueue never ends")
            continue
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_times(kern, library):
    """The kernel's and its library yardstick's device times."""
    return dict(device_ms=device_ms(kern), library_device_ms=device_ms(library))


def rel_err(got, want):
    """(max abs error, max abs error / max |want|)."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def limit(name):
    """The agreement a kernel row or shape case ``name`` is held to."""
    if name.startswith("cheb_filter"):
        return CHEB_TOL
    if name.startswith("blocked_q"):
        return DQ_TOL
    if name.startswith("radial_embedding"):
        return EMB_TOL
    if name.startswith("windowed_coulomb"):
        return WC_TOL
    if (name.startswith(("blocked_mp_sum", "blocked_mp_dattr"))
            and "cheb" not in name):
        return SUM_TOL
    return EDGE_TOL if name.startswith("edge_mlp") else TOL


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@contextlib.contextmanager
def plain_versions():
    """Route the q-tier, windowed-Coulomb, Chebyshev-filter (rows 5-7) and
    blocked message-passing ops through their plain versions for CUDA
    tensors too,
    so a whole-model run can be held against the kernels (the embedding
    and edge-MLP kernels are switched off by the model's own flags)."""
    from torchmdnet_tpu_torch.ops import blocked_mp as bm
    from torchmdnet_tpu_torch.ops import blocked_q as bq
    from torchmdnet_tpu_torch.ops import cheb_filter as cf
    from torchmdnet_tpu_torch.ops import windowed_coulomb as wc
    swaps = [(bq, "q_fwd", bq.q_fwd_ref), (bq, "q_dq", bq.q_dq_ref),
             (bq, "q_fwd_rbf", bq.q_fwd_rbf_ref),
             (bq, "q_dq_rbf", bq.q_dq_rbf_ref),
             (wc, "wc_fwd", wc.wc_fwd_ref), (wc, "wc_bwd", wc.wc_bwd_ref),
             (cf, "filter_fwd", cf.cheb_filter_ref),
             (cf, "filter_dot_fwd", cf.cheb_filter_dot_ref),
             (cf, "project_fwd", cf.cheb_project_ref),
             (bm, "neighbor_sum", bm.neighbor_sum_ref),
             (bm, "dattr", bm.dattr_ref),
             (bm, "neighbor_sum_cheb", bm.neighbor_sum_cheb_ref),
             (bm, "dd_cheb", bm.dd_cheb_ref)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ---------------------------------------------------------------- device
def phase_device():
    import importlib.util

    from torchmdnet_tpu_torch.ops import (
        blocked_mp, blocked_q, cheb_filter, edge_mlp, radial_embedding,
        windowed_coulomb)
    from torchmdnet_tpu_torch.ops.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    board, peak = peaks(name)
    t0 = time.perf_counter()
    logs = build([radial_embedding.SOURCE, edge_mlp.SOURCE, blocked_q.SOURCE,
                  windowed_coulomb.SOURCE, cheb_filter.SOURCE,
                  blocked_mp.SOURCE])
    secs = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "smoke.jsonl").write_text("")
    (OUT_DIR / "nvcc.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "kind": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_from": board,
          "peak_fp32_tflops": peak[0] / 1e12, "peak_tb_s": peak[1] / 1e12,
          "peak_tf32_tflops": peak[2] / 1e12,
          "tf32": bool(torch.backends.cuda.matmul.allow_tf32
                       or torch.backends.cudnn.allow_tf32),
          "build_s": round(secs, 3), "ptxas": ptxas,
          # the data phase reads npz files and writes its config without
          # either (find_spec imports nothing)
          "find_spec": {m: importlib.util.find_spec(m) is not None
                        for m in ("yaml", "h5py", "ase")}})
    return smi, name, peak


def phase_tc_attributes(specs, q_specs, wspec):
    """The tensor-core kernels as compiled and launched: rows 10 and 11 (and
    rows 8 and 9, which must not spill) at the dhfr cell-blocked shapes
    (the sorts of ``specs``: the grouped K′ and the brute K=64 list;
    F=128, T=128), kernels 5 and 7 at the dhfr
    brute list's and the training batch's slots (T=128, C=384), row 6 at
    the training batch's (no spill, two blocks an SM, its grid):
    registers and local (spill) bytes a thread, static and dynamic shared
    memory and resident blocks an SM (``cudaFuncGetAttributes``, occupancy
    API); the dynamic shared memory and the split-series scratch must
    equal the wrappers' plans, and kernels 5 and 7 must not spill.  Kernel
    3 the same at F = 128 (its split W2 and W3) and on the gather path's
    N·K slots, kernel 4 at R = 32, F = 128 on the dhfr brute list's slots
    (its split W1, W2 and W3) and at the widths of its other forms, both
    with no spill and their scratch the wrapper's; kernels A, A with du and B, both bases, at F = 128, T =
    64, R = 32 on the north star's sorts of ``q_specs`` (K = 96 and the
    grouped K′), with no spill and their image and tile scratch equal to
    the wrapper's; kernels 1 and 2 (each backward form) at the embedding's
    main shapes (N = 25,088, K = 96, R = 32, F = 128), with no spill and
    their shared memory, staged kall and tile scratch the wrapper's, and
    (reported only) their wide forms there; kernels C and D at the north
    star's blocks, channels and stencil (``wspec``: cap 16, C = 48) and at
    cap 32, C = 132, S = 6, with no spill and their plan (tiles a pass,
    passes, channel chunks, shared memory, the staged rows' scratch) the
    wrapper's."""
    from torchmdnet_tpu_torch.ops import blocked_mp as bm
    from torchmdnet_tpu_torch.ops import blocked_q as bq
    from torchmdnet_tpu_torch.ops import cheb_filter as cf
    from torchmdnet_tpu_torch.ops import edge_mlp as em
    from torchmdnet_tpu_torch.ops import radial_embedding as re_ops
    from torchmdnet_tpu_torch.ops import windowed_coulomb as wc

    attrs = {}
    image = bm.tc_image_floats(DHFR_T, 3 * F)
    for spec in specs.values():
        k = sum(spec.col_slots) if spec.col_slots else DHFR_K
        plan = bm.launch_plan(spec.n_pad, k, F, DHFR_T)
        for name, a in bm.kernel_attributes(k, F, DHFR_T).items():
            check(a["dynamic_smem"] == plan[name][1],
                  f"{name}: the kernel's shared memory {a['dynamic_smem']} "
                  f"differs from the plan's {plan[name][1]}")
            check(a["blocks_per_sm"] >= 1, f"{name}: does not fit an SM")
            check(a.get("image_floats", image) == image,
                  f"{name}: the kernel's image scratch differs from the "
                  "wrapper's")
            check(name not in ("blocked_mp_sum", "blocked_mp_dattr")
                  or a["local_bytes"] == 0, f"{name}: spills")
            attrs[f"{name}@k{k}"] = dict(a, blocks=plan[name][0])
    slots = {"dhfr": DHFR_PAD * DHFR_K, "train": TRAIN_ROWS * TRAIN_K}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, a in cf.kernel_attributes(DHFR_T, 3 * F).items():
        if name == "cheb_project":  # row 6 at the training batch
            plan = cf.project_plan(slots["train"], TRAIN_T, 3 * F, sms)
            check(a["dynamic_smem"] == plan["smem"],
                  f"{name}: the kernel's shared memory {a['dynamic_smem']} "
                  f"differs from the plan's {plan['smem']}")
            check(a["blocks_per_sm"] >= 2, f"{name}: fewer than 2 blocks an SM")
            check(a["local_bytes"] == 0, f"{name}: spills")
            attrs[name] = dict(a, grid=plan["grid"],
                               partial_floats=plan["partial_floats"])
            continue
        plans = {key: cf.launch_plan(e)[name] for key, e in slots.items()}
        check(a["dynamic_smem"] == plans["dhfr"][2],
              f"{name}: the kernel's shared memory {a['dynamic_smem']} "
              f"differs from the plan's {plans['dhfr'][2]}")
        check(a["blocks_per_sm"] >= 1, f"{name}: does not fit an SM")
        check(a["local_bytes"] == 0, f"{name}: spills")
        check(a["image_floats"] == image,
              f"{name}: the kernel's image scratch differs from the "
              "wrapper's")
        attrs[name] = dict(a, span=plans["dhfr"][1],
                           blocks={key: p[0] for key, p in plans.items()})
    # kernel 3 on the gather path's slots; kernel 4 on the dhfr brute
    # list's at (R, F) = (32, 128), and (reported, the plan checked) at
    # widths of its other forms: (64, 256) narrow, (32, 512) and (4,
    # 1024) wide
    slots = {"edge_mlp_pre": N_ATOMS * K, "edge_mlp": DHFR_PAD * DHFR_K}
    for r, f, tag in ((R, F, ""), (64, 256, "@r64_f256"),
                      (32, 512, "@r32_f512"), (4, 1024, "@r4_f1024")):
        for name, a in em.kernel_attributes(f, r).items():
            if tag and name == "edge_mlp_pre":
                continue
            blocks, chunks, smem, image, tiles = em.launch_plan(
                slots[name], f, sms, r)[name]
            check(a["dynamic_smem"] == smem,
                  f"{name}{tag}: the kernel's shared memory "
                  f"{a['dynamic_smem']} differs from the plan's {smem}")
            check(a["blocks_per_sm"] >= 1, f"{name}{tag}: does not fit an SM")
            check(a["local_bytes"] == 0, f"{name}{tag}: spills")
            check(a["image_floats"] == image
                  and a["tile_floats"] * blocks == tiles,
                  f"{name}{tag}: the kernel's scratch differs from the "
                  "wrapper's")
            attrs[name + tag] = dict(a, chunks=chunks, blocks=blocks)
    for spec in q_specs.values():
        k = sum(spec.col_slots) if spec.col_slots else K
        for name, a in bq.kernel_attributes(F, k, Q_TAB, R).items():
            rbf = name.endswith("_rbf")
            mode = bq.MODES.index(name.removesuffix("_rbf"))
            blocks, _, chunk, smem, image, tiles = bq.launch_plan(
                spec.n_pad, k, F, R if rbf else Q_TAB, rbf, mode, sms)[name]
            check(a["dynamic_smem"] == smem,
                  f"{name}: the kernel's shared memory {a['dynamic_smem']} "
                  f"differs from the plan's {smem}")
            check(a["blocks_per_sm"] >= 1, f"{name}: does not fit an SM")
            check(a["local_bytes"] == 0, f"{name}: spills")
            check(a["image_floats"] == image and a["tile_floats"] * blocks
                  == tiles, f"{name}: the kernel's scratch differs from the "
                  "wrapper's")
            attrs[f"{name}@k{k}"] = dict(a, blocks=blocks, chunk=chunk)
    for name, a in re_ops.kernel_attributes(F, K, R).items():
        mode = re_ops.MODES.index(name)
        blocks, _, chunk, smem, tiles, part, kall_smem = re_ops.launch_plan(
            N_ATOMS, K, R, F, mode, sms)[name]
        check(a["dynamic_smem"] == smem and a["kall_smem"] == kall_smem,
              f"{name}: the kernel's shared memory {a['dynamic_smem']} "
              f"differs from the plan's {smem}")
        check(a["blocks_per_sm"] >= 1, f"{name}: does not fit an SM")
        check(a["local_bytes"] == 0, f"{name}: spills")
        check(a["tile_floats"] * blocks == tiles,
              f"{name}: the kernel's tile scratch differs from the wrapper's")
        attrs[name] = dict(a, blocks=blocks, chunk=chunk, part_floats=part)
    for name, a in re_ops.kernel_attributes(F, K, R, wide=True).items():
        attrs[f"{name}@wide"] = a
    n_pad = q_specs["ungrouped"].n_pad
    for cap, c, nsc, tag in ((CAP, C_CH, wspec.nsc, ""),
                             (32, 132, 13 * 13, "@cap32_c132_s6")):
        for name, a in wc.kernel_attributes(cap, c, nsc, n_pad).items():
            plan = wc.wc_plan(cap, c, nsc, name.endswith("bwd"))
            check(all(a[k] == v for k, v in plan._asdict().items())
                  and a["rows_floats"] == wc.rows_floats(n_pad, plan),
                  f"{name}: the kernel's plan {a} differs from the "
                  f"wrapper's {plan}")
            check(a["blocks_per_sm"] >= 1, f"{name}: does not fit an SM")
            check(a["local_bytes"] == 0, f"{name}: spills")
            attrs[name + tag] = a
    emit({"phase": "tc_attributes", "attributes": attrs})


# ---------------------------------------------------------------- inputs
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


def blocked_inputs(pos, L, cap, k, f, t, c, model_rc, coulomb_rc, seed,
                   cutoff=4.5, grouped=False):
    """Real cell-blocked geometry of ``pos`` on the card and random
    operands for kernels A-D: the sorted-space neighbor matrix at
    ``model_rc`` (cutoff + skin; ``k`` slots, or with ``grouped`` the
    column-partitioned list of a spec tuned with ``column_slots``), its
    distances, cutoff weights and expnorm rbf (R channels, for the exact
    base), and the stencil windows at ``coulomb_rc``."""
    from torchmdnet_tpu_torch.models.common import make_rbf
    from torchmdnet_tpu_torch.ops import cell_blocks as cb
    from torchmdnet_tpu_torch.ops import rbf
    from torchmdnet_tpu_torch.ops.neighbors import (
        build_neighbor_matrix, neighbor_geometry)
    from torchmdnet_tpu_torch.ops.windowed_coulomb import make_coulomb_windows

    dev = torch.device("cuda")
    n_atoms = len(pos)
    bd = [L, L, L]
    pt = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    box = torch.diag(torch.tensor(bd, dtype=torch.float32, device=dev))
    spec = cb.tune_cell_block_spec(pt, bd, model_rc, cap=cap,
                                   column_slots=grouped)
    wspec = cb.tune_stencil_window_spec(pt, bd, spec, coulomb_rc)
    blocks, win = cb.plan_cell_blocks_and_windows(pt, bd, spec, wspec)
    perm = torch.clamp(blocks.perm, max=n_atoms - 1)
    am = blocks.mask_rows
    pos_s = torch.where(am[:, None], pt[perm], 0.0).contiguous()
    nz = max(int(L // model_rc), 3)
    kw = dict(strategy="cell", k_max=k, cells_per_dim=(nz, nz, nz))
    if grouped:  # the MD rebuild's grouped list (md/integrators.py)
        occ = n_atoms / (spec.nx * spec.ny * nz)
        kw = dict(strategy="cell", k_max=sum(spec.col_slots),
                  cells_per_dim=(spec.nx, spec.ny, nz),
                  cell_capacity=int(np.ceil(occ * 2.5)) + 8,
                  column_partition=spec.col_slots)
    nbr = build_neighbor_matrix(pos_s, (~am).long(), cutoff_upper=model_rc,
                                loop=True, box=box, atom_mask=am, **kw)
    check(not bool(nbr.overflow), "kernel inputs: neighbor overflow")
    _, d = neighbor_geometry(pos_s, nbr, box=box)
    cw = rbf.cosine_cutoff(d, cutoff, 0.0) * nbr.mask
    cwin = make_coulomb_windows(win, am, bd)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = spec.n_pad
    expnorm = make_rbf("expnorm", 0.0, cutoff, R, False).to(dev)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    q = dict(d=d.contiguous(), cw=cw.contiguous(), mask=nbr.mask, idx=nbr.idx,
             urow=randn(n, f, scale=0.5), ucol=randn(n, f, scale=0.5),
             xwin=randn(n, 9 * f),
             coeffs=randn(t, f) * (0.7 ** torch.arange(t, device=dev))[:, None],
             w2=randn(f, 2 * f, scale=f ** -0.5), b2=randn(2 * f, scale=0.1),
             w3=randn(2 * f, 3 * f, scale=(2 * f) ** -0.5),
             b3=randn(3 * f, scale=0.1), grow=randn(n, 9 * f),
             rbf=(expnorm(d) * nbr.mask[..., None]).contiguous(),
             w1a=randn(R, f, scale=R ** -0.5))
    q["rev"] = nbr.rev_slot
    w = dict(pos_s=pos_s, b_s=randn(n, c, scale=0.1),
             qw=torch.ones(c, device=dev), ct=am.float(), cwin=cwin, box=box)
    return spec, wspec, q, w


def pair_deltas_row(peak, pos_s, box, q):
    """The position gather's backward on a sorted-space list: ∂pos through
    ``gather_pair_deltas`` (a row sum minus a reverse gather) against
    plain indexing (an atomic scatter) on a seeded cotangent that is 0 on
    invalid slots, as ``neighbor_geometry`` leaves it; the device time of
    each backward and the bound (ct, idx, rev_slot and mask read once,
    ∂pos written once)."""
    from torchmdnet_tpu_torch.ops.message_passing import gather_pair_deltas

    idx, rev, mask = q["idx"], q["rev"], q["mask"]
    gen = torch.Generator(device=pos_s.device).manual_seed(5)
    ct = (torch.randn(idx.shape + (3,), generator=gen, device=pos_s.device)
          * mask[..., None])
    p = pos_s.detach().requires_grad_(True)
    d_gather = gather_pair_deltas(p, idx, rev, mask)
    d_plain = p[:, None, :] - p[idx]

    def backward(d):
        return lambda: torch.autograd.grad(d, p, ct, retain_graph=True)[0]

    got, want = backward(d_gather)(), backward(d_plain)()
    err, rel = rel_err(got, want)
    nb = nbytes(ct, idx, rev, mask, got)
    b_ms, b_by = bound(2 * ct.numel(), nb, peak)
    return dict(rows=idx.shape[0], k=idx.shape[1],
                valid_slots=int(mask.sum()), max_abs_err=err,
                max_rel_err=rel, device_ms=device_ms(backward(d_gather)),
                plain_device_ms=device_ms(backward(d_plain)),
                bound_ms=b_ms, bound_by=b_by, gbytes=nb / 1e9)


def charge_gather_row(peak, batch):
    """The backward of TensorNet2's charge equilibration's per-molecule
    gather (``ChargePredict.qeq``: ``[num_mols + 1, q_dim]`` sums back to
    the atoms, three times an evaluation, twice each): ``index_select``
    (an ``index_add``) against plain indexing (a sorted ``index_put``
    that sums a molecule's atoms one after another), on the sorted rows'
    molecules (ghosts in molecule 1) at q_dim = 16."""
    gen = torch.Generator(device=batch.device).manual_seed(6)
    u = torch.randn((2, Q_DIM), generator=gen,
                    device=batch.device).requires_grad_(True)
    ct = torch.randn((batch.shape[0], Q_DIM), generator=gen,
                     device=batch.device)
    sel, plain = u.index_select(0, batch), u[batch]

    def backward(x):
        return lambda: torch.autograd.grad(x, u, ct, retain_graph=True)[0]

    err, rel = rel_err(backward(sel)(), backward(plain)())
    nb = nbytes(ct, batch, u)
    b_ms, b_by = bound(ct.numel(), nb, peak)
    return dict(rows=batch.shape[0], q_dim=Q_DIM, max_abs_err=err,
                max_rel_err=rel, device_ms=device_ms(backward(sel)),
                plain_device_ms=device_ms(backward(plain)),
                bound_ms=b_ms, bound_by=b_by)


Q_ARGS = ("d", "cw", "mask", "idx", "urow", "ucol", "xwin")
Q_WEIGHTS = ("coeffs", "w2", "b2", "w3", "b3")


def q_calls(q, suffix=""):
    """(kernel A, A with du, B) of the q-tier on ``q``, each as a pair of
    (kernel, plain) callables, named with ``suffix``: the tabulated base,
    and ``_rbf`` + ``suffix`` the exact one (``q["rbf"]``, ``q["w1a"]``)."""
    from torchmdnet_tpu_torch.ops import blocked_q as bq
    from torchmdnet_tpu_torch.ops.cheb import cheb_deriv_coeffs

    a = [q[k] for k in Q_ARGS]
    wts = [q[k] for k in Q_WEIGHTS]
    dser = cheb_deriv_coeffs(q["coeffs"]).contiguous()
    x = [q["rbf"], *a[1:]]
    xw = [q["w1a"], *wts[1:]]
    return {
        "blocked_q_fwd" + suffix: (
            lambda: bq.q_fwd_cuda(*a, *wts, 0.0, 4.5),
            lambda: bq.q_fwd_ref(*a, *wts, 0.0, 4.5)),
        "blocked_q_fwd_du" + suffix: (
            lambda: bq.q_fwd_cuda(*a, *wts, 0.0, 4.5, grow=q["grow"]),
            lambda: bq.q_fwd_ref(*a, *wts, 0.0, 4.5, grow=q["grow"])),
        "blocked_q_dq" + suffix: (
            lambda: bq.q_dq_cuda(*a, q["grow"], q["coeffs"], dser, *wts[1:],
                                 0.0, 4.5),
            lambda: bq.q_dq_ref(*a, q["grow"], q["coeffs"], dser, *wts[1:],
                                0.0, 4.5)),
        "blocked_q_fwd_rbf" + suffix: (
            lambda: bq.q_fwd_rbf_cuda(*x, *xw),
            lambda: bq.q_fwd_rbf_ref(*x, *xw)),
        "blocked_q_fwd_du_rbf" + suffix: (
            lambda: bq.q_fwd_rbf_cuda(*x, *xw, grow=q["grow"]),
            lambda: bq.q_fwd_rbf_ref(*x, *xw, grow=q["grow"])),
        "blocked_q_dq_rbf" + suffix: (
            lambda: bq.q_dq_rbf_cuda(*x, q["grow"], *xw),
            lambda: bq.q_dq_rbf_ref(*x, q["grow"], *xw))}


def wc_calls(w, rc):
    from torchmdnet_tpu_torch.ops import windowed_coulomb as wc

    args = (w["pos_s"], w["b_s"])
    bwd = (w["pos_s"], w["b_s"], w["ct"], w["qw"])
    consts = (rc, 78.3, 7.2)
    return {
        "windowed_coulomb_fwd": (
            lambda: wc.wc_fwd_cuda(*args, w["cwin"], *consts),
            lambda: wc.wc_fwd_ref(*args, w["cwin"], *consts)),
        "windowed_coulomb_bwd": (
            lambda: wc.wc_bwd_cuda(*bwd, w["cwin"], *consts),
            lambda: wc.wc_bwd_ref(*bwd, w["cwin"], *consts))}


def as_list(x):
    return list(x) if isinstance(x, tuple) else [x]


def compare(kern, plain):
    """Run both; the worst (max abs err, rel err) over their outputs."""
    got, want = as_list(kern()), as_list(plain())
    torch.cuda.synchronize()
    check(all(torch.isfinite(t).all() for t in got), "non-finite output")
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    return max(e[0] for e in errs), max(e[1] for e in errs), got


# ---------------------------------------------------------------- kernels
def kernel_rows(rows, peak, calls, work, mask):
    """Each kernel of ``calls`` against its plain version: errors, ms,
    device ms, plain ms and bound into ``rows``; the exact q-tier's rbf
    cotangent must be exactly 0 on the slots ``mask`` leaves out.  A
    ``work`` entry is (FLOP, bytes) or (FLOP, bytes, the FLOP of them that
    the kernel runs on the tensor cores in 3xTF32)."""
    for name, (kern, plain) in calls.items():
        err, rel, got = compare(kern, plain)
        if name.startswith("blocked_q_dq_rbf"):
            check(not got[1][~mask].any(),
                  f"{name}: an invalid slot's rbf cotangent is not 0")
        flops, nb, *tc = work[name]
        b_ms, b_by = bound(flops, nb, peak, *tc)
        rows[name] = dict(
            max_abs_err=err, max_rel_err=rel, ms=time_ms(kern),
            device_ms=device_ms(kern),
            plain_ms=time_ms(plain, reps=3, warmup=1), bound_ms=b_ms,
            bound_by=b_by, library_ms=None, gflop=flops / 1e9,
            gbytes=nb / 1e9)
        del got
        torch.cuda.empty_cache()


def q_work(q, f, t, suffix=""):
    """(FLOP, bytes, tensor-core FLOP) each q-tier kernel needs on ``q``:
    kernel A runs the chain on the slots with cw ≠ 0, kernel B on every
    valid slot (the backprop on the cw ≠ 0 ones); the third element is
    the FLOP of their products, which both run on the tensor cores in
    3xTF32.  Inputs: the mask of every slot, the
    per-slot operands (d or the rbf row, cw, idx) of the valid slots, the
    row arrays and weights once; outputs once (B's per-slot ones on every
    slot: zeros elsewhere).  Names as :func:`q_calls` gives them."""
    live = float((q["cw"] != 0).sum())
    valid = float(q["mask"].sum())
    n, k = q["d"].shape
    r = q["rbf"].shape[-1]
    l2, l3, g9 = 2 * f * f, 6 * f * f, 9 * f
    rows = nbytes(q["mask"], q["urow"], q["ucol"], q["xwin"], q["w2"],
                  q["b2"], q["w3"], q["b3"])
    out9, outf, grow = n * 9 * f * 4, n * f * 4, nbytes(q["grow"])
    work = {}
    for name, base, slot_in, w1, dbase in (
            ("", t * f, 4 + 4 + 8, t * f * 4, n * k * 4),
            ("_rbf", r * f, 4 * r + 4 + 8, r * f * 4, n * k * r * 4)):
        ins = rows + w1 + valid * slot_in
        fwd = 2 * live * (base + l2 + l3)
        work["blocked_q_fwd" + name + suffix] = (
            fwd + 2 * live * g9, ins + out9, fwd)
        # with du: the W3ᵀ and W2ᵀ backprop and the fold beside
        fwd_du = 2 * live * (base + 2 * (l2 + l3))
        work["blocked_q_fwd_du" + name + suffix] = (
            fwd_du + 4 * live * g9, ins + grow + out9 + outf, fwd_du)
        # B: the forward chain and the fold on every valid slot, the
        # backprop and the base cotangent (dser's series or W1aᵀ) on the
        # live ones
        products = 2 * valid * (base + l2 + l3) + 2 * live * (l3 + l2 + base)
        work["blocked_q_dq" + name + suffix] = (
            products + 2 * valid * (g9 + 3 * f),
            ins + grow + w1 + outf + n * k * 4 + dbase, products)
    return work


def wc_work(w, rc, c):
    """(FLOP, bytes, tensor-core FLOP) kernels C and D need on ``w``:
    every candidate pair of a real row with a live window row pays its
    geometry (~20 FLOP); only the pairs inside ``rc`` need G (~40 FLOP)
    and the channel FMAs (2C for Φ; in D 2C for S2, 2C for pd and ~70 for
    G, G' and dpos), the products of which both kernels run on the tensor
    cores in 3xTF32.  ``pairs`` also gives the window rows of all blocks
    and the bytes the kernels stage from them (x, y, z, ct and the
    channels of each chunk: ``wc_plan``)."""
    from torchmdnet_tpu_torch.ops import windowed_coulomb as wc

    cwin = w["cwin"]
    _, live = wc.window_partners(cwin)
    real = cwin.row_valid.view(-1, cwin.cap).sum(1).float()
    cand = float((real * live.sum(1).float()).sum())
    inside = sum(float(v.sum()) for *_, v in
                 wc._pair_blocks(w["pos_s"], cwin, rc, c))
    n = cwin.row_valid.shape[0]
    plan = nbytes(cwin.a1, cwin.e1, cwin.a2, cwin.e2, cwin.row_valid)
    src = n * (4 + c) * 4
    rows = float((torch.cat([cwin.e1, cwin.e2], 1)
                  - torch.cat([cwin.a1, cwin.a2], 1)).clamp_min(0).sum())
    chunks = wc.wc_plan(cwin.cap, c, cwin.a1.shape[1]).chunks
    return {"windowed_coulomb_fwd": (cand * 20 + inside * (2 * c + 40),
                                     src + plan + n * c * 4,
                                     inside * 2 * c),
            "windowed_coulomb_bwd": (cand * 20 + inside * (4 * c + 70),
                                     src + plan + c * 4 + n * (c + 3) * 4,
                                     inside * 4 * c),
            "pairs": (cand, inside, rows,
                      rows * (16 * chunks + 4 * (-(-c // 4) * 4)))}


def fitted_coeffs(mlp, t, hi):
    """The [T, 3F] series the tabulated interaction fits
    (``models/tensornet.py::Interaction``): the edge MLP with weights
    ``mlp`` on the expnorm rbf at the ``t`` Chebyshev nodes, times the
    cosine cutoff, through the fit matrix.  A series of random terms
    instead would be a function of high frequency whose value moves by
    ~1e-4 with a last-bit change of the distance."""
    from torchmdnet_tpu_torch.models.common import make_rbf
    from torchmdnet_tpu_torch.ops import rbf
    from torchmdnet_tpu_torch.ops.cheb import cheb_fit_matrix, cheb_nodes
    from torchmdnet_tpu_torch.ops.edge_mlp import edge_mlp_ref

    dev = mlp[0].device
    dk = cheb_nodes(t, 0.0, hi, device=dev)
    x = make_rbf("expnorm", 0.0, hi, mlp[0].shape[0], False).to(dev)(dk)
    h = edge_mlp_ref(x[None], rbf.cosine_cutoff(dk, hi, 0.0)[None], *mlp)[0]
    return (cheb_fit_matrix(t, device=dev) @ h).contiguous()


def dhfr_inputs(system, seg, seed):
    """Real dhfr geometry on the card and random operands for kernels 4,
    5 and 7: the brute K=64 list of ``system`` (loop, ghosts masked), its
    distances, ``fm = (d < 4.5) & mask``, ``cw = C(d)·mask`` and the rbf
    ``x``, random edge-MLP weights and the [T, 3F] series fitted from
    them, and a cotangent ``ct``."""
    from torchmdnet_tpu_torch.models.common import make_rbf
    from torchmdnet_tpu_torch.ops import rbf
    from torchmdnet_tpu_torch.ops.neighbors import (
        build_neighbor_matrix, neighbor_geometry)

    _, pos, _, box, _ = system
    dev = torch.device("cuda")
    pt = torch.as_tensor(pos, device=dev)
    bt = torch.as_tensor(box, device=dev)
    st = torch.as_tensor(seg, device=dev)
    nbr = build_neighbor_matrix(pt, st, strategy="brute", k_max=DHFR_K,
                                cutoff_upper=4.5, loop=True, box=bt,
                                atom_mask=st < 1)
    check(not bool(nbr.overflow), "dhfr kernel inputs: neighbor overflow")
    _, d = neighbor_geometry(pt, nbr, box=bt)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, k = d.shape

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    mlp = [randn(R, F, scale=R ** -0.5), randn(F, scale=0.1),
           randn(F, 2 * F, scale=F ** -0.5), randn(2 * F, scale=0.1),
           randn(2 * F, 3 * F, scale=(2 * F) ** -0.5), randn(3 * F, scale=0.1)]
    return dict(
        d=d.contiguous(), fm=((d < 4.5) & nbr.mask).float(),
        cw=(rbf.cosine_cutoff(d, 4.5, 0.0) * nbr.mask).contiguous(),
        x=make_rbf("expnorm", 0.0, 4.5, R, False).to(dev)(d).contiguous(),
        coeffs=fitted_coeffs(mlp, DHFR_T, 4.5), ct=randn(n, k, 3 * F),
        mlp=mlp)


def dhfr_calls(v, hi=4.5):
    """Kernels 4, 5 and 7 on ``v``, each as a pair of (kernel, plain)
    callables."""
    from torchmdnet_tpu_torch.ops import cheb_filter as cf
    from torchmdnet_tpu_torch.ops import edge_mlp as em
    from torchmdnet_tpu_torch.ops.cheb import cheb_deriv_coeffs

    mlp = [v["x"], v["cw"], *v["mlp"]]
    f_args = (v["coeffs"], v["d"], v["fm"], 0.0, hi)
    dser = cheb_deriv_coeffs(v["coeffs"]).contiguous()
    d_args = (dser, v["d"], v["fm"], v["ct"], 0.0, hi)
    return {"edge_mlp": (lambda: em.edge_mlp_cuda(*mlp),
                         lambda: em.edge_mlp_ref(*mlp)),
            "cheb_filter": (lambda: cf.cheb_filter_cuda(*f_args),
                            lambda: cf.cheb_filter_ref(*f_args)),
            "cheb_filter_dot": (lambda: cf.cheb_filter_dot_cuda(*d_args),
                                lambda: cf.cheb_filter_dot_ref(*d_args))}


def dhfr_work(v):
    """(FLOP, bytes, tensor-core FLOP) kernels 4, 5 and 7 need on ``v``:
    the series product on the slots with fm ≠ 0, which 5 and 7 run on the
    tensor cores in 3xTF32 (and, in 7, the dot with ct), the edge MLP's
    three products on the slots with cw ≠ 0, which kernel 4 runs on the
    tensor cores in 3xTF32 too; each input read once (ct only on the slots
    with fm ≠ 0) and each output written once, the zero slots included."""
    live_fm = float((v["fm"] != 0).sum())
    live_cw = float((v["cw"] != 0).sum())
    e, t, c = v["d"].numel(), v["coeffs"].shape[0], v["coeffs"].shape[1]
    product = 2 * live_fm * t * c
    return {
        "cheb_filter": (product,
                        nbytes(v["d"], v["fm"], v["coeffs"]) + e * c * 4,
                        product),
        "cheb_filter_dot": (product + 2 * live_fm * c,
                            nbytes(v["d"], v["fm"], v["coeffs"])
                            + live_fm * c * 4 + e * 4, product),
        "edge_mlp": fused_work(v)}


def fused_work(v):
    """(FLOP, bytes, tensor-core FLOP) kernel 4 needs on ``v``: its three
    products on the slots with cw ≠ 0, all on the tensor cores in 3xTF32;
    the live slots' x rows, cw and the weights once, the whole [E, 3F]
    output, zeros included."""
    live = float((v["cw"] != 0).sum())
    r, f = v["mlp"][0].shape
    flops = 2 * live * (r * f + f * 2 * f + 2 * f * 3 * f)
    return (flops, live * r * 4 + nbytes(v["cw"], *v["mlp"])
            + v["cw"].numel() * 3 * f * 4, flops)


def dhfr_library(v):
    """The cuBLAS product that carries each kernel's operations, its other
    inputs precomputed: basis·coeffs (5), basis·dser (7) with the cos
    basis given, and the plain cuBLAS chain on x (4), as row 3."""
    from torchmdnet_tpu_torch.ops import edge_mlp as em
    from torchmdnet_tpu_torch.ops.cheb import (
        cheb_deriv_coeffs, cheb_theta, cos_basis)

    basis = cos_basis(cheb_theta(v["d"], 0.0, 4.5), DHFR_T).reshape(
        -1, DHFR_T)
    dser = cheb_deriv_coeffs(v["coeffs"]).contiguous()
    mlp = [v["x"], v["cw"], *v["mlp"]]
    return {"cheb_filter": lambda: torch.matmul(basis, v["coeffs"]),
            "cheb_filter_dot": lambda: torch.matmul(basis, dser),
            "edge_mlp": lambda: em.edge_mlp_ref(*mlp)}


def float64_reference(v, name, hi=4.5, theta64=False):
    """Kernel 5's or 7's function of ``v`` in float64: from the same fp32
    arguments ``j·θ`` the plain version takes, or (``theta64``) from θ of
    ``d`` in float64.  Returns ``(reference, scale)``: ``scale`` is max
    |reference| for kernel 5, and for kernel 7 the largest Σ_c |filter ·
    ct| of a slot, the size of the terms its channel sum adds."""
    from torchmdnet_tpu_torch.ops.cheb import cheb_deriv_coeffs, cheb_theta

    series = v["coeffs"] if name == "cheb_filter" else cheb_deriv_coeffs(
        v["coeffs"])
    theta = cheb_theta(v["d"].double() if theta64 else v["d"], 0.0, hi)
    j = torch.arange(series.shape[0], device=v["d"].device,
                     dtype=theta.dtype)
    x = theta[..., None] * j
    ref = (torch.cos(x.double()) @ series.double()) * v["fm"].double()[
        ..., None]
    del x
    if name == "cheb_filter":
        return ref, float(ref.abs().max())
    terms = ref * v["ct"].double()
    return terms.sum(-1), float(terms.abs().sum(-1).max())


def float64_errors(v, name, got, plain, hi=4.5, theta64=False):
    """Kernel 5's or 7's output ``got`` and its plain version's ``plain``
    against the same function in float64 (:func:`float64_reference`):
    ``[kernel, plain]`` max abs error / max |float64|, so that the
    kernel's error reads beside float32's own."""
    ref, _ = float64_reference(v, name, hi, theta64)
    top = float(ref.abs().max())
    return [float((t.double() - ref).abs().max()) / top for t in (got, plain)]


def cheb_seed_errors(seeds=CHEB_SEEDS, cases=None):
    """Kernels 5 and 7 on every case of :func:`dhfr_shape_errors` (or
    ``cases``), drawn anew from a generator of each seed of ``seeds``: per
    kernel, case and seed, ``vs_plain`` (max |kernel − plain| / max
    |plain|), ``vs_float64`` ([kernel, plain] against float64 from θ in
    float64, / max |float64|) and ``vs_float64_terms`` (the same errors /
    the float64 scale of :func:`float64_reference`)."""
    import inspect

    cases = cases or inspect.signature(dhfr_shape_errors).parameters[
        "cases"].default
    hi = 4.5
    out = {}
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(CHEB_SEED0 + seed)
        for n, k, t, f, r in cases:
            v = shape_case_inputs(gen, n, k, t, f, r, hi)
            calls = dhfr_calls(v, hi)
            for name in ("cheb_filter", "cheb_filter_dot"):
                kern, plain = calls[name]
                got, want = kern(), plain()
                torch.cuda.synchronize()
                ref, scale = float64_reference(v, name, hi, theta64=True)
                top = float(ref.abs().max())
                errs = [float((x.double() - ref).abs().max())
                        for x in (got, want)]
                key = f"{name}_n{n}_k{k}_t{t}_c{3 * f}_r{r}"
                out.setdefault(key, []).append(dict(
                    seed=seed, vs_plain=rel_err(got, want)[1],
                    vs_float64=[e / top for e in errs],
                    vs_float64_terms=[e / scale for e in errs]))
    return out


def project_float64_errors(v, got, plain, t=TRAIN_T, hi=TRAIN_CUTOFF):
    """Row 6's output ``got`` and its plain version's ``plain`` against the
    same function in float64: ``{"same_theta": [kernel, plain],
    "float64_theta": [kernel, plain]}``, max abs error / max |float64|,
    the reference from the plain version's fp32 θ (the arguments ``j·θ``
    the plain version takes), or from θ in float64.  cos(j·θ) carries θ's
    last bit ~j-fold, so the two references differ by float32's θ; the
    kernel's θ is the plain version's float (``csrc/cheb_tile.cuh``)."""
    from torchmdnet_tpu_torch.ops.cheb import cheb_theta

    ct = v["ct"].double().reshape(-1, v["ct"].shape[-1])
    fm = v["fm"].double().reshape(-1, 1)
    out = {}
    for key, theta, j in (
            ("same_theta", cheb_theta(v["d"], 0.0, hi),
             torch.arange(t, device=v["d"].device, dtype=torch.float32)),
            ("float64_theta", cheb_theta(v["d"].double(), 0.0, hi),
             torch.arange(t, device=v["d"].device, dtype=torch.float64))):
        x = (theta[..., None] * j).reshape(-1, t)
        ref = (torch.cos(x.double()) * fm).t() @ ct
        del x
        top = float(ref.abs().max())
        out[key] = [float((r.double() - ref).abs().max()) / top
                    for r in (got, plain)]
    return out


def train_kernel_inputs(seed):
    """Row 6's operands on the training batch: the brute K=40 list of
    :func:`train_batch` (loop, ghosts masked), its distances, ``fm = (d <
    5) & mask`` and a random ``[N, K, 3F]`` cotangent."""
    from torchmdnet_tpu_torch.ops.neighbors import (
        build_neighbor_matrix, neighbor_geometry)

    b = train_batch()
    nbr = build_neighbor_matrix(
        b["pos"], b["batch"], strategy="brute", k_max=TRAIN_K,
        cutoff_upper=TRAIN_CUTOFF, loop=True,
        atom_mask=b["batch"] < TRAIN_MOLS)
    check(not bool(nbr.overflow), "training batch: neighbor overflow")
    _, d = neighbor_geometry(b["pos"], nbr)
    gen = torch.Generator(device=d.device).manual_seed(seed)
    return dict(d=d.contiguous(), fm=((d < TRAIN_CUTOFF) & nbr.mask).float(),
                ct=torch.randn(d.shape + (3 * F,), generator=gen,
                               device=d.device))


def project_calls(v, t=TRAIN_T, hi=TRAIN_CUTOFF):
    """Row 6 on ``v`` as a pair of (kernel, plain) callables."""
    from torchmdnet_tpu_torch.ops import cheb_filter as cf

    args = (v["d"], v["fm"], v["ct"], t, 0.0, hi)
    return {"cheb_project": (lambda: cf.cheb_project_cuda(*args),
                             lambda: cf.cheb_project_ref(*args))}


def project_work(v, t=TRAIN_T):
    """(FLOP, bytes) row 6 needs on ``v``: the product on the slots with
    fm ≠ 0, which the kernel runs on the tensor cores in 3xTF32; d and fm
    read once, ct only on those slots, the [T, C] output written once."""
    live = float((v["fm"] != 0).sum())
    c = v["ct"].shape[-1]
    return 2 * live * t * c, nbytes(v["d"], v["fm"]) + (live + t) * c * 4


def project_library(v, t=TRAIN_T, hi=TRAIN_CUTOFF):
    """One cuBLAS GEMM with the same operations: the fm-weighted cos basis
    of all slots, precomputed, transposed against ct."""
    from torchmdnet_tpu_torch.ops.cheb import cheb_theta, cos_basis

    basis = (cos_basis(cheb_theta(v["d"], 0.0, hi), t)
             * v["fm"][..., None]).reshape(-1, t)
    ct = v["ct"].reshape(-1, v["ct"].shape[-1])
    return lambda: basis.t() @ ct


def dhfr_blocked_spec(dhfr, grouped, cutoff=4.5):
    """``bench.py::main``'s spec (``:104-117``): tuned on all 2,560 rows at
    ``cutoff`` with 16-row blocks, grouped (``column_slots``) or not."""
    from torchmdnet_tpu_torch.ops.cell_blocks import tune_cell_block_spec

    _, pos, _, _, L = dhfr
    return tune_cell_block_spec(pos, [L] * 3, cutoff, cap=DHFR_CAP,
                                column_slots=grouped)


class BlockedDhfr:
    """``bench.py::main``'s blocked evaluation (``:131-167``) on the card:
    per call the cell-block sort of all rows (ghosts ride it), the
    sorted-space list (grouped: the column-partitioned cell list with
    K′ = Σ col_slots; ungrouped: brute K=64), the model with
    ``blocked=True``, and the forces back in the original order."""

    def __init__(self, dhfr, seg, spec):
        z, _, _, box, L = dhfr
        dev = torch.device("cuda")
        self.spec = spec
        self.zt = torch.as_tensor(z, device=dev)
        self.st = torch.as_tensor(seg, device=dev)
        self.bt = torch.as_tensor(box, device=dev)
        self.bd = torch.tensor([L] * 3, dtype=torch.float32, device=dev)
        self.kw = dict(strategy="brute", k_max=DHFR_K)
        if spec.col_slots is not None:
            nz = max(int(L // 4.5), 3)
            occ = DHFR_ATOMS / (spec.nx * spec.ny * nz)
            self.kw = dict(strategy="cell", k_max=sum(spec.col_slots),
                           cells_per_dim=(spec.nx, spec.ny, nz),
                           cell_capacity=int(np.ceil(occ * 2.5)) + 8,
                           column_partition=spec.col_slots)

    def sorted_inputs(self, p):
        from torchmdnet_tpu_torch.ops.cell_blocks import plan_cell_blocks
        from torchmdnet_tpu_torch.ops.neighbors import build_neighbor_matrix

        blocks = plan_cell_blocks(p, self.bd, self.spec)
        perm = torch.clamp(blocks.perm, max=p.shape[0] - 1)
        batch_perm = self.st[perm]
        am = blocks.mask_rows & (batch_perm < 1)
        pos_s = torch.where(am[:, None], p[perm], 0.0)
        zs = torch.where(am, self.zt[perm], 0)
        batchs = torch.where(am, batch_perm, 1)
        nbr = build_neighbor_matrix(pos_s, batchs, atom_mask=am,
                                    cutoff_upper=4.5, loop=True, box=self.bt,
                                    **self.kw)
        return blocks, zs, pos_s, batchs, nbr

    def __call__(self, pot, p):
        blocks, zs, pos_s, batchs, nbr = self.sorted_inputs(p)
        y, f = pot.apply(zs, pos_s, batchs, num_mols=1, box=self.bt,
                         nbr=nbr, blocked=True)
        return y, f[blocks.inv_perm]


def group_counts(spec, mask):
    """The largest count of valid slots any row has in each slot group
    (one group without ``col_slots``)."""
    sizes = spec.col_slots or (mask.shape[1],)
    bounds = np.cumsum((0,) + tuple(sizes))
    return [int(mask[:, a:b].sum(1).max()) for a, b in
            zip(bounds[:-1], bounds[1:])]


def dhfr_blocked_inputs(ev, pos, seed):
    """The sorted-space list ``ev`` builds at the dhfr positions and
    operands for rows 8-11: its distances, ``fm = (d < 4.5) & mask``, the
    exact edge weights (random edge MLP on the rbf ``x``, times the cosine
    cutoff ``cw``: kernel 4's operands on this list) as row 8's attr, the
    series fitted from the same MLP, random feature rows and a row
    cotangent."""
    from torchmdnet_tpu_torch.models.common import make_rbf
    from torchmdnet_tpu_torch.ops import rbf
    from torchmdnet_tpu_torch.ops.cheb import cheb_deriv_coeffs
    from torchmdnet_tpu_torch.ops.edge_mlp import edge_mlp_ref
    from torchmdnet_tpu_torch.ops.neighbors import neighbor_geometry

    _, _, pos_s, _, nbr = ev.sorted_inputs(pos)
    check(not bool(nbr.overflow), "dhfr blocked kernel inputs: overflow")
    _, d = neighbor_geometry(pos_s, nbr, box=ev.bt)
    dev = d.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, _ = d.shape

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    mlp = [randn(R, F, scale=R ** -0.5), randn(F, scale=0.1),
           randn(F, 2 * F, scale=F ** -0.5), randn(2 * F, scale=0.1),
           randn(2 * F, 3 * F, scale=(2 * F) ** -0.5), randn(3 * F, scale=0.1)]
    x = make_rbf("expnorm", 0.0, 4.5, R, False).to(dev)(d)
    cw = rbf.cosine_cutoff(d, 4.5, 0.0) * nbr.mask
    coeffs = fitted_coeffs(mlp, DHFR_T, 4.5)
    v = dict(idx=nbr.idx, mask=nbr.mask, d=d.contiguous(),
             fm=((d < 4.5) & nbr.mask).float(), x=x.contiguous(),
             cw=cw.contiguous(), mlp=mlp,
             attr=edge_mlp_ref(x, cw, *mlp).contiguous(), coeffs=coeffs,
             dser=cheb_deriv_coeffs(coeffs).contiguous(),
             feats=randn(n, 9 * F), g9=randn(n, 9 * F))
    return v, group_counts(ev.spec, nbr.mask)


def blocked_calls(v, hi=4.5):
    """Rows 8-11 on ``v``, each as a pair of (kernel, plain) callables."""
    from torchmdnet_tpu_torch.ops import blocked_mp as bm

    s_args = (v["attr"], v["feats"], v["idx"], v["mask"])
    a_args = (v["g9"], v["feats"], v["idx"], v["mask"])
    c_args = (v["coeffs"], v["d"], v["fm"], v["feats"], v["idx"], 0.0, hi)
    d_args = (v["dser"], v["d"], v["fm"], v["g9"], v["feats"], v["idx"],
              0.0, hi)
    return {"blocked_mp_sum": (lambda: bm.neighbor_sum_cuda(*s_args),
                               lambda: bm.neighbor_sum_ref(*s_args)),
            "blocked_mp_dattr": (lambda: bm.dattr_cuda(*a_args),
                                 lambda: bm.dattr_ref(*a_args)),
            "blocked_mp_sum_cheb": (lambda: bm.neighbor_sum_cheb_cuda(*c_args),
                                    lambda: bm.neighbor_sum_cheb_ref(*c_args)),
            "blocked_mp_dd_cheb": (lambda: bm.dd_cheb_cuda(*d_args),
                                   lambda: bm.dd_cheb_ref(*d_args))}


def blocked_work(v):
    """(FLOP, bytes, tensor-core FLOP) rows 8-11 need on ``v``: rows 8 and
    9 work on the valid slots (mask), rows 10 and 11 on the live ones (fm
    ≠ 0), whose series product dominates and runs on the tensor cores in
    3xTF32; each input read once (the flag array whole, the per-slot
    arrays on the slots the kernel reads), each output written once — row
    9's whole [N, K, 3F], zeros included."""
    n, k = v["idx"].shape
    c3, c9, t = 3 * F, 9 * F, v["coeffs"].shape[0]
    valid = float(v["mask"].sum())
    live = float((v["fm"] != 0).sum())
    rows9 = n * c9 * 4
    product = 2 * live * t * c3
    return {
        "blocked_mp_sum": (2 * valid * c9,
                           n * k + valid * (8 + c3 * 4) + 2 * rows9, 0.0),
        "blocked_mp_dattr": (2 * valid * c9,
                             n * k + valid * 8 + 2 * rows9 + n * k * c3 * 4,
                             0.0),
        "blocked_mp_sum_cheb": (product + 2 * live * c9,
                                n * k * 4 + live * 12 + t * c3 * 4
                                + 2 * rows9, product),
        "blocked_mp_dd_cheb": (product + 2 * live * (c9 + c3),
                               n * k * 4 + live * 12 + t * c3 * 4
                               + 2 * rows9 + n * k * 4, product)}


def blocked_library(v):
    """The cuBLAS product carrying rows 10 and 11's operations: the cos
    basis of the live slots [live, T] times the [T, 3F] series, the basis
    given (as for rows 5 and 7)."""
    from torchmdnet_tpu_torch.ops.cheb import cheb_theta, cos_basis

    live = v["fm"] != 0
    basis = cos_basis(cheb_theta(v["d"][live], 0.0, 4.5), DHFR_T)
    return {"blocked_mp_sum_cheb": lambda: torch.matmul(basis, v["coeffs"]),
            "blocked_mp_dd_cheb": lambda: torch.matmul(basis, v["dser"])}


def gather_list_cw(system):
    """Kernel 3's slot weights on the lattice's gather-path MD list (the
    rebuild of ``md/integrators.py``: K slots at 4.5 Å + SKIN, the cell
    strategy, self slots in): the cosine cutoff at 4.5 Å times the mask,
    [N, K]."""
    from torchmdnet_tpu_torch.ops import rbf
    from torchmdnet_tpu_torch.ops.neighbors import (
        build_neighbor_matrix, neighbor_geometry)

    _, pos, _, box, L = system
    dev = torch.device("cuda")
    pt = torch.as_tensor(pos, device=dev)
    bt = torch.as_tensor(box, device=dev)
    nz = max(int(L // (4.5 + SKIN)), 3)
    nbr = build_neighbor_matrix(
        pt, torch.zeros(len(pos), dtype=torch.long, device=dev),
        strategy="cell", k_max=K, cutoff_upper=4.5 + SKIN, loop=True, box=bt,
        cells_per_dim=(nz, nz, nz))
    check(not bool(nbr.overflow), "gather MD list: neighbor overflow")
    _, d = neighbor_geometry(pt, nbr, box=bt)
    return (rbf.cosine_cutoff(d, 4.5, 0.0) * nbr.mask).contiguous()


def edge_pre_inputs(cw, seed, f=F):
    """Kernel 3's operands on the slot weights ``cw`` [N, K]: pre1 [N, K,
    f] ~ N(0, 1) and W2, b2, W3, b3 in ``Linear``'s uniform range, from
    ``seed``."""
    gen = torch.Generator(device=cw.device).manual_seed(seed)

    def uniform(*shape, fan):
        return (torch.rand(shape, generator=gen, device=cw.device) * 2 - 1) \
            / math.sqrt(fan)

    return [torch.randn(cw.shape + (f,), generator=gen, device=cw.device),
            cw, uniform(f, 2 * f, fan=f), uniform(2 * f, fan=f),
            uniform(2 * f, 3 * f, fan=2 * f), uniform(3 * f, fan=2 * f)]


def edge_pre_calls(w):
    """Kernel 3 and its plain chain on the operands ``w``."""
    from torchmdnet_tpu_torch.ops import edge_mlp as em

    return (lambda: em.edge_mlp_pre_cuda(*w),
            lambda: em.edge_mlp_pre_ref(*w))


def edge_pre_row(peak, w):
    """Kernel 3 against its plain chain on ``w``: errors (the cw = 0 slots
    must be exact zeros), CUDA-event and profiler device times of both, the
    bound (the live slots' products at the 3xTF32 rate; their pre1 rows,
    cw and the whole output once) and the plain cuBLAS chain as the
    library yardstick."""
    kern, plain = edge_pre_calls(w)
    err, rel, got = compare(kern, plain)
    check(not got[0][w[1] == 0].any(), "edge_mlp_pre: a cw = 0 slot is not 0")
    live = int((w[1] != 0).sum())
    f = w[0].shape[-1]
    flops = live * 2 * (f * 2 * f + 2 * f * 3 * f)
    nb = live * f * 4 + nbytes(*w[1:], got[0])
    del got
    b_ms, b_by = bound(flops, nb, peak, flops)
    return dict(max_abs_err=err, max_rel_err=rel, ms=time_ms(kern),
                plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(plain), **device_times(kern, plain),
                live_slots=live, gflop=flops / 1e9, gbytes=nb / 1e9)


EMB_NAMES = ("dea", "dC", "dvx", "dvy", "dvz", "dzw1", "dzw2g", "dkall",
             "dball")
# kernel 2's forms: row name → (want_dz, want_dk, form); the first is the
# main path's (MD and inference run on frozen weights)
EMB_FORMS = {"radial_embedding_bwd": (False, False, "no dz, no dk: the main "
                                      "path's"),
             "radial_embedding_bwd_dz": (True, False, "dz"),
             "radial_embedding_bwd_dkall": (True, True, "dz and dk")}


def emb_needs(dz, dk):
    """``needs`` of the plain backward for kernel 2's form (dz, dk)."""
    return [True] * 5 + [dz, dz, False, dk, dk]


def emb_bytes(x, valid, *dense):
    """Bytes kernels 1 and 2 must move on ``x``: the ``valid`` slots' rows
    of ea, zw2g, C and v̂ (a masked slot is never read), the mask, zw1,
    kall and ball whole, and ``dense`` (g and the outputs, whose masked
    slots are written as zeros) whole."""
    r, f = x[0].shape[-1], x[5].shape[-1]
    return valid * 4 * (r + f + 4) + nbytes(x[5], x[7], x[8], x[9], *dense)


def embedding_rows(peak, x, g):
    """Kernels 1 and 2 (each form of :data:`EMB_FORMS`) on ``x``, ``g``
    against their plain versions: the error of each output, ms, device
    ms, plain ms and the bound (:func:`emb_bytes`; the products ``ea·kall``,
    in kernel 2 also ``dd·kallᵀ``, and with dk ``eaᵀ·dd`` and Σ dd, run on
    the tensor cores in 3xTF32 over the valid slots; the fp32 rest is the
    elementwise chain and the sums, ~23F a slot forward, ~50F backward).
    Rows ``…@wide``: the same kernels with their tiles in device memory
    (the form of F past the shared-memory tiles), error and device ms."""
    from torchmdnet_tpu_torch.ops import radial_embedding as re_ops

    n, k, r = x[0].shape
    f = x[5].shape[-1]
    valid = float((x[7] != 0).sum())
    rows = {}
    out_k = re_ops.radial_embedding_fwd_cuda(*x)
    out_p = re_ops.radial_embedding_ref(*x)
    torch.cuda.synchronize()
    check(torch.isfinite(out_k).all(), "radial_embedding_fwd: non-finite")
    err, rel = rel_err(out_k, out_p)
    tc = valid * 2 * r * 3 * f
    flops, nb = tc + valid * 23 * f, emb_bytes(x, valid, out_k)
    b_ms, b_by = bound(flops, nb, peak, tc)
    rows["radial_embedding_fwd"] = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=time_ms(lambda: re_ops.radial_embedding_fwd_cuda(*x)),
        device_ms=device_ms(lambda: re_ops.radial_embedding_fwd_cuda(*x)),
        plain_ms=time_ms(lambda: re_ops.radial_embedding_ref(*x)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, gflop=flops / 1e9,
        tc_gflop=tc / 1e9, gbytes=nb / 1e9)
    wide = re_ops.radial_embedding_fwd_cuda(*x, wide=True)
    err, rel = rel_err(wide, out_p)
    rows["radial_embedding_fwd@wide"] = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=time_ms(lambda: re_ops.radial_embedding_fwd_cuda(*x, wide=True)),
        device_ms=device_ms(
            lambda: re_ops.radial_embedding_fwd_cuda(*x, wide=True)))
    del out_k, out_p, wide
    for name, (dz, dk, form) in EMB_FORMS.items():
        needs = emb_needs(dz, dk)
        got = re_ops.radial_embedding_bwd_cuda(x, g, dz, dk)
        ref = re_ops.radial_embedding_bwd_ref(x, g, needs)
        torch.cuda.synchronize()
        outs = [t for t in got if t is not None]
        check(all(torch.isfinite(t).all() for t in outs),
              f"{name}: non-finite")
        errs = {o: rel_err(a, b) for o, a, b in zip(EMB_NAMES, got, ref)
                if b is not None}
        tc = valid * 2 * (2 * r * 3 * f + ((r + 1) * 3 * f if dk else 0))
        flops, nb = tc + valid * 50 * f, emb_bytes(x, valid, g, *outs)
        b_ms, b_by = bound(flops, nb, peak, tc)
        rows[name] = dict(
            form=form, max_abs_err=max(e[0] for e in errs.values()),
            max_rel_err=max(e[1] for e in errs.values()),
            rel_err={o: e[1] for o, e in errs.items()},
            ms=time_ms(lambda: re_ops.radial_embedding_bwd_cuda(
                x, g, dz, dk)),
            device_ms=device_ms(lambda: re_ops.radial_embedding_bwd_cuda(
                x, g, dz, dk)),
            plain_ms=time_ms(lambda: re_ops.radial_embedding_bwd_ref(
                x, g, needs), reps=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            gflop=flops / 1e9, tc_gflop=tc / 1e9, gbytes=nb / 1e9)
        del got, outs
        got = re_ops.radial_embedding_bwd_cuda(x, g, dz, dk, wide=True)
        errs = [rel_err(a, b) for a, b in zip(got, ref) if b is not None]
        rows[name + "@wide"] = dict(
            form=form, max_abs_err=max(e[0] for e in errs),
            max_rel_err=max(e[1] for e in errs),
            ms=time_ms(lambda: re_ops.radial_embedding_bwd_cuda(
                x, g, dz, dk, wide=True)),
            device_ms=device_ms(lambda: re_ops.radial_embedding_bwd_cuda(
                x, g, dz, dk, wide=True)))
        del got, ref
        torch.cuda.empty_cache()
    return rows


def phase_kernels(peak, system, dhfr, seg, specs):
    from torchmdnet_tpu_torch.ops import edge_mlp as em

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    rows, geometry = {}, {}

    # kernels 1 and 2: the embedding forward, and the backward in the
    # main path's form (frozen weights: no dzw, no dkall), with dzw1/dzw2g
    # and with dkall/dball too
    x = embedding_inputs(gen, dev)
    g = torch.randn((N_ATOMS, 9 * F), generator=gen, device=dev)
    rows.update(embedding_rows(peak, x, g))
    del x, g
    torch.cuda.empty_cache()

    # kernel 3: edge MLP tail, one of the four calls of a gather-path
    # evaluation, on the gather MD list's slot weights, then with every
    # slot live
    cw = gather_list_cw(system)
    geometry["gather"] = {"rows": cw.shape[0], "k": K, "slots": cw.numel(),
                          "live_slots": int((cw != 0).sum())}
    dense = torch.rand(cw.shape, generator=gen, device=dev) * 0.5 + 0.5
    for name, weights in (("edge_mlp_pre", cw), ("edge_mlp_pre_dense", dense)):
        rows[name] = edge_pre_row(peak, edge_pre_inputs(weights, 31))
        torch.cuda.empty_cache()
    del cw, dense

    # kernels A, A with du, B (tabulated and exact base) and C, D on the
    # lattice's real blocked geometry (the MD rebuild's: lists at cutoff +
    # skin, windows at the Coulomb cutoff + skin), then A and B on the
    # grouped tier's column-partitioned K′ list of the same lattice
    _, pos, _, _, L = system
    spec, wspec, q, wv = blocked_inputs(
        pos, L, CAP, K, F, Q_TAB, C_CH, 4.5 + SKIN, COULOMB_RC + SKIN, 77)
    work = q_work(q, F, Q_TAB)
    work.update(wc_work(wv, COULOMB_RC + SKIN, C_CH))
    calls = q_calls(q)
    calls.update(wc_calls(wv, COULOMB_RC + SKIN))
    kernel_rows(rows, peak, calls, work, q["mask"])
    pairs = {"k96": pair_deltas_row(peak, wv["pos_s"], wv["box"], q)}
    cand, inside, window_rows, staged = work["pairs"]
    geometry.update({"n_pad": spec.n_pad, "blocks": spec.n_blocks,
                "nx": spec.nx, "nzf": spec.nzf, "stencil_s": wspec.s,
                "cut_bins": wspec.cut_bins, "k": K,
                "valid_slots": int(q["mask"].sum()),
                "live_slots": int((q["cw"] != 0).sum()),
                "window_pairs": cand, "pairs_inside_rc": inside,
                "window_rows": window_rows,
                "wc_staged_gbytes": staged / 1e9})
    del q, wv
    torch.cuda.empty_cache()
    spec, _, q, wv = blocked_inputs(pos, L, CAP, K, F, Q_TAB, C_CH,
                                    4.5 + SKIN, COULOMB_RC + SKIN, 78,
                                    grouped=True)
    kernel_rows(rows, peak, q_calls(q, "_grouped"),
                q_work(q, F, Q_TAB, "_grouped"), q["mask"])
    pairs["grouped"] = pair_deltas_row(peak, wv["pos_s"], wv["box"], q)
    pairs["charge_gather"] = charge_gather_row(peak, (wv["ct"] == 0).long())
    emit({"phase": "pair_deltas", "tolerance": PAIR_TOL,
          "charge_gather_tolerance": TOL, "cases": pairs})
    for name, row in pairs.items():
        tol = TOL if name == "charge_gather" else PAIR_TOL
        check(row["max_rel_err"] <= tol,
              f"pair_deltas {name}: {row['max_rel_err']:.3g} of max |plain|")
    geometry["grouped"] = {
        "n_pad": spec.n_pad, "k": q["idx"].shape[1],
        "col_slots": spec.col_slots, "valid_slots": int(q["mask"].sum()),
        "live_slots": int((q["cw"] != 0).sum()),
        "max_per_group": group_counts(spec, q["mask"])}
    del q, wv
    torch.cuda.empty_cache()

    # kernels 4, 5 and 7 on the dhfr system's real brute K=64 list
    v = dhfr_inputs(dhfr, seg, 55)
    work, library = dhfr_work(v), dhfr_library(v)
    for name, (kern, plain) in dhfr_calls(v).items():
        err, rel, got = compare(kern, plain)
        if name.startswith("cheb"):
            check(not got[0][v["fm"] == 0].any(),
                  f"{name}: an fm = 0 slot is not exactly 0")
        else:
            check(not got[0][v["cw"] == 0].any(),
                  f"{name}: a cw = 0 slot is not exactly 0")
        flops, nb, tc = work[name]
        b_ms, b_by = bound(flops, nb, peak, tc)
        rows[name] = dict(
            max_abs_err=err, max_rel_err=rel, ms=time_ms(kern),
            plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(library[name]),
            **device_times(kern, library[name]), gflop=flops / 1e9,
            gbytes=nb / 1e9)
        if name.startswith("cheb"):
            rows[name]["vs_float64"] = float64_errors(v, name, got[0],
                                                      plain())
        del got
    geometry["dhfr"] = {"rows": v["d"].shape[0], "k": DHFR_K,
                        "t": DHFR_T, "slots": v["d"].numel(),
                        "fm_slots": int(v["fm"].sum()),
                        "cw_slots": int((v["cw"] != 0).sum())}
    del v, library
    torch.cuda.empty_cache()

    # row 6 on the training batch's brute K=40 list: its product on the
    # tensor cores in 3xTF32, the bound at that rate; two calls bitwise
    # equal (fixed-order sums, no atomics)
    v = train_kernel_inputs(88)
    (kern, plain), = project_calls(v).values()
    err, rel, got = compare(kern, plain)
    check(torch.equal(got[0], kern()),
          "cheb_project: two calls differ (the sums must be deterministic)")
    flops, nb = project_work(v)
    b_ms, b_by = bound(flops, nb, peak, flops)
    library = project_library(v)
    rows["cheb_project"] = dict(
        max_abs_err=err, max_rel_err=rel, ms=time_ms(kern),
        plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(library), **device_times(kern, library),
        gflop=flops / 1e9, gbytes=nb / 1e9,
        vs_float64=project_float64_errors(v, got[0], plain()))
    geometry["train"] = {"rows": v["d"].shape[0], "k": TRAIN_K,
                         "t": TRAIN_T, "slots": v["d"].numel(),
                         "fm_slots": int((v["fm"] != 0).sum())}
    del v, got, library
    torch.cuda.empty_cache()

    # rows 8-11 on the dhfr system's cell-blocked sort: the grouped K′ list
    # (the bench default, the table's row) and the brute K=64 one; kernel 4
    # on the grouped list too (the dhfr blocked exact path's)
    pos = torch.as_tensor(dhfr[1], device=dev)
    geometry["dhfr_blocked"] = {}
    for layout, spec in specs.items():
        v, groups = dhfr_blocked_inputs(BlockedDhfr(dhfr, seg, spec), pos, 66)
        work, library = blocked_work(v), blocked_library(v)
        calls = blocked_calls(v)
        if layout == "grouped":  # kernel 4 on the dhfr blocked exact list
            w4 = [v["x"], v["cw"], *v["mlp"]]
            calls["edge_mlp"] = (lambda: em.edge_mlp_cuda(*w4),
                                 lambda: em.edge_mlp_ref(*w4))
            work["edge_mlp"] = fused_work(v)
            library["edge_mlp"] = calls["edge_mlp"][1]
        for name, (kern, plain) in calls.items():
            err, rel, got = compare(kern, plain)
            if name == "edge_mlp":
                check(not got[0][v["cw"] == 0].any(),
                      "edge_mlp: a cw = 0 slot of the blocked list is not 0")
            if name == "blocked_mp_sum":
                check(not got[0][~v["mask"].any(1)].any(),
                      "blocked_mp_sum: a row with no valid slot is not 0")
            if name == "blocked_mp_dattr":
                check(not got[0][~v["mask"]].any(),
                      "blocked_mp_dattr: an invalid slot is not exactly 0")
            if name == "blocked_mp_dd_cheb":
                check(not got[0][v["fm"] == 0].any(),
                      "blocked_mp_dd_cheb: an fm = 0 slot is not exactly 0")
            flops, nb, tc = work[name]
            b_ms, b_by = bound(flops, nb, peak, tc)
            lib = library.get(name)
            row = dict(
                max_abs_err=err, max_rel_err=rel, ms=time_ms(kern),
                plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
                library_ms=None if lib is None else time_ms(lib),
                gflop=flops / 1e9, gbytes=nb / 1e9)
            if lib is not None:
                row.update(device_times(kern, lib))
            else:
                row["device_ms"] = device_ms(kern)
            key = name if layout == "grouped" else f"{name}@{layout}"
            rows["edge_mlp@dhfr_blocked" if name == "edge_mlp" else key] = row
            del got
        geometry["dhfr_blocked"][layout] = {
            "n_pad": spec.n_pad, "blocks": spec.n_blocks,
            "k": v["idx"].shape[1], "col_slots": spec.col_slots,
            "valid_slots": int(v["mask"].sum()),
            "live_slots": int((v["fm"] != 0).sum()),
            "max_per_group": groups}
        del v, library
        torch.cuda.empty_cache()

    emit({"phase": "kernels", "tolerance": TOL, "cheb_tolerance": CHEB_TOL,
          "edge_tolerance": EDGE_TOL, "emb_tolerance": EMB_TOL,
          "geometry": geometry, "rows": rows})
    for name, row in rows.items():
        tol = limit(name)
        check(row["max_rel_err"] <= tol,
              f"{name}: max rel err {row['max_rel_err']:.3g} > {tol}")
    return rows


def edge_pre_shape_errors(gen, cases=((50, 45, 36), (37, 13, 36),
                                      (9, 100, 132), (7, 96, 256),
                                      (300, 40, 264), (11, 96, 512))):
    """Kernel 3 against its plain version where its tiles, windows and
    passes are ragged: F = 36 (2F and 3F end in partial 128-column passes)
    and F = 132 and 256 (a layer-1 pass held in registers), F = 264 and
    512 (the wide form: tiles in device memory), slot counts that are not
    a multiple of the 1,024-slot window, ~40% of the slots live, and at F
    = 36 and 264 a window with no live slot followed by one with every
    slot live; the cw = 0 slots exact zeros, and the kernel launched."""
    from torchmdnet_tpu_torch.ops import edge_mlp as em

    dev = torch.device("cuda")
    worst = {}
    for n, k, f in cases:
        shape = (n, k)
        cw = torch.rand(shape, generator=gen, device=dev) * (
            torch.rand(shape, generator=gen, device=dev) < 0.4)
        span = em.WINDOW
        flat = cw.view(-1)
        if flat.numel() > 2 * span:
            flat[:span] = 0.0
            flat[span:2 * span] = torch.rand(span, generator=gen,
                                             device=dev) + 0.1
        kern, plain = edge_pre_calls(edge_pre_inputs(cw, n * k + f, f))
        before = launch_counts()
        err, rel, got = compare(kern, plain)
        check_launched(["edge_mlp_pre"], before)
        check(not got[0][cw == 0].any(),
              f"edge_mlp_pre (F={f}): a cw = 0 slot is not exactly 0")
        worst[f"edge_mlp_pre_n{n}_k{k}_f{f}_ragged"] = rel
    return worst


def fused_shape_errors(gen, cases=((9, 61, 64, 256), (7, 45, 32, 512),
                                   (5, 13, 4, 1024), (11, 29, 160, 256),
                                   (300, 40, 36, 132), (3000, 100, 12, 20))):
    """Kernel 4 in each of its forms: (R, F) = (64, 256) narrow, (32, 512)
    and (4, 1024) wide (tiles in device memory), (160, 256) wide because
    its x tile would not fit a block, (36, 132) and (12, 20) narrow with
    partial 16-row stages of W1 and partial 128-column passes; slot counts
    not a multiple of the tile, the 256-slot chunk or the 1,024-slot
    window, ~40% of the slots with cw = 0 (exact zeros there), at (12, 20)
    and (36, 132) a window with no live slot followed by one with every
    slot live and several windows a block; the kernel launched."""
    from torchmdnet_tpu_torch.ops import edge_mlp as em

    dev = torch.device("cuda")
    worst = {}
    for n, k, r, f in cases:
        def randn(*shape, scale):
            return torch.randn(shape, generator=gen, device=dev) * scale

        cw = torch.rand((n, k), generator=gen, device=dev) * (
            torch.rand((n, k), generator=gen, device=dev) < 0.6)
        span = em.WINDOW
        flat = cw.view(-1)
        if flat.numel() > 2 * span:
            flat[:span] = 0.0
            flat[span:2 * span] = torch.rand(span, generator=gen,
                                             device=dev) + 0.1
        w = [torch.rand((n, k, r), generator=gen, device=dev), cw,
             randn(r, f, scale=r ** -0.5), randn(f, scale=0.1),
             randn(f, 2 * f, scale=f ** -0.5), randn(2 * f, scale=0.1),
             randn(2 * f, 3 * f, scale=(2 * f) ** -0.5),
             randn(3 * f, scale=0.1)]
        before = launch_counts()
        err, rel, got = compare(lambda: em.edge_mlp_cuda(*w),
                                lambda: em.edge_mlp_ref(*w))
        check_launched(["edge_mlp"], before)
        check(not got[0][cw == 0].any(),
              f"edge_mlp (R={r}, F={f}): a cw = 0 slot is not exactly 0")
        form = "wide" if em.chain_wide(f, r) else "narrow"
        worst[f"edge_mlp_n{n}_k{k}_r{r}_f{f}_{form}"] = rel
    return worst


def shape_case_inputs(gen, n, k, t, f, r, hi=4.5):
    """Kernels 4, 5 and 7's operands for one case of
    :func:`dhfr_shape_errors` (``n`` rows of ``k`` slots, ``t`` series
    terms, ``3f`` channels, ``r`` rbf), drawn from ``gen``: distances up to
    1.2 hi with 0, hi and 1.1 hi in row 0, row 1 masked, random edge-MLP
    weights and the series fitted from them, the rbf and a cotangent."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    d = torch.rand((n, k), generator=gen, device=dev) * 1.2 * hi
    d[0, :3] = torch.tensor([0.0, hi, 1.1 * hi], device=dev)
    mask = torch.rand((n, k), generator=gen, device=dev) < 0.8
    mask[1] = False
    mlp = [randn(r, f) * 0.3, randn(f) * 0.1, randn(f, 2 * f) * 0.2,
           randn(2 * f) * 0.1, randn(2 * f, 3 * f) * 0.2,
           randn(3 * f) * 0.1]
    return dict(d=d, fm=((d < hi) & mask).float(),
                cw=torch.where(mask & (d < hi),
                               torch.cos(d * math.pi / hi) * 0.5 + 0.5, 0.0),
                x=torch.rand((n, k, r), generator=gen, device=dev),
                coeffs=fitted_coeffs(mlp, t, hi), ct=randn(n, k, 3 * f),
                mlp=mlp)


def dhfr_shape_errors(gen, cases=((37, 8, 16, 8, 8), (50, 33, 64, 32, 16),
                                   (29, 96, 128, 128, 32),
                                   (41, 64, 100, 64, 8),
                                   (23, 360, 128, 128, 32),
                                   (45, 40, 128, 128, 32),
                                   (31, 64, 128, 68, 16))):
    """Kernels 4, 5 and 7 against their plain versions: slot counts not a
    multiple of a block's span or a 64-slot tile, K 8-360 (and 40, the
    training list's), T 16-128 (and 100, not a multiple of the 16-row
    stage), 3F 24-384 (and 204, not a multiple of the 128-column pass), R
    8-32, a row with fm = cw = 0 throughout, and d at 0, at hi and above
    hi; the fm = 0 slots of 5 and 7 exact zeros."""
    worst = {}
    hi = 4.5
    for n, k, t, f, r in cases:
        v = shape_case_inputs(gen, n, k, t, f, r, hi)
        calls = dhfr_calls(v, hi)
        errs = [compare(*pair)[1] for pair in calls.values()]
        outs = {name: kern() for name, (kern, _) in calls.items()}
        check(all(float(o[1].abs().max()) == 0.0 for o in outs.values()),
              "kernels 4/5/7: a masked row is not zero")
        check(not outs["cheb_filter"][v["fm"] == 0].any()
              and not outs["cheb_filter_dot"][v["fm"] == 0].any(),
              "kernels 5/7: an fm = 0 slot is not exactly 0")
        for name, err in zip(calls, errs):
            worst[f"{name}_n{n}_k{k}_t{t}_c{3 * f}_r{r}"] = err
    return worst


def project_shape_errors(gen, cases=((19, 7, 16, 8), (33, 13, 48, 20),
                                     (70, 40, 128, 384), (11, 3, 130, 12),
                                     (300, 40, 128, 384))):
    """Row 6 against its plain version: slot counts that are not a
    multiple of a 64-slot tile or a 256-slot span, T 16-130 (130: two
    series-row tiles), C 8-384, a row with fm = 0 throughout, fm weights
    that are not 0/1, and d at 0, at hi and above hi."""
    dev = torch.device("cuda")
    worst = {}
    hi = TRAIN_CUTOFF
    for n, k, t, c in cases:
        d = torch.rand((n, k), generator=gen, device=dev) * 1.2 * hi
        d[0, :3] = torch.tensor([0.0, hi, 1.1 * hi], device=dev)
        fm = ((d < hi) & (torch.rand((n, k), generator=gen, device=dev)
                          < 0.8)).float()
        fm[1] = 0.0
        fm[2] *= 0.37
        v = dict(d=d, fm=fm, ct=torch.randn((n, k, c), generator=gen,
                                            device=dev))
        kern, plain = project_calls(v, t, hi)["cheb_project"]
        worst[f"project_n{n}_k{k}_t{t}_c{c}"] = compare(kern, plain)[1]
    return worst


def blocked_shape_errors(gen, cases=((37, 8, 8, 16), (50, 33, 32, 64),
                                     (29, 96, 128, 128), (41, 64, 64, 100),
                                     (43, 224, 128, 128),
                                     (19, 37, 132, 16))):
    """Rows 8-11 against their plain versions on synthetic lists: row
    counts not a multiple of a block's 4 rows or tasks, K 8-224 (K′ = 224
    as the dhfr grouped list, 37 and 33 not a multiple of the 32-slot
    mask round), F 8-132 (132: two 128-channel groups of row 8's warps),
    T 16-128 (and 100, not a multiple of the 32-row tile), a masked row
    (row 8's output there exactly 0), an empty slot group, the self slot
    at d = 0 (θ = π), d at hi and beyond.  Rows 8 and 9 are held apart,
    to their own limit."""
    dev = torch.device("cuda")
    worst = {}
    from torchmdnet_tpu_torch.ops.cheb import cheb_deriv_coeffs

    hi = 4.5
    for n, k, f, t in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        rows = torch.arange(n, device=dev)[:, None]
        mask = torch.rand((n, k), generator=gen, device=dev) < 0.8
        mask[:, k // 4:k // 2] = False  # an empty group
        mask[:, 0] = True               # the self slot
        mask[1] = False                 # a masked row
        idx = torch.randint(0, n, (n, k), generator=gen, device=dev)
        idx[:, 0] = rows[:, 0]
        idx = torch.where(mask, idx, rows)
        d = torch.rand((n, k), generator=gen, device=dev) * 1.2 * hi
        d[:, 0] = 0.0
        d[0, 1:3] = torch.tensor([hi, 1.1 * hi], device=dev)
        mlp = [randn(8, f) * 0.3, randn(f) * 0.1, randn(f, 2 * f) * 0.2,
               randn(2 * f) * 0.1, randn(2 * f, 3 * f) * 0.2,
               randn(3 * f) * 0.1]
        coeffs = fitted_coeffs(mlp, t, hi)
        v = dict(idx=idx, mask=mask, d=d, fm=((d < hi) & mask).float(),
                 attr=randn(n, k, 3 * f) * mask[..., None], coeffs=coeffs,
                 dser=cheb_deriv_coeffs(coeffs).contiguous(),
                 feats=randn(n, 9 * f), g9=randn(n, 9 * f))
        calls = blocked_calls(v, hi)
        errs = [compare(*pair)[1] for pair in calls.values()]
        outs = {name: kern() for name, (kern, _) in calls.items()}
        check(all(float(o[1].abs().max()) == 0.0 for o in outs.values()),
              "rows 8-11: a masked row is not zero")
        check(not outs["blocked_mp_dattr"][~mask].any(),
              "row 9: an invalid slot is not exactly 0")
        check(not outs["blocked_mp_dd_cheb"][v["fm"] == 0].any(),
              "row 11: an fm = 0 slot is not exactly 0")
        worst[f"blocked_mp_sum_n{n}_k{k}_f{f}"] = errs[0]
        worst[f"blocked_mp_dattr_n{n}_k{k}_f{f}"] = errs[1]
        worst[f"blocked_mp_n{n}_k{k}_f{f}_t{t}"] = max(errs[2:])
    return worst


def q_shape_errors(gen, cases=((37, 13, 12, 8, 5), (50, 330, 32, 16, 7),
                               (23, 40, 68, 16, 12), (21, 512, 128, 64, 32),
                               (19, 520, 128, 64, 32),
                               (23, 140, 132, 16, 12),
                               (19, 120, 140, 64, 160),
                               (17, 140, 256, 64, 32))):
    """Kernels A, A with du and B, both bases, on synthetic lists of
    grouped-tier widths: K′ not a multiple of 4 or 16, up to 512 slots a
    row (one compaction pass) and 520 (two), rbf widths not a multiple of
    4, F = 68 (a held W3 pass whose columns pass 3F in the next), F = 132,
    140 and 256 (the wide form: tiles in device memory, two or more
    passes of the base and of W2ᵀ) and an rbf width of 160 (two passes of
    W1aᵀ), a row with no valid slot, a row whose slots are all valid with
    cw = 0 (both exact zeros in A's outputs), a row of 100 live slots
    (it spans two 64-slot tiles), an empty slot group, d at 0, at hi and
    beyond; every kernel launched."""
    dev = torch.device("cuda")
    worst = {}
    hi = 4.5
    for n, k, f, t, r in cases:
        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale

        rows = torch.arange(n, device=dev)[:, None]
        mask = torch.rand((n, k), generator=gen, device=dev) < 0.3
        mask[:, k // 4:k // 2] = False  # an empty group
        mask[1] = False                 # no valid slot
        idx = torch.where(mask, torch.randint(0, n, (n, k), generator=gen,
                                              device=dev), rows)
        d = torch.rand((n, k), generator=gen, device=dev) * 1.2 * hi
        d[0, :3] = torch.tensor([0.0, hi, 1.1 * hi], device=dev)
        d[2] = 1.1 * hi                 # valid slots, all with cw = 0
        if k >= 100:                    # 100 live slots: two tiles
            mask[3, :100] = True
            d[3, :100] = torch.rand(100, generator=gen, device=dev) * hi
        cw = torch.where(mask & (d < hi),
                         torch.cos(d * math.pi / hi) * 0.5 + 0.5, 0.0)
        q = dict(d=d, cw=cw, mask=mask, idx=idx, urow=randn(n, f, scale=0.5),
                 ucol=randn(n, f, scale=0.5), xwin=randn(n, 9 * f),
                 coeffs=randn(t, f) * (0.7 ** torch.arange(t, device=dev))[
                     :, None],
                 w2=randn(f, 2 * f, scale=f ** -0.5),
                 b2=randn(2 * f, scale=0.1),
                 w3=randn(2 * f, 3 * f, scale=(2 * f) ** -0.5),
                 b3=randn(3 * f, scale=0.1), grow=randn(n, 9 * f),
                 rbf=torch.rand((n, k, r), generator=gen, device=dev)
                 * mask[..., None], w1a=randn(r, f, scale=r ** -0.5))
        calls = q_calls(q)
        before = launch_counts()
        errs = {name: compare(*pair)[1] for name, pair in calls.items()}
        check_launched(calls, before)
        outs = {name: as_list(kern()) for name, (kern, _) in calls.items()}
        check(all(float(x[row].abs().max()) == 0.0 for name, o in
                  outs.items() if "_dq" not in name for x in o
                  for row in (1, 2)),
              "kernel A: a row with no live slot is not 0")
        check(not outs["blocked_q_dq_rbf"][1][~mask].any(),
              "kernel B (rbf): an invalid slot's cotangent is not 0")
        check(all(not o[j][~mask].any() for name, o in outs.items()
                  if "_dq" in name for j in (1, 2)),
              "kernel B: an invalid slot's dd, drbf or dcw is not 0")
        tag = f"n{n}_k{k}_f{f}_t{t}_r{r}"
        worst[f"blocked_q_fwd_{tag}"] = max(e for name, e in errs.items()
                                            if "_dq" not in name)
        worst[f"blocked_q_dq_{tag}"] = max(e for name, e in errs.items()
                                           if "_dq" in name)
    return worst


def emb_shape_errors(gen, cases=((37, 13, 8, 64), (50, 20, 16, 256),
                                 (33, 7, 32, 32), (21, 360, 32, 128),
                                 (19, 520, 50, 36), (23, 40, 64, 48),
                                 (17, 30, 64, 264), (9, 24, 50, 512),
                                 (37, 70, 64, 128), (5, 9, 3, 4),
                                 (18, 33, 130, 640))):
    """Kernels 1 and 2 in every form on small ragged shapes: rbf widths 3,
    8, 16, 32, 50, 64 and 130 (three 64-row blocks of dea and of dkall's
    columns), F from 4 to 640 (kernel 2's tiles in device memory above F =
    128, kernel 1's above 512), K up to 520 (two compaction passes of a
    16-row block), every row count ragged against the 16-row blocks, a row
    with no valid slot, and the last three rows ghosts (every slot masked):
    each kernel launched, its masked slots and empty rows exact zeros."""
    from torchmdnet_tpu_torch.ops import radial_embedding as re_ops

    dev = torch.device("cuda")
    worst = {}
    # (the fourth: the K′=360 grouped MD list of the dhfr blocked exact
    # path; then the rbf widths of the JAX CLI default and the examples,
    # 64, and channel widths the old kernels refused)
    for n, k, r, f in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        em = (torch.rand((n, k), generator=gen, device=dev) < 0.7).float()
        em[1] = 0.0       # no valid slot
        em[n - 3:] = 0.0  # ghost rows
        v = randn(n, k, 3)
        v = v / v.norm(dim=-1, keepdim=True)
        x = [torch.rand((n, k, r), generator=gen, device=dev), em * 0.5,
             v[..., 0].contiguous(), v[..., 1].contiguous(),
             v[..., 2].contiguous(), randn(n, f), randn(n, k, f) * em[..., None],
             em, randn(r, 3 * f) * 0.3, randn(3 * f) * 0.1]
        g = randn(n, 9 * f)
        masked, empty = em == 0, em.sum(1) == 0
        before = launch_counts()
        out = re_ops.radial_embedding_fwd_cuda(*x)
        errs = [rel_err(out, re_ops.radial_embedding_ref(*x))[1]]
        check(not out[empty].any(), "kernel 1: a row with no valid slot "
              "is not 0")
        for dz, dk, _ in EMB_FORMS.values():
            got = re_ops.radial_embedding_bwd_cuda(x, g, dz, dk)
            ref = re_ops.radial_embedding_bwd_ref(x, g, emb_needs(dz, dk))
            errs += [rel_err(a, b)[1] for a, b in zip(got, ref)
                     if b is not None]
            check(all(not t[masked].any() for t in got[:5])
                  and (not dz or (not got[6][masked].any()
                                  and not got[5][empty].any())),
                  "kernel 2: a masked slot's or an empty row's cotangent "
                  "is not 0")
        check_launched(("radial_embedding_fwd", "radial_embedding_bwd"),
                       before)
        worst[f"radial_embedding_n{n}_k{k}_r{r}_f{f}"] = max(errs)
    return worst


def odd_shape_errors():
    """Every kernel with a channel width at F = 30 (C = 90 for rows 5-7)
    and R = 50, widths its wrapper pads to multiples of 4 (Queue 3 item
    1), on the small ragged shapes of the functions above, from a
    generator of its own (the cases above keep their inputs)."""
    gen = torch.Generator(device="cuda").manual_seed(30)
    worst = emb_shape_errors(gen, ((21, 30, 50, 30),))
    worst.update(edge_pre_shape_errors(gen, ((50, 45, 30),)))
    worst.update(fused_shape_errors(gen, ((33, 40, 50, 30),)))
    worst.update(q_shape_errors(gen, ((29, 60, 30, 16, 50),)))
    worst.update(dhfr_shape_errors(gen, ((33, 40, 64, 30, 50),)))
    worst.update(project_shape_errors(gen, ((27, 20, 64, 90),)))
    worst.update(blocked_shape_errors(gen, ((23, 40, 30, 64),)))
    return worst


def phase_shapes():
    """Every kernel against its plain version at small ragged shapes:
    every compiled rbf width and a range of channel counts for kernels
    1-3; for A-D a partial last row block, ghost rows, several channel
    counts and block sizes, and z-wrapped window pieces (C and D also at
    C = 132 and 37 and at S = 6, their ghost rows exactly 0); for 4-7
    partial slot spans, masked rows and distances at and beyond hi; and
    the widths whose tiles do not fit a block's shared memory (kernels
    3, 4, A and B), each checked to have launched its kernel."""
    from torchmdnet_tpu_torch.ops import edge_mlp as em_ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    worst = emb_shape_errors(gen)
    for n, k, f in ((37, 13, 64), (50, 20, 256), (33, 7, 32), (21, 360, 128)):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        w = [randn(n, k, f), torch.rand((n, k), generator=gen, device=dev),
             randn(f, 2 * f) * 0.1, randn(2 * f) * 0.1,
             randn(2 * f, 3 * f) * 0.1, randn(3 * f) * 0.1]
        worst[f"edge_mlp_pre_n{n}_k{k}_f{f}"] = rel_err(
            em_ops.edge_mlp_pre_cuda(*w), em_ops.edge_mlp_pre_ref(*w))[1]

    # q-tier and windowed Coulomb on small random boxes: (atoms, box,
    # block rows, slots, channels, series terms, Coulomb channels, list
    # cutoff, Coulomb cutoff); C = 132 (three chunks of 48 channels) and
    # 37 (not a multiple of 4), and a 2 Å list under an 11.5 Å Coulomb
    # cutoff: S = 6, 169 stencil columns
    rng = np.random.RandomState(5)
    for n, L, cap, k, f, t, c, mrc, rc in (
            (150, 12.5, 8, 40, 32, 16, 8, 4.0, 4.0),
            (500, 19.0, 16, 96, 64, 32, 48, 5.5, 6.0),
            (400, 18.0, 32, 96, 128, 8, 20, 5.5, 5.5),
            (500, 19.0, 16, 96, 32, 16, 132, 5.5, 6.0),
            (400, 18.0, 8, 96, 32, 16, 37, 5.5, 5.5),
            (2200, 28.0, 32, 64, 32, 16, 20, 2.0, 11.5)):
        pos = rng.uniform(0, L, (n, 3)).astype(np.float32)
        spec, wspec, q, wv = blocked_inputs(pos, L, cap, k, f, t, c, mrc,
                                            rc, n)
        calls = q_calls(q)
        calls.update(wc_calls(wv, rc))
        errs = {}
        for name, pair in calls.items():
            _, errs[name], got = compare(*pair)
            if name.startswith("windowed"):
                ghost = ~wv["cwin"].row_valid
                check(ghost.any() and not any(x[ghost].any() for x in got),
                      f"{name}: a ghost row is not exactly 0")
        # the same rows cut short of a whole row block of the kernels
        cut = spec.n_pad - 5
        qc = dict(q, **{key: q[key][:cut] for key in
                        ("d", "cw", "mask", "urow", "ucol", "xwin", "grow",
                         "rbf")})
        qc["idx"] = torch.clamp(q["idx"][:cut], max=cut - 1)
        qc["mask"] = qc["mask"] & (q["idx"][:cut] < cut)
        errs.update({name + "_cut": compare(*pair)[1]
                     for name, pair in q_calls(qc).items()})
        tag = f"n{n}_cap{cap}_f{f}_c{c}_s{wspec.s}"
        worst[f"blocked_q_fwd_{tag}"] = max(
            e for name, e in errs.items() if name.startswith("blocked_q_fwd"))
        worst[f"blocked_q_dq_{tag}"] = max(e for name, e in errs.items()
                                           if "_dq" in name)
        worst[f"windowed_coulomb_{tag}"] = max(
            e for name, e in errs.items() if name.startswith("windowed"))

    worst.update(edge_pre_shape_errors(gen))
    worst.update(fused_shape_errors(gen))
    worst.update(q_shape_errors(gen))
    worst.update(dhfr_shape_errors(gen))
    worst.update(project_shape_errors(gen))
    worst.update(blocked_shape_errors(gen))
    worst.update(odd_shape_errors())
    torch.cuda.synchronize()
    emit({"phase": "shapes", "max_rel_err": worst, "tolerance": TOL,
          "cheb_tolerance": CHEB_TOL, "edge_tolerance": EDGE_TOL,
          "emb_tolerance": EMB_TOL})
    for name, err in worst.items():
        check(err <= limit(name),
              f"{name}: a kernel disagrees at a small shape, {err:.3g}")
    sweep = {key: dict(
        vs_plain=max(r["vs_plain"] for r in rs),
        vs_float64=[max(r["vs_float64"][i] for r in rs) for i in (0, 1)],
        vs_float64_terms=[max(r["vs_float64_terms"][i] for r in rs)
                          for i in (0, 1)])
        for key, rs in cheb_seed_errors().items()}
    emit({"phase": "cheb_seeds", "seeds": len(CHEB_SEEDS),
          "cheb_tolerance": CHEB_TOL, "float64_ratio": CHEB_F64_RATIO,
          "max_over_seeds": sweep})
    for key, r in sweep.items():
        check(r["vs_plain"] <= CHEB_TOL,
              f"{key}: a seed's draw disagrees, {r['vs_plain']:.3g}")
        check(r["vs_float64"][0] <= CHEB_F64_RATIO * r["vs_float64"][1],
              f"{key}: the kernel is farther from float64 than the plain "
              f"chain, {r['vs_float64']}")


# ---------------------------------------------------------------- systems
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


def dhfr_system(n_atoms=DHFR_ATOMS, n_pad=DHFR_PAD, density=0.1, seed=0):
    """``bench.py::build_system`` (a copy): ``n_atoms`` uniform at liquid
    density in a periodic cube, padded to ``n_pad`` rows with ghost atoms
    (type 0, segment 1) spread through the box.  Returns ``(z, pos,
    masses, box, L)`` like :func:`northstar_system`, and the segments."""
    rng = np.random.RandomState(seed)
    L = (n_atoms / density) ** (1.0 / 3.0)
    pos = rng.uniform(0, L, (n_pad, 3)).astype(np.float32)
    pos[:n_atoms] = rng.uniform(0, L, (n_atoms, 3))
    z = np.zeros(n_pad, np.int64)
    z[:n_atoms] = rng.choice([1, 1, 6, 7, 8], n_atoms)
    seg = np.ones(n_pad, np.int64)
    seg[:n_atoms] = 0
    masses = np.where(z == 1, 1.008, 12.011).astype(np.float64)
    box = np.diag([L, L, L]).astype(np.float32)
    return (z, pos, masses, box, L), seg


def dhfr_args(**extra):
    """``bench.py::main``'s args (``:65-87``): TensorNet 2 x 128, 32 expnorm
    rbf, 4.5 Å, K=64 brute neighbors, the Scalar head, the tabulated
    filters at T=128."""
    args = dict(
        model="tensornet", embedding_dimension=F, num_layers=2, num_rbf=R,
        rbf_type="expnorm", trainable_rbf=False, activation="silu",
        cutoff_lower=0.0, cutoff_upper=4.5, max_z=128,
        max_num_neighbors=DHFR_K, derivative=True, prior_model=None,
        output_model="Scalar", reduce_op="sum", precision=32,
        equivariance_invariance_group="O(3)", atom_filter=-1,
        tabulated_edge_mlp=DHFR_T)
    args.update(extra)
    return args


# the exact variant: the edge MLP per slot on kernel 4, the embedding on
# kernels 1 and 2; with both flags off it is the plain path
DHFR_EXACT = dict(tabulated_edge_mlp=0, pallas_edge_mlp=True,
                  pallas_embedding=True)


def northstar_args(L):
    """``bench.py::bench_northstar`` args (``:270-286``) on the gather
    path: no cell_block_spec, remat off.  Add a ``cell_block_spec`` for
    the blocked path."""
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


def northstar_spec(system, grouped=False):
    """The north star's cell-block spec (``bench.py:292-301``: cutoff +
    skin, 16-row blocks), ungrouped or (``BENCH_MD_GROUPED=1``) with
    per-column slot budgets."""
    from torchmdnet_tpu_torch.ops.cell_blocks import tune_cell_block_spec

    _, pos, _, _, L = system
    return tune_cell_block_spec(pos, [L] * 3, 4.5 + SKIN, cap=CAP,
                                column_slots=grouped)


def tf32_force_diff(run):
    """max |ΔF| / max |F| of ``run()`` with TF32 allowed (matmul precision
    "default") against full float32 ("highest"): a record, not a check."""
    from torchmdnet_tpu_torch.ops.config import set_matmul_precision

    _, f = run()
    set_matmul_precision("default")
    try:
        _, f_tf32 = run()
        torch.cuda.synchronize()
    finally:
        set_matmul_precision("highest")
    return rel_err(f_tf32, f)[1]


def phase_small():
    """Kernels on the card against the plain versions on the CPU, at a
    small size whose edge counts are not tile multiples: TensorNet2 +
    Coulomb on the gather path, and TensorNet tabulated (kernels 5, 7)
    and exact (kernels 1, 2, 4)."""
    from torchmdnet_tpu_torch.models.model import create_model

    small = dict(embedding_dimension=32, num_rbf=16, max_num_neighbors=48)
    cases = {
        "tensornet2": dict(
            northstar_args(40.0), q_dim=4, q_weights=[[1.0] * 4] * 3,
            coulomb_cutoff=5.0, coulomb_neighbor_strategy="brute", **small),
        "tensornet_tabulated": dict(dhfr_args(), tabulated_edge_mlp=32,
                                    **small),
        "tensornet_exact": dict(dhfr_args(**DHFR_EXACT), **small)}
    rng = np.random.RandomState(3)
    g = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"),
                 -1).reshape(-1, 3) + 0.5  # 125 atoms x 48 slots: ragged
    pos = (g * 2.6 + rng.uniform(-0.4, 0.4, g.shape)).astype(np.float32)
    z = rng.choice([1, 1, 6, 7, 8], len(pos))
    box = np.diag([13.0] * 3).astype(np.float32)
    row = {"phase": "small_vs_cpu", "atoms": len(z), "tolerance": TOL}
    for name, args in cases.items():
        gpu = create_model(args, device="cuda", seed=5)
        cpu = create_model(args, device="cpu", seed=5)
        y_g, f_g = gpu.apply(z, pos, None, num_mols=1, box=box)
        y_c, f_c = cpu.apply(z, pos, None, num_mols=1, box=box)
        e_err = (abs(float(y_g.cpu()) - float(y_c))
                 / max(abs(float(y_c)), 1e-30))
        _, f_rel = rel_err(f_g.cpu(), f_c)
        row[name] = {"energy": float(y_c), "energy_rel_err": e_err,
                     "force_rel_err": f_rel}
    emit(row)
    for name in cases:
        check(row[name]["energy_rel_err"] <= TOL
              and row[name]["force_rel_err"] <= TOL,
              f"small system {name}: GPU vs CPU mismatch")


# ---------------------------------------------------------------- gather
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
    emit({"phase": "energy_forces", "path": "gather", "atoms": N_ATOMS,
          "energy": float(y_k),
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
    return pot, (y_k, f_k), lambda: run(pot)


def phase_profile(name, run):
    """Device time by kernel over one energy+forces evaluation, and the
    device's idle share of the (profiled) wall time; returns the row."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
        group = next((g for g, keys in PROFILE_GROUPS if any(
            k in e.key for k in keys)), "elementwise and other")
        groups[group] = groups.get(group, 0.0) + dev_ms(e)
    (OUT_DIR / f"profile_{name}.txt").write_text("\n".join(
        f"{dev_ms(e):12.3f} ms {e.count:6d} calls  {e.key}" for e in kernels))
    row = {"phase": f"profile_{name}", "wall_ms": wall_ms,
           "device_ms": total, "idle_share": max(0.0, 1 - total / wall_ms),
           "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
           "top": [{"name": e.key[:80], "ms": dev_ms(e), "calls": e.count}
                   for e in kernels[:12]]}
    emit(row)
    return row


PROFILE_GROUPS = (
    ("rows 8-11 blocked message passing", ("blocked_sum_kernel",
                                           "blocked_dattr_kernel",
                                           "blocked_sum_cheb_kernel",
                                           "blocked_dd_cheb_kernel")),
    ("kernels 5/7 Chebyshev filter", ("cheb_tc_kernel",)),
    ("series and weight split of rows 3, 4, 5, 7, 10, 11, 13",
     ("tc_split_kernel",)),
    ("row 6 Chebyshev projection", ("project_tc_kernel",
                                    "project_sum_kernel")),
    ("kernel 4 edge_mlp", ("edge_mlp_tc_kernel<true",)),
    ("kernel B q-tier", ("dq_tc_kernel",)),
    ("kernel A q-tier", ("q_tc_kernel",)),
    ("kernel C/D windowed Coulomb", ("wc_tc_kernel",)),
    ("kernel 3 edge_mlp_pre", ("edge_mlp_tc_kernel<false",)),
    ("kernel 2 embedding bwd", ("emb_bwd_tc_kernel", "emb_dk_sum_kernel")),
    ("kernel 1 embedding fwd", ("emb_fwd_tc_kernel",)),
    ("cuBLAS matmul", ("gemm", "sgemm")),
    ("gather", ("gather", "index_elementwise", "index_kernel")),
    ("scatter (index backward, index_add)", ("indexing_backward",
                                             "indexFunc")),
    ("sort (cell blocks, neighbor build)", ("sort", "Sort", "radix")),
    ("reductions", ("reduce_kernel",)),
)


def md_run(pot, system, steps, chunks, batch=None, neighbor_strategy="cell",
           **kw):
    """``init_state`` plus ``chunks`` chunks of ``steps`` Langevin steps;
    the last chunk is timed.  Returns its JSON fields and the state."""
    from torchmdnet_tpu_torch.md.integrators import (
        KB_EV, kinetic_energy, make_md_step)

    z, pos, masses, box, _ = system
    init_state, chunk, _ = make_md_step(
        pot, z, np.zeros(len(z)) if batch is None else batch, masses,
        dt=0.05, num_mols=1, box=box, q=torch.zeros(1, device="cuda"),
        rebuild_every=steps, skin=SKIN, temperature=300.0,
        neighbor_strategy=neighbor_strategy, **kw)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = init_state(pos, seed=1)
    for _ in range(chunks - 1):  # warm-up chunks
        st = chunk(st)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    e_warm = float(st.energy)
    t0 = time.perf_counter()
    st = chunk(st)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    ok = (not bool(st.overflow) and bool(torch.isfinite(st.pos).all())
          and bool(torch.isfinite(st.energy).all())
          and bool(torch.isfinite(st.force).all()))
    m = torch.as_tensor(masses, dtype=torch.float32, device=st.vel.device)
    temp_k = float(2.0 * kinetic_energy(st.vel, m) / (3.0 * len(z) * KB_EV))
    return {"steps": st.step, "rebuild_every": steps,
            "kinetic_temperature_k": temp_k, "ms_per_step": ms,
            "warmup_s": warm_s, "energy_after_warmup": e_warm,
            "energy_final": float(st.energy),
            "overflow": bool(st.overflow), "finite": ok,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}, ok


def counted_run(fn):
    """Launches of every kernel over ``fn()``: the counts are set to 0
    just before and read just after."""
    kernels = counters()
    for kern in kernels.values():
        kern.launches = 0
    out = fn()
    return out, {name: kern.launches for name, kern in kernels.items()}


def phase_md_gather(pot, system):
    """The gather path's MD at reduced depth: a 5-step warm-up chunk, then
    a timed 5-step chunk (a rebuild every 5 steps, not 25)."""
    (row, ok), launches = counted_run(lambda: md_run(pot, system, 5, 2))
    emit(dict({"phase": "md", "path": "gather"}, **row,
              launches=launches))
    check(ok, "gather MD: overflow or non-finite state")
    return row["steps"], launches


# ---------------------------------------------------------------- blocked
def phase_blocked_energy(system, spec, gather_pot, gather_out):
    """Energy+forces on the blocked path (q-tier + windowed Coulomb) with
    the kernels and through the plain versions, and against the gather
    path's forces at the same positions."""
    from torchmdnet_tpu_torch.md.integrators import make_md_step
    from torchmdnet_tpu_torch.models.model import create_model
    from torchmdnet_tpu_torch.ops.cell_blocks import tune_stencil_window_spec

    z, pos, masses, box, L = system
    dev = torch.device("cuda")
    args = dict(northstar_args(L), cell_block_spec=spec, q_tab=Q_TAB)
    pot = create_model(args, device=dev, seed=0)
    pot.module.load_state_dict(gather_pot.module.state_dict())
    wspec = tune_stencil_window_spec(pos, [L] * 3, spec, COULOMB_RC + SKIN)
    kw = dict(dt=0.05, num_mols=1, box=box, q=torch.zeros(1, device=dev),
              skin=SKIN, neighbor_strategy="cell", cell_block_spec=spec,
              coulomb_window_spec=wspec)
    init_state, chunk, _ = make_md_step(pot, z, np.zeros(len(z)), masses,
                                        **kw)
    st = init_state(pos)  # a rebuild and a first evaluation
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = chunk.rebuild(st)
    torch.cuda.synchronize()
    rebuild_ms = (time.perf_counter() - t0) * 1e3
    check(not bool(st.overflow), "blocked rebuild: neighbor overflow")

    def run():
        return chunk.energy_forces(st.pos, st)

    torch.cuda.reset_peak_memory_stats()
    y_k, f_k = run()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak_k = torch.cuda.max_memory_allocated()
    tf32 = tf32_force_diff(run)

    plain = create_model(dict(args, pallas_embedding=False,
                              pallas_edge_mlp=False), device=dev, seed=0)
    plain.module.load_state_dict(pot.module.state_dict())
    _, chunk_p, _ = make_md_step(plain, z, np.zeros(len(z)), masses, **kw)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with plain_versions():
        t0 = time.perf_counter()
        y_p, f_p = chunk_p.energy_forces(st.pos, st)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    peak_p = torch.cuda.max_memory_allocated()

    check(y_k.shape == (1, 1) and f_k.shape == (N_ATOMS, 3), "bad shapes")
    check(torch.isfinite(y_k).all() and torch.isfinite(f_k).all(),
          "blocked: non-finite energy or forces")
    e_err = abs(float(y_k) - float(y_p)) / max(abs(float(y_p)), 1e-30)
    f_abs, f_rel = rel_err(f_k, f_p)
    y_g, f_g = gather_out
    g_abs, g_rel = rel_err(f_k, f_g)
    ge = abs(float(y_k) - float(y_g)) / max(abs(float(y_g)), 1e-30)
    emit({"phase": "energy_forces", "path": "blocked", "atoms": N_ATOMS,
          "n_pad": spec.n_pad, "blocks": spec.n_blocks, "q_tab": Q_TAB,
          "coulomb_stencil_s": wspec.s, "energy": float(y_k),
          "energy_plain": float(y_p), "energy_rel_err": e_err,
          "force_max_abs_err": f_abs, "force_rel_err": f_rel,
          "max_abs_force": float(f_p.abs().max()), "tolerance": TOL,
          "rebuild_ms": rebuild_ms, "ms_per_eval": statistics.median(times),
          "ms_per_eval_all": times, "plain_ms_per_eval": plain_ms,
          "peak_mem_gb": peak_k / 1e9, "plain_peak_mem_gb": peak_p / 1e9,
          "tf32_force_rel_diff": tf32,
          "vs_gather": {"energy_rel_diff": ge, "force_max_abs_diff": g_abs,
                        "force_rel_diff": g_rel,
                        "tolerance": BLOCKED_VS_GATHER_TOL}})
    check(e_err <= TOL, f"blocked energy: kernels vs plain {e_err:.3g}")
    check(f_rel <= TOL, f"blocked forces: kernels vs plain {f_rel:.3g}")
    check(g_rel <= BLOCKED_VS_GATHER_TOL,
          f"blocked vs gather forces: {g_rel:.3g} of max |F|")
    del plain, chunk_p, y_p, f_p
    torch.cuda.empty_cache()
    return pot, run, (y_k, f_k)


def phase_md_blocked(pot, system, spec):
    """The north-star MD: blocked q-tier and windowed Coulomb ("auto"),
    a warm-up chunk, then a timed 25-step chunk."""
    (row, ok), launches = counted_run(lambda: md_run(
        pot, system, 25, 2, cell_block_spec=spec,
        coulomb_window_spec="auto"))
    emit(dict({"phase": "md", "path": "blocked"}, **row, launches=launches))
    check(ok, "blocked MD: overflow or non-finite state")
    return row["steps"], launches


# ---------------------------------------------------------------- q-tiers
# the north star's other q-tiers: path → (grouped spec, q_tab).  The
# grouped exact tier has no dual list (JAX md/integrators.py:287), so its
# embedding runs on K′: its plain run keeps kernels 1 and 2 (the plain
# embedding's autograd chain on [N, K′, 3F] is the memory the dual list
# exists to avoid) and holds rows 12-13 alone against their plain
# versions, and it runs one evaluation, no MD
Q_TIERS = {"blocked_grouped": (True, Q_TAB),
           "blocked_exact": (False, 0),
           "blocked_exact_grouped": (True, 0)}


def embedding_on_k_prime(path):
    grouped, q_tab = Q_TIERS[path]
    return grouped and not q_tab


def phase_q_tier(system, path, spec, sd, refs):
    """Energy+forces of one q-tier of the north star (``Q_TIERS``) through
    ``make_md_step``'s rebuild and evaluation, with the kernels (launches
    counted) and through the plain versions, against ``refs`` (path →
    energy and forces at the same positions: the same pairs, the same or
    a series-fitted base, so 1e-4 of max |F|), ms per evaluation, the
    rebuild's ms, peak memory, the lists' widths."""
    from torchmdnet_tpu_torch.md.integrators import make_md_step
    from torchmdnet_tpu_torch.models.model import create_model
    from torchmdnet_tpu_torch.ops.cell_blocks import tune_stencil_window_spec

    grouped, q_tab = Q_TIERS[path]
    plain_embedding = not embedding_on_k_prime(path)
    z, pos, masses, box, L = system
    dev = torch.device("cuda")
    args = dict(northstar_args(L), cell_block_spec=spec, q_tab=q_tab)
    pot = create_model(args, device=dev, seed=0)
    pot.module.load_state_dict(sd)
    wspec = tune_stencil_window_spec(pos, [L] * 3, spec, COULOMB_RC + SKIN)
    kw = dict(dt=0.05, num_mols=1, box=box, q=torch.zeros(1, device=dev),
              skin=SKIN, neighbor_strategy="cell", cell_block_spec=spec,
              coulomb_window_spec=wspec)
    init_state, chunk, _ = make_md_step(pot, z, np.zeros(len(z)), masses,
                                        **kw)
    st = init_state(pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = chunk.rebuild(st)
    torch.cuda.synchronize()
    rebuild_ms = (time.perf_counter() - t0) * 1e3
    check(not bool(st.overflow), f"{path} rebuild: neighbor overflow")

    def run():
        return chunk.energy_forces(st.pos, st)

    torch.cuda.reset_peak_memory_stats()
    (y_k, f_k), launches = counted_run(run)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak_k = torch.cuda.max_memory_allocated()

    plain_args = dict(args, pallas_edge_mlp=False)
    if plain_embedding:
        plain_args["pallas_embedding"] = False
    plain = create_model(plain_args, device=dev, seed=0)
    plain.module.load_state_dict(sd)
    _, chunk_p, _ = make_md_step(plain, z, np.zeros(len(z)), masses, **kw)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with plain_versions():
        t0 = time.perf_counter()
        y_p, f_p = chunk_p.energy_forces(st.pos, st)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    peak_p = torch.cuda.max_memory_allocated()

    check(y_k.shape == (1, 1) and f_k.shape == (N_ATOMS, 3),
          f"{path}: bad shapes")
    check(torch.isfinite(y_k).all() and torch.isfinite(f_k).all(),
          f"{path}: non-finite energy or forces")
    e_err = abs(float(y_k) - float(y_p)) / max(abs(float(y_p)), 1e-30)
    f_abs, f_rel = rel_err(f_k, f_p)
    vs = {}
    for ref, (y_r, f_r) in refs.items():
        r_abs, r_rel = rel_err(f_k, f_r)
        vs[ref] = {"energy_rel_diff": abs(float(y_k) - float(y_r))
                   / max(abs(float(y_r)), 1e-30),
                   "force_max_abs_diff": r_abs, "force_rel_diff": r_rel}
    row = {"phase": "energy_forces", "path": path, "atoms": N_ATOMS,
           "n_pad": spec.n_pad, "q_tab": q_tab, "col_slots": spec.col_slots,
           "k": int(st.nbr_idx.shape[1]),
           "k_embedding": (None if st.enbr_idx is None
                           else int(st.enbr_idx.shape[1])),
           "valid_slots": int(st.nbr_mask.sum()),
           "max_per_group": group_counts(spec, st.nbr_mask),
           "energy": float(y_k), "energy_plain": float(y_p),
           "energy_rel_err": e_err, "force_max_abs_err": f_abs,
           "force_rel_err": f_rel, "max_abs_force": float(f_p.abs().max()),
           "tolerance": TOL, "plain_embedding": plain_embedding,
           "rebuild_ms": rebuild_ms, "ms_per_eval": statistics.median(times),
           "ms_per_eval_all": times, "plain_ms_per_eval": plain_ms,
           "peak_mem_gb": peak_k / 1e9, "plain_peak_mem_gb": peak_p / 1e9,
           "launches_per_eval": {k: v for k, v in launches.items() if v},
           "vs": vs, "vs_tolerance": BLOCKED_VS_GATHER_TOL}
    emit(row)
    check(e_err <= TOL, f"{path} energy: kernels vs plain {e_err:.3g}")
    check(f_rel <= TOL, f"{path} forces: kernels vs plain {f_rel:.3g}")
    for ref, r in vs.items():
        check(r["force_rel_diff"] <= BLOCKED_VS_GATHER_TOL,
              f"{path} vs {ref} forces: {r['force_rel_diff']:.3g} of max |F|")
    check((st.enbr_idx is not None) == (grouped and q_tab > 0),
          f"{path}: the dual list is the grouped tabulated tier's alone")
    del plain, chunk_p, y_p, f_p
    torch.cuda.empty_cache()
    return pot, run, (y_k, f_k), launches


def phase_md_q_tier(pot, system, spec, path):
    """The north-star MD on a q-tier: windowed Coulomb ("auto"), a warm-up
    chunk, then a timed 25-step chunk."""
    (row, ok), launches = counted_run(lambda: md_run(
        pot, system, 25, 2, cell_block_spec=spec,
        coulomb_window_spec="auto"))
    emit(dict({"phase": "md", "path": path, "col_slots": spec.col_slots},
              **row, launches=launches))
    check(ok, f"{path} MD: overflow or non-finite state")
    return row["steps"], launches


def run_q_tiers(system, spec, sd, blocked_out):
    """The three q-tiers after the default one: evaluations, the grouped
    tier's profile, the MD chunks; ``{path: (steps, launches)}``."""
    spec_g = northstar_spec(system, grouped=True)
    refs = {"blocked": blocked_out}
    by_path = {}
    for path, (grouped, _) in Q_TIERS.items():
        s = spec_g if grouped else spec
        pot, run, out, launches = phase_q_tier(system, path, s, sd, refs)
        if path == "blocked_grouped":
            phase_profile(path, run)
        by_path[path] = ((1, launches) if embedding_on_k_prime(path)
                         else phase_md_q_tier(pot, system, s, path))
        if path == "blocked_exact":  # the grouped exact tier's reference
            refs = {path: out}
        del pot, run
        torch.cuda.empty_cache()
    return by_path


# ---------------------------------------------------------------- dhfr
def dhfr_potentials(dhfr, seg):
    """The default (tabulated) and exact dhfr models and the plain exact
    one, all with the same random weights, and an evaluation closure."""
    from torchmdnet_tpu_torch.models.model import create_model

    z, pos, _, box, _ = dhfr
    dev = torch.device("cuda")
    pots = {"tabulated": create_model(dhfr_args(), device=dev, seed=0)}
    sd = pots["tabulated"].module.state_dict()
    for name, extra in (("exact", DHFR_EXACT),
                        ("exact_plain", dict(tabulated_edge_mlp=0))):
        pots[name] = create_model(dhfr_args(**extra), device=dev, seed=0)
        pots[name].module.load_state_dict(sd)
    zt, st = torch.as_tensor(z, device=dev), torch.as_tensor(seg, device=dev)
    bt = torch.as_tensor(box, device=dev)

    def evaluate(pot, p):
        """``bench.py::main``'s evaluation: the brute list is rebuilt."""
        return pot.apply(zt, p, st, num_mols=1, box=bt)

    return pots, evaluate, torch.as_tensor(pos, device=dev)


def bench_chain_ms(evaluate, pot, pos, iters=DHFR_ITERS):
    """ms per evaluation of ``bench.py::main``'s chain: positions fed back
    as ``pos + 1e-24·F`` (no physical motion), ``iters`` evaluations timed
    after two."""
    def chain(n):
        p = pos
        for _ in range(n):
            p = p + 1e-24 * evaluate(pot, p)[1]
        return p

    chain(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain(iters)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_dhfr(dhfr, seg):
    """Energy+forces of the dhfr models: each variant with the kernels
    against its plain versions, tabulated against exact, the bench chain's
    ms per evaluation, peak memory, the list's overflow and largest
    neighbor count."""
    pots, evaluate, pos = dhfr_potentials(dhfr, seg)
    rep = pots["tabulated"].module.representation_model
    nbr = rep.build_neighbors(pos, torch.as_tensor(seg, device=pos.device),
                              box=torch.as_tensor(dhfr[3], device=pos.device),
                              atom_mask=torch.as_tensor(seg < 1,
                                                        device=pos.device))
    row = {"phase": "energy_forces", "path": "dhfr", "atoms": DHFR_ATOMS,
           "rows": len(seg), "k": DHFR_K, "t": DHFR_T,
           "overflow": bool(nbr.overflow),
           "max_neighbors": int(nbr.num_neighbors.max()),
           "valid_slots": int(nbr.mask.sum()), "tolerance": TOL,
           "tab_vs_exact_tolerance": TAB_VS_EXACT_TOL}
    check(not row["overflow"], "dhfr: K=64 neighbor overflow")
    out = {}
    for name in ("tabulated", "exact"):
        torch.cuda.reset_peak_memory_stats()
        y, f = evaluate(pots[name], pos)
        torch.cuda.synchronize()
        ms = bench_chain_ms(evaluate, pots[name], pos)
        peak = torch.cuda.max_memory_allocated()
        tf32 = tf32_force_diff(lambda: evaluate(pots[name], pos))
        if name == "tabulated":
            with plain_versions():
                y_p, f_p = evaluate(pots[name], pos)
                plain_ms = bench_chain_ms(evaluate, pots[name], pos, 5)
        else:
            y_p, f_p = evaluate(pots["exact_plain"], pos)
            plain_ms = bench_chain_ms(evaluate, pots["exact_plain"], pos, 5)
        check(y.shape == (1, 1) and f.shape == (len(seg), 3),
              "dhfr: bad shapes")
        check(bool(torch.isfinite(y).all() and torch.isfinite(f).all()),
              f"dhfr {name}: non-finite energy or forces")
        check(not f[DHFR_ATOMS:].any(), f"dhfr {name}: ghost rows feel force")
        e_err = abs(float(y) - float(y_p)) / max(abs(float(y_p)), 1e-30)
        f_abs, f_rel = rel_err(f, f_p)
        out[name] = (y, f)
        row[name] = {"energy": float(y), "energy_plain": float(y_p),
                     "energy_rel_err": e_err, "force_max_abs_err": f_abs,
                     "force_rel_err": f_rel,
                     "max_abs_force": float(f_p.abs().max()),
                     "ms_per_eval": ms, "plain_ms_per_eval": plain_ms,
                     "peak_mem_gb": peak / 1e9, "tf32_force_rel_diff": tf32}
    (y_t, f_t), (y_e, f_e) = out["tabulated"], out["exact"]
    g_abs, g_rel = rel_err(f_t, f_e)
    row["tab_vs_exact"] = {
        "energy_rel_diff": abs(float(y_t) - float(y_e))
        / max(abs(float(y_e)), 1e-30),
        "force_max_abs_diff": g_abs, "force_rel_diff": g_rel}
    emit(row)
    for name in ("tabulated", "exact"):
        r = row[name]
        check(r["energy_rel_err"] <= TOL and r["force_rel_err"] <= TOL,
              f"dhfr {name}: kernels vs plain {r['energy_rel_err']:.3g} / "
              f"{r['force_rel_err']:.3g}")
    check(g_rel <= TAB_VS_EXACT_TOL,
          f"dhfr: tabulated vs exact forces {g_rel:.3g} of max |F|")
    del pots["exact_plain"]
    torch.cuda.empty_cache()
    return pots, evaluate, pos, out


def phase_md_dhfr(pot, dhfr, seg, path):
    """Langevin MD of a dhfr model: brute lists at 4.5 + 1 Å with K=128
    slots rebuilt every 25 steps, a warm-up chunk, then a timed one."""
    (row, ok), launches = counted_run(lambda: md_run(
        pot, dhfr, 25, 2, batch=seg, neighbor_strategy="brute",
        k_max=DHFR_MD_K))
    emit(dict({"phase": "md", "path": path}, **row, launches=launches))
    check(ok, f"{path} MD: overflow or non-finite state")
    return row["steps"], launches


# ---------------------------------------------------------------- dhfr blocked
# variant → (extra args, spec layout, the gather-path variant it equals)
DHFR_BLOCKED = {"tabulated_grouped": ({}, "grouped", "tabulated"),
                "tabulated_ungrouped": ({}, "ungrouped", "tabulated"),
                "exact_grouped": (DHFR_EXACT, "grouped", "exact"),
                "exact_ungrouped": (DHFR_EXACT, "ungrouped", "exact")}
# kernels an exact blocked evaluation must launch (kernel 4, rows 8 and 9)
# and a tabulated one (rows 10 and 11)
DHFR_BLOCKED_KERNELS = {
    "exact": ("edge_mlp", "blocked_mp_sum", "blocked_mp_dattr"),
    "tabulated": ("blocked_mp_sum_cheb", "blocked_mp_dd_cheb")}


def phase_dhfr_blocked(dhfr, seg, specs, gather):
    """``bench.py::main`` with ``BENCH_BLOCKED=1`` on the card, in four
    variants with the gather path's weights: each with the kernels against
    its plain versions and against the gather path's forces at the same
    positions, the launches of one evaluation (each variant's kernels,
    ``DHFR_BLOCKED_KERNELS``, must launch), ghost rows, overflow and the
    fullest slot group, ms per
    evaluation of the bench chain, blocked and gather chains in turns
    (gather, blocked, blocked, gather for the default variant; blocked,
    gather for the others), of the plain chain (5 evaluations after two),
    and peak memory."""
    from torchmdnet_tpu_torch.models.model import create_model

    pots_g, evaluate, pos, out_g = gather
    dev = pos.device
    sd = pots_g["tabulated"].module.state_dict()
    row = {"phase": "energy_forces", "path": "dhfr_blocked",
           "atoms": DHFR_ATOMS, "cap": DHFR_CAP, "tolerance": TOL,
           "iters": DHFR_ITERS}
    blocked = {}
    for name, (extra, layout, ref) in DHFR_BLOCKED.items():
        spec = specs[layout]
        pot = create_model(dhfr_args(cell_block_spec=spec, **extra),
                           device=dev, seed=0)
        pot.module.load_state_dict(sd)
        plain = pot
        if extra:  # the exact variant's plain path: the model flags off
            plain = create_model(dhfr_args(cell_block_spec=spec,
                                           tabulated_edge_mlp=0),
                                 device=dev, seed=0)
            plain.module.load_state_dict(sd)
        ev = BlockedDhfr(dhfr, seg, spec)
        *_, nbr = ev.sorted_inputs(pos)
        torch.cuda.reset_peak_memory_stats()
        (y, f), launches = counted_run(lambda: ev(pot, pos))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        with plain_versions():
            y_p, f_p = ev(plain, pos)
        chains = {"gather": [], "blocked": []}
        turns = (("gather", "blocked", "blocked", "gather")
                 if name == "tabulated_grouped" else ("blocked", "gather"))
        for side in turns:
            chains[side].append(
                bench_chain_ms(evaluate, pots_g[ref], pos) if side == "gather"
                else bench_chain_ms(ev, pot, pos))
        with plain_versions():
            plain_ms = bench_chain_ms(ev, plain, pos, 5)
        check(y.shape == (1, 1) and f.shape == (len(seg), 3),
              f"dhfr blocked {name}: bad shapes")
        check(bool(torch.isfinite(y).all() and torch.isfinite(f).all()),
              f"dhfr blocked {name}: non-finite energy or forces")
        check(not f[DHFR_ATOMS:].any(),
              f"dhfr blocked {name}: ghost rows feel force")
        check(not bool(nbr.overflow), f"dhfr blocked {name}: list overflow")
        e_err = abs(float(y) - float(y_p)) / max(abs(float(y_p)), 1e-30)
        f_abs, f_rel = rel_err(f, f_p)
        y_g, f_g = out_g[ref]
        g_abs, g_rel = rel_err(f, f_g)
        row[name] = {
            "spec": {"nx": spec.nx, "n_pad": spec.n_pad,
                     "col_slots": spec.col_slots},
            "k": nbr.idx.shape[1], "valid_slots": int(nbr.mask.sum()),
            "max_per_group": group_counts(spec, nbr.mask),
            "energy": float(y), "energy_plain": float(y_p),
            "energy_rel_err": e_err, "force_max_abs_err": f_abs,
            "force_rel_err": f_rel, "max_abs_force": float(f_p.abs().max()),
            "vs_gather": {"energy_rel_diff": abs(float(y) - float(y_g))
                          / max(abs(float(y_g)), 1e-30),
                          "force_max_abs_diff": g_abs,
                          "force_rel_diff": g_rel},
            "ms_per_eval": statistics.mean(chains["blocked"]),
            "ms_per_eval_all": chains["blocked"],
            "gather_ms_per_eval_all": chains["gather"],
            "plain_ms_per_eval": plain_ms, "peak_mem_gb": peak / 1e9,
            "launches": {k: n for k, n in launches.items() if n}}
        blocked[name] = (pot, ev)
        del plain, y_p, f_p
        torch.cuda.empty_cache()
    emit(row)
    for name in DHFR_BLOCKED:
        r = row[name]
        check(r["energy_rel_err"] <= TOL and r["force_rel_err"] <= TOL,
              f"dhfr blocked {name}: kernels vs plain "
              f"{r['energy_rel_err']:.3g} / {r['force_rel_err']:.3g}")
        check(r["vs_gather"]["force_rel_diff"] <= TOL,
              f"dhfr blocked {name}: vs gather forces "
              f"{r['vs_gather']['force_rel_diff']:.3g} of max |F|")
        for k in DHFR_BLOCKED_KERNELS[DHFR_BLOCKED[name][2]]:
            check(r["launches"].get(k, 0) > 0,
                  f"dhfr blocked {name}: {k} was not launched")
    return blocked


def phase_md_dhfr_blocked(pot, dhfr, seg, spec, path):
    """Langevin MD of a blocked dhfr model on the grouped spec tuned at
    4.5 + 1 Å: the column-partitioned list rebuilt every 25 steps, a
    warm-up chunk, then a timed one."""
    (row, ok), launches = counted_run(lambda: md_run(
        pot, dhfr, 25, 2, batch=seg, cell_block_spec=spec))
    emit(dict({"phase": "md", "path": path, "col_slots": spec.col_slots},
              **row, launches=launches))
    check(ok, f"{path} MD: overflow or non-finite state")
    return row["steps"], launches


# ---------------------------------------------------------------- priors
EV = 1.602176634e-19  # J: the priors' energies in eV
# the dhfr system's types are atomic numbers already (0: ghost)
ELEMENTS = tuple(range(9))
PRIOR_UNITS = dict(distance_scale=1e-10, energy_scale=EV)
# ZBL at 4 Å (K=64) and D2 at 10 Å (K=512) leave room at dhfr's density
# (0.1 atoms/Å³: ~27 and ~420 neighbors); Atomref a seeded table
DHFR_PRIORS = [
    dict(cutoff_distance=4.0, max_num_neighbors=64, atomic_number=ELEMENTS,
         **PRIOR_UNITS),
    dict(cutoff_distance=10.0, max_num_neighbors=512,
         atomic_number=ELEMENTS, **PRIOR_UNITS),
    dict(initial_atomref=np.random.RandomState(17).uniform(
        -5.0, 0.0, (len(ELEMENTS), 1)).astype(np.float32))]


def wall_ms(fn, reps=5):
    """Median wall ms of ``fn()`` over ``reps`` calls after one."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def against_cpu(pot, args, run_card, run_cpu):
    """Energy and forces of ``pot`` on the card against the same model
    and weights on the CPU: (relative energy error, forces' max abs error
    / max |F|, energy)."""
    from torchmdnet_tpu_torch.models.model import create_model

    cpu = create_model(args, device="cpu", seed=0)
    cpu.module.load_state_dict({k: v.cpu() for k, v in
                                pot.module.state_dict().items()})
    y, f = run_card(pot)
    y_c, f_c = run_cpu(cpu)
    check(bool(torch.isfinite(y).all() and torch.isfinite(f).all()),
          "priors: non-finite energy or forces")
    e_err = abs(float(y.sum()) - float(y_c.sum())) / max(
        float(y_c.abs().sum()), 1e-30)
    return e_err, rel_err(f.cpu(), f_c)[1], float(y.sum())


def phase_priors(dhfr, seg, pots, evaluate, pos):
    """The priors through ``create_model`` on the card: the dhfr system's
    tabulated TensorNet with ZBL, D2 and Atomref (each pair prior's own
    brute list per evaluation, its flags checked), and the training
    batch's TensorNet with the Coulomb prior on seeded partial charges
    (``extra_args``); energies and forces against the same model and
    weights on the CPU, and ms per evaluation with and without them."""
    from torchmdnet_tpu_torch.models.model import create_model
    from torchmdnet_tpu_torch.priors.base import prior_pairs

    z, _, _, box, _ = dhfr
    dev = torch.device("cuda")
    args = dhfr_args(prior_model=["ZBL", "D2", "Atomref"],
                     prior_args=DHFR_PRIORS)
    pot = create_model(args, device=dev, seed=0)
    pot.module.load_state_dict(pots["tabulated"].module.state_dict())
    st, bt = torch.as_tensor(seg, device=dev), torch.as_tensor(box, device=dev)
    lists = {}
    for name, prior in zip(("zbl", "d2"), pot.module.prior_model):
        nbr, _ = prior_pairs(pos, st, bt, 1, cutoff=prior.cutoff_distance,
                             k_max=prior.max_num_neighbors)
        lists[name] = {"k": prior.max_num_neighbors,
                       "cutoff": prior.cutoff_distance,
                       "overflow": bool(nbr.overflow),
                       "max_neighbors": int(nbr.num_neighbors.max())}
        check(not lists[name]["overflow"], f"priors: {name} list overflow")
    e_err, f_rel, energy = against_cpu(
        pot, args, lambda m: evaluate(m, pos),
        lambda m: m.apply(z, pos.cpu(), seg, num_mols=1, box=box))
    y0, _ = evaluate(pots["tabulated"], pos)
    row = {"phase": "priors", "tolerance": TOL, "dhfr": {
        "priors": args["prior_model"], "lists": lists, "energy": energy,
        "energy_without": float(y0), "energy_rel_err_vs_cpu": e_err,
        "force_rel_err_vs_cpu": f_rel,
        "ms_per_eval": bench_chain_ms(evaluate, pot, pos),
        "ms_per_eval_without": bench_chain_ms(evaluate, pots["tabulated"],
                                              pos)}}
    del pot
    torch.cuda.empty_cache()

    batch = train_batch()
    rng = np.random.RandomState(23)
    q = rng.uniform(-0.5, 0.5, TRAIN_ROWS).astype(np.float32)
    bcpu = batch["batch"].cpu().numpy()
    for m in range(TRAIN_MOLS):  # neutral molecules, uncharged ghosts
        q[bcpu == m] -= q[bcpu == m].mean()
    q[bcpu == TRAIN_MOLS] = 0.0
    extra = {"partial_charges": torch.as_tensor(q, device=dev)}
    cargs = train_args(prior_model="Coulomb", prior_args=dict(
        max_num_neighbors=32, lower_switch_distance=0.1,
        upper_switch_distance=0.4, **PRIOR_UNITS))
    cpot = create_model(cargs, device=dev, seed=0)
    kw = dict(num_mols=TRAIN_MOLS)
    bc = {k: v.cpu() for k, v in batch.items()}

    def run(m, b, ex):
        return lambda: m.apply(b["z"], b["pos"], b["batch"], **kw,
                               extra_args=ex)

    e_err_c, f_rel_c, energy_c = against_cpu(
        cpot, cargs, lambda m: run(m, batch, extra)(),
        lambda m: run(m, bc, {"partial_charges": torch.as_tensor(q)})())
    plain = create_model(train_args(), device=dev, seed=0)
    row["train_coulomb"] = {
        "mols": TRAIN_MOLS, "rows": TRAIN_ROWS, "energy": energy_c,
        "energy_rel_err_vs_cpu": e_err_c, "force_rel_err_vs_cpu": f_rel_c,
        "ms_per_eval": wall_ms(run(cpot, batch, extra)),
        "ms_per_eval_without": wall_ms(run(plain, batch, None))}
    emit(row)
    for name in ("dhfr", "train_coulomb"):
        r = row[name]
        check(r["energy_rel_err_vs_cpu"] <= TOL
              and r["force_rel_err_vs_cpu"] <= TOL,
              f"priors {name}: card vs CPU {r['energy_rel_err_vs_cpu']:.3g}"
              f" / {r['force_rel_err_vs_cpu']:.3g}")
    check(abs(row["dhfr"]["energy"] - row["dhfr"]["energy_without"]) > 1.0,
          "priors: ZBL, D2 and Atomref add no energy")


def column_spike(pos, n_real, L, spec, m=16, seed=0):
    """``m`` real atoms (the farthest from it) moved into a 1.0-2.2 Å
    shell around the real atom nearest the middle of xy-column (0, 0),
    each new place ≥ 0.9 Å from every atom: that column's own stencil
    group then holds more neighbors than its tuned budget."""
    rng = np.random.RandomState(seed)
    real = pos[:n_real]
    mid = np.array([0.5 * L / spec.nx, 0.5 * L / spec.ny, 0.5 * L])
    c = int(np.argmin(np.linalg.norm(real - mid, axis=1)))
    d = np.linalg.norm((real - real[c] + L / 2) % L - L / 2, axis=1)
    moved = np.argsort(d)[-m:]
    keep = np.delete(real, moved, axis=0)
    pts = []
    while len(pts) < m:
        v = rng.uniform(-2.2, 2.2, 3)
        x = real[c] + v
        near = np.concatenate([keep] + [np.array(pts).reshape(-1, 3)])
        gap = np.linalg.norm((near - x + L / 2) % L - L / 2, axis=1)
        if 1.0 < np.linalg.norm(v) < 2.2 and np.sort(gap)[1] > 0.9:
            pts.append(x)
    out = pos.copy()
    out[moved] = np.array(pts) % L
    return out


def phase_md_adaptive(pots, dhfr, seg, spec):
    """``make_adaptive_md_step`` on the dhfr grouped MD spec (per-column
    budgets tuned on the system as it is), started from a configuration
    whose densest column busts its budget: the re-spec fires (warning),
    the state carries no sticky overflow, the forces match the gather
    path's, and one 25-step chunk is timed; then ``run_md`` on the dhfr
    brute path (K=128 at 4.5 + 1 Å) for 25 steps."""
    from torchmdnet_tpu_torch.md.integrators import (
        make_adaptive_md_step, make_md_step, run_md)
    from torchmdnet_tpu_torch.models.model import create_model

    z, pos, masses, box, L = dhfr
    spiked = column_spike(pos, DHFR_ATOMS, L, spec)
    kw = dict(dt=0.05, num_mols=1, box=box, rebuild_every=25, skin=SKIN,
              temperature=300.0, k_max=DHFR_MD_K)
    pot = pots["tabulated"].with_spec(spec)
    init, chunk, _ = make_adaptive_md_step(pot, z, seg, masses,
                                           cell_block_spec=spec, **kw)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        st = init(spiked, seed=1)
    torch.cuda.synchronize()
    respec_s = time.perf_counter() - t0
    msgs = [str(w.message) for w in rec]
    init_g, _, _ = make_md_step(pots["tabulated"], z, seg, masses,
                                neighbor_strategy="brute", **kw)
    sg = init_g(spiked, seed=1)
    f_abs, f_rel = rel_err(st.force, sg.force)
    (st, counts) = counted_run(lambda: chunk(st))
    t0 = time.perf_counter()
    st = chunk(st)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 25
    ok = not bool(st.overflow) and bool(torch.isfinite(st.pos).all())
    new = chunk.current["spec"]

    pot128 = create_model(dhfr_args(max_num_neighbors=DHFR_MD_K),
                          device="cuda", seed=0)
    pot128.module.load_state_dict(pots["tabulated"].module.state_dict())
    t0 = time.perf_counter()
    sr = run_md(pot128, z, pos, masses, n_steps=25, dt=0.05, batch=seg,
                box=box, temperature=300.0, rebuild_every=25, skin=SKIN)
    run_s = time.perf_counter() - t0
    run_ok = (not bool(sr.overflow) and bool(torch.isfinite(sr.pos).all())
              and sr.step == 25)
    emit({"phase": "md_adaptive", "col_slots": spec.col_slots,
          "col_slots_after": None if new is None else new.col_slots,
          "warnings": msgs, "respec_and_init_s": respec_s,
          "force_max_abs_diff_vs_gather": f_abs,
          "force_rel_diff_vs_gather": f_rel,
          "tolerance": BLOCKED_VS_GATHER_TOL, "ms_per_step": ms,
          "steps": st.step, "overflow": bool(st.overflow),
          "launches": {k: v for k, v in counts.items() if v},
          "run_md": {"steps": sr.step, "overflow": bool(sr.overflow),
                     "wall_s": run_s, "finite": run_ok}})
    check(any("re-spec'd col_slots" in m for m in msgs),
          f"md_adaptive: no re-spec ({msgs})")
    check(new is not None and new.col_slots != spec.col_slots,
          "md_adaptive: the spec did not grow")
    check(f_rel <= BLOCKED_VS_GATHER_TOL,
          f"md_adaptive: forces vs gather {f_rel:.3g} of max |F|")
    check(ok, "md_adaptive: overflow or non-finite state after the chunk")
    check(run_ok, "run_md: overflow or non-finite state")


# ---------------------------------------------------------------- training
def train_args(**extra):
    """``bench.py::bench_train``'s model (``:392-402``): TensorNet 2 x 128,
    32 expnorm rbf, 5 Å, K=40 brute neighbors, the Scalar head, with the
    tabulated filters at T=128 (``BENCH_TRAIN_TAB=128``)."""
    args = dict(
        model="tensornet", embedding_dimension=F, num_layers=2, num_rbf=R,
        rbf_type="expnorm", trainable_rbf=False, activation="silu",
        cutoff_lower=0.0, cutoff_upper=TRAIN_CUTOFF, max_z=128,
        max_num_neighbors=TRAIN_K, derivative=True, prior_model=None,
        output_model="Scalar", reduce_op="sum", precision=32,
        equivariance_invariance_group="O(3)", atom_filter=-1,
        pallas_edge_mlp=False, tabulated_edge_mlp=TRAIN_T)
    args.update(extra)
    return args


def train_batch():
    """``bench.py:404-419``'s batch on the card: 64 molecules of 24 H/C/N/O
    atoms at uniform positions in an 8 Å cube (each shifted by its index),
    1,664 rows with the ghosts in segment 64, random y and neg_dy."""
    dev = torch.device("cuda")
    n = TRAIN_MOLS * TRAIN_APM
    rng = np.random.RandomState(0)
    z = np.zeros(TRAIN_ROWS, np.int64)
    batch = np.full(TRAIN_ROWS, TRAIN_MOLS, np.int64)
    pos = np.zeros((TRAIN_ROWS, 3), np.float32)
    for m in range(TRAIN_MOLS):
        s = slice(m * TRAIN_APM, (m + 1) * TRAIN_APM)
        z[s] = rng.choice([1, 1, 6, 7, 8], TRAIN_APM)
        batch[s] = m
        pos[s] = rng.uniform(-4, 4, (TRAIN_APM, 3)) + m
    check(n < TRAIN_ROWS, "training batch: no ghost rows")
    y = rng.randn(TRAIN_MOLS, 1).astype(np.float32)
    neg_dy = rng.randn(TRAIN_ROWS, 3).astype(np.float32)
    out = dict(z=z, pos=pos, batch=batch, y=y, neg_dy=neg_dy,
               mol_mask=np.ones(TRAIN_MOLS, bool))
    return {k: torch.as_tensor(v, device=dev) for k, v in out.items()}


def loss_and_grads(pot, batch, num_mols=None, neg_dy_weight=1.0,
                   y_weight=1.0):
    """The train step's loss (y and neg_dy MSE, weighted) and its
    gradient in every weight, without an update (``num_mols``: the
    training batch's, ``TRAIN_MOLS``, when None)."""
    from torchmdnet_tpu_torch.train.step import compute_losses

    params = list(pot.module.parameters())
    ly, ln, _ = compute_losses(pot, batch, num_mols or TRAIN_MOLS,
                               create_graph=True)
    loss = y_weight * ly + neg_dy_weight * ln
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return float(loss.detach()), grads


def grads_against(pot, plain, batch, plain_ops=False, **kw):
    """One step's loss and weight gradients of ``pot`` (kernels) against
    ``plain`` (the same weights, the plain chains; with ``plain_ops`` its
    q-tier, Coulomb, Chebyshev and blocked ops routed to their plain
    versions, ``plain_versions``): the loss's relative error, the worst
    weight's error relative to its gradient's max |·|, and that weight's
    name."""
    names = [n for n, _ in pot.module.named_parameters()]
    for m in (pot, plain):
        m.module.requires_grad_(True)
    loss_k, g_k = loss_and_grads(pot, batch, **kw)
    with plain_versions() if plain_ops else contextlib.nullcontext():
        loss_p, g_p = loss_and_grads(plain, batch, **kw)
    errs = {n: rel_err(a, b)[1] for n, a, b in zip(names, g_k, g_p)}
    worst = max(errs, key=errs.get)
    plain.module.requires_grad_(False)
    return dict(loss=loss_k, loss_plain=loss_p,
                loss_rel_err=abs(loss_k - loss_p) / abs(loss_p),
                grad_rel_err=errs[worst], worst_param=worst)


def train_timed(pot, batch, num_mols, lr, steps, **step_kw):
    """Two warm-up steps and ``steps`` timed AdamW steps of ``pot`` on
    ``batch``: ``(row, launches over the timed steps, the train state,
    the step)``."""
    from torchmdnet_tpu_torch.train.step import (
        create_train_state, make_train_step)

    state = create_train_state(pot, lr=lr)
    step = make_train_step(pot, num_mols=num_mols, **step_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    losses = []
    for _ in range(2):  # warm-up
        state, m = step(state, batch)
        losses.append(float(m["loss"]))

    def timed():
        nonlocal state
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        return times

    times, counts = counted_run(timed)
    ms = statistics.median(times)
    row = dict(ms_per_step=ms, ms_per_step_all=times,
               mol_per_s=num_mols / (ms / 1e3), loss_first=losses[0],
               loss_last=losses[-1],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               # the steps' own peak above what was resident before them
               step_peak_gb=(torch.cuda.max_memory_allocated()
                             - resident) / 1e9,
               launches_per_step={k: v / steps
                                  for k, v in counts.items() if v})
    return row, counts, state, step


def phase_train():
    """``bench.py::bench_train``'s step on the card in three tiers from the
    same random weights: tabulated (rows 5, 6 and 7 in the forward, the
    force pass and the parameter gradient), exact (no kernel) and
    exact_fused (kernels 1, 2 and 4: ``pallas_embedding`` and
    ``pallas_edge_mlp``, the force pass through kernel 2 and the second
    order through the plain double vjps).  One step's loss and gradients
    with the kernels against the plain versions (tabulated) and against
    the exact tier's plain chain (exact_fused); then in each tier two
    warm-up steps and 20 timed AdamW steps on the fixed batch (the loss
    must fall), with launches, ms per step, mol/s, peak memory and a
    profiled step."""
    from torchmdnet_tpu_torch.models.model import create_model

    batch = train_batch()
    dev = torch.device("cuda")
    pots = {"tabulated": create_model(train_args(), device=dev, seed=0)}
    pots["exact"] = create_model(train_args(tabulated_edge_mlp=0),
                                 device=dev, seed=0)
    pots["exact_fused"] = create_model(
        train_args(tabulated_edge_mlp=0, pallas_embedding=True,
                   pallas_edge_mlp=True), device=dev, seed=0)
    for name in ("exact", "exact_fused"):
        pots[name].module.load_state_dict(
            pots["tabulated"].module.state_dict())
    row = {"phase": "train", "mols": TRAIN_MOLS, "atoms_per_mol": TRAIN_APM,
           "rows": TRAIN_ROWS, "k": TRAIN_K, "t": TRAIN_T, "lr": TRAIN_LR,
           "steps_timed": TRAIN_STEPS, "tolerance": TOL}
    compared = {"tabulated": grads_against(pots["tabulated"],
                                           pots["tabulated"], batch,
                                           plain_ops=True),
                "exact_fused": grads_against(pots["exact_fused"],
                                             pots["exact"], batch)}
    launches = {}
    for name, pot in pots.items():
        r = dict(compared.get(name, {}))
        t, counts, state, step = train_timed(pot, batch, TRAIN_MOLS,
                                             TRAIN_LR, TRAIN_STEPS)
        r.update(t)
        row[name] = r
        launches[name] = counts
        phase_profile(f"train_{name}", lambda: step(state, batch))
        pot.module.requires_grad_(False)
        del state, step
    emit(row)
    for name, r in compared.items():
        check(r["loss_rel_err"] <= TOL and r["grad_rel_err"] <= TOL,
              f"train {name}: kernels vs plain loss {r['loss_rel_err']:.3g}"
              f", gradient {r['grad_rel_err']:.3g} ({r['worst_param']})")
    for name in pots:
        r = row[name]
        check(all(math.isfinite(x) for x in (r["loss_first"],
                                              r["loss_last"])),
              f"train {name}: non-finite loss")
        check(r["loss_last"] < r["loss_first"],
              f"train {name}: the loss did not fall in "
              f"{TRAIN_STEPS + 2} steps")
    check(not any(launches["exact"].values()),
          "train exact: a kernel ran on the plain path")
    fused = launches["exact_fused"]
    for k in EXACT_FUSED_KERNELS:
        check(fused[k] >= TRAIN_STEPS,
              f"train exact_fused: {k} launched {fused[k]} times in "
              f"{TRAIN_STEPS} steps")
    return TRAIN_STEPS, launches["tabulated"]


# the exact_fused train tier's kernels: 1, 2 and 4
EXACT_FUSED_KERNELS = ("radial_embedding_fwd", "radial_embedding_bwd",
                       "edge_mlp")


class SyntheticMolecules:
    """QM9-scale molecules made from a seed: 9-29 H/C/N/O/F atoms each at
    random positions in a cube of 1.2 Å per atom^(1/3) per side, with a
    random energy and random forces; a dataset of plain numpy dicts."""

    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self.samples = []
        for _ in range(n):
            k = rng.randint(9, 30)
            side = 1.2 * k ** (1.0 / 3.0)
            self.samples.append(dict(
                z=rng.choice([1, 1, 1, 6, 6, 7, 8, 9], k).astype(np.int64),
                pos=rng.uniform(-side, side, (k, 3)).astype(np.float32),
                y=rng.randn(1, 1), neg_dy=rng.randn(k, 3).astype(np.float32)))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return dict(self.samples[int(idx)])


TRAINER_COLUMNS = [
    "epoch", "lr", "train_total_mse_loss", "train_y_mse_loss",
    "train_neg_dy_mse_loss", "val_y_l1_loss", "val_neg_dy_l1_loss",
    "val_total_l1_loss", "val_y_mse_loss", "val_neg_dy_mse_loss",
    "val_total_mse_loss"]


def phase_trainer():
    """``Trainer(potential, hp, DataModule(hp, dataset=ds)).fit()`` then
    ``.test()`` on the card: 2 epochs, batches of 64 synthetic molecules
    (256 train, 64 val, 64 test), tabulated T=128; ``metrics.csv`` has
    the JAX trainer's columns, the checkpoints are written under the log
    directory, the last epoch's reloads with ``strict=True`` into a fresh
    model on the card and gives the trained model's energies,
    ``best.ckpt`` holds one epoch's weights, and the test pass launches
    rows 5 and 7 but not row 6 (the weights' gradients are off there)."""
    import csv

    from torchmdnet_tpu_torch.data.datamodule import DataModule
    from torchmdnet_tpu_torch.models.model import create_model
    from torchmdnet_tpu_torch.train.trainer import Trainer, read_checkpoint

    log_dir = OUT_DIR / "trainer"
    hp = dict(train_args(), batch_size=TRAIN_MOLS,
              inference_batch_size=TRAIN_MOLS, lr=TRAIN_LR,
              lr_warmup_steps=2, num_epochs=2, save_interval=1, seed=0,
              train_size=256, val_size=64, test_size=64, log_dir=str(log_dir),
              train_loss="mse_loss", standardize=False, splits=None)
    ds = SyntheticMolecules(384, seed=7)
    pot = create_model(hp, device="cuda", seed=0)
    trainer = Trainer(pot, hp, DataModule(hp, dataset=ds))
    trainer.dm.setup("fit")
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    test, test_launches = counted_run(trainer.test)
    with open(log_dir / "metrics.csv") as fh:
        rows = list(csv.reader(fh))
    names = sorted(os.listdir(log_dir))
    epochs = sorted((n for n in names if n.startswith("epoch=")
                     and n.endswith(".ckpt")),
                    key=lambda n: int(n.split("-")[0][len("epoch="):]))
    sd_last, hp_saved = read_checkpoint(log_dir / epochs[-1])
    fresh = create_model(hp_saved, device="cuda", seed=9)
    fresh.module.load_state_dict(sd_last, strict=True)
    db = trainer._to_device_batch(next(iter(trainer.dm.val_dataloader())))
    kw = dict(num_mols=TRAIN_MOLS)
    y_f, f_f = fresh.apply(db["z"], db["pos"], db["batch"], **kw)
    y_t, f_t = pot.apply(db["z"], db["pos"], db["batch"], **kw)
    e_rel, f_rel = rel_err(y_f, y_t.detach())[1], rel_err(f_f, f_t)[1]
    sd_best, _ = read_checkpoint(log_dir / "best.ckpt")
    best_is_epoch = any(
        all(torch.equal(sd_best[k], sd[k]) for k in sd)
        for sd in (read_checkpoint(log_dir / n)[0] for n in epochs))
    row = {"phase": "trainer", "epochs": hp["num_epochs"],
           "batches_per_epoch": len(trainer.dm.train_dataloader()),
           "max_atoms": trainer.dm.train_dataloader().max_atoms,
           "fit_s": fit_s, "columns": rows[0], "rows": len(rows) - 1,
           "checkpoints": names, "reload_energy_rel_err": e_rel,
           "reload_force_rel_err": f_rel, "best_is_an_epoch": best_is_epoch,
           "test": test, "test_launches": test_launches,
           "metrics": dict(zip(rows[0], rows[-2]))}
    emit(row)
    check(rows[0] == TRAINER_COLUMNS, f"trainer: columns {rows[0]}")
    check(len(rows) == 1 + hp["num_epochs"] + 1, "trainer: metrics rows")
    check(len(epochs) == hp["num_epochs"] and "best.ckpt" in names
          and all(n + ".native" in names for n in epochs + ["best.ckpt"]),
          f"trainer: checkpoints {names}")
    check(e_rel <= 1e-6 and f_rel <= 1e-6,
          f"trainer: reloaded checkpoint gives other energies "
          f"({e_rel:.3g}, {f_rel:.3g})")
    check(best_is_epoch, "trainer: best.ckpt is no epoch's weights")
    check(all(math.isfinite(v) for v in test.values()),
          f"trainer: test metrics {test}")
    # evaluation runs with the weights' gradients off: rows 5 and 7, no row 6
    check(test_launches["cheb_filter"] > 0
          and test_launches["cheb_filter_dot"] > 0
          and test_launches["cheb_project"] == 0,
          f"trainer: test-pass launches {test_launches}")
    pot.module.requires_grad_(False)


# ---------------------------------------------------------------- serve
# examples/TensorNet2-AceFF.yaml, copied (the port imports no yaml): the
# AceFF recipe at full width, TensorNet2 2 x 128 with the all-to-all
# Coulomb head (coulomb_cutoff: null)
ACEFF_ARGS = dict(
    activation="silu", atom_filter=-1, batch_size=16, charge=True,
    cutoff_lower=0.0, cutoff_upper=4.5, dataset="Ace",
    dataset_arg={"paths": "~/data/aceff_h5"}, dataset_root="~/data",
    derivative=True, early_stopping_patience=40, embedding_dimension=128,
    equivariance_invariance_group="O(3)", y_weight=1.0, neg_dy_weight=10.0,
    inference_batch_size=16, log_dir="logs/", lr=0.0003, lr_factor=0.8,
    lr_min=1.0e-07, lr_patience=10, lr_warmup_steps=1000,
    max_num_neighbors=64, max_z=128, model="tensornet2", num_epochs=1000,
    num_layers=2, num_rbf=32, output_model="ScalarPlusWeightedCoulomb",
    q_dim=16, q_weights=[[1.0] * 16] * 3, coulomb_cutoff=None, precision=32,
    rbf_type="expnorm", reduce_op="add", save_interval=5, seed=1,
    standardize=False, test_size=0.01, train_size=0.9, trainable_rbf=False,
    val_size=0.05, weight_decay=0.0, static_shapes=True)
# load_model's overrides: kernels 1, 2 and 3 on the path
SERVE_KWARGS = dict(derivative=True, pallas_embedding=True,
                    pallas_edge_mlp=True)
SERVE_KERNELS = ("radial_embedding_fwd", "radial_embedding_bwd",
                 "edge_mlp_pre")
# the recipe's inference_batch_size, and a batch of about 7,600 atoms
SERVE_BATCHES = (16, 128)
# elements of drug-like molecules and their shares
SERVE_Z = (1, 6, 7, 8, 9, 16, 17)
SERVE_P = (0.46, 0.32, 0.08, 0.09, 0.02, 0.02, 0.01)
SERVE_OLD_TOL = 1e-6  # old-format against new-format energies, relative


def serve_molecule(rng, n):
    """``n`` atoms grown as a branched chain: each new atom 1.0-1.6 Å from
    one of the last four and at least 1.2 Å from every other (a 0.9 Å
    floor packs up to ~67 atoms within 4.5 Å, past the recipe's K = 64;
    drug-like molecules hold ~30-45)."""
    pos = np.zeros((n, 3))
    for i in range(1, n):
        while True:
            v = rng.randn(3)
            p = pos[max(0, i - 1 - rng.randint(4))] + v / np.linalg.norm(
                v) * rng.uniform(1.0, 1.6)
            if np.min(np.linalg.norm(pos[:i] - p, axis=1)) >= 1.2:
                break
        pos[i] = p
    return pos - pos.mean(0)


def molecule_batch(n_mols, seed, sizes, draw_z, cutoff):
    """``n_mols`` seeded ``serve_molecule``s of ``sizes[0]`` to
    ``sizes[1] − 1`` atoms, Z from ``draw_z(rng, n)``, 40 Å apart on a
    grid: ``(z, pos, batch, the generator, the most neighbors an atom has
    within ``cutoff``, self included)``."""
    rng = np.random.RandomState(seed)
    side = int(math.ceil(n_mols ** (1 / 3)))
    zs, ps, bs = [], [], []
    most = 0
    for m in range(n_mols):
        p = serve_molecule(rng, rng.randint(*sizes))
        d = np.linalg.norm(p[:, None] - p[None], axis=-1)
        most = max(most, int((d < cutoff).sum(1).max()))
        cell = np.array([m % side, m // side % side, m // side ** 2])
        ps.append(p + 40.0 * cell)
        zs.append(draw_z(rng, len(p)))
        bs.append(np.full(len(p), m))
    return (np.concatenate(zs).astype(np.int64),
            np.concatenate(ps).astype(np.float32),
            np.concatenate(bs).astype(np.int64), rng, most)


def spice_z(rng, n):
    return rng.choice(SERVE_Z, n, p=SERVE_P)


def serve_batch(n_mols, seed):
    """``n_mols`` seeded molecules of 24-96 atoms, Z from ``SERVE_Z``,
    total charges from {−1, 0, 1}, 40 Å apart on a grid: ``(z, pos,
    batch, q, the most neighbors an atom has within the cutoff, self
    included)``."""
    z, pos, batch, rng, most = molecule_batch(
        n_mols, seed, (24, 97), spice_z, ACEFF_ARGS["cutoff_upper"])
    q = rng.randint(-1, 2, n_mols).astype(np.float32)
    return z, pos, batch, q, most


def old_format(path, old_path):
    """The checkpoint at ``path`` in the old AceFF layout, marked with
    ``check_errors``: the inverse of ``remix_linear`` on the embedding's
    ``linears_scalar.1``."""
    ckpt = torch.load(path, weights_only=False)
    sd = ckpt["state_dict"]
    key = "model.representation_model.tensor_embedding.linears_scalar.1"
    w, b = sd[key + ".weight"], sd[key + ".bias"]
    a = w.shape[0]
    sd[key + ".weight"] = w.reshape(3, a // 3, -1).transpose(0, 1).reshape(
        w.shape).contiguous()
    sd[key + ".bias"] = b.reshape(3, a // 3).T.reshape(a).contiguous()
    ckpt["hyper_parameters"]["check_errors"] = True
    torch.save(ckpt, old_path)
    return old_path


def serve_inputs(batch, device):
    """``(z, pos, batch, q)`` of a serve batch as tensors on ``device``
    (inputs already on the card: a host copy inside the timed call would
    wait for the stream)."""
    return tuple(torch.as_tensor(a, device=device) for a in batch[:4])


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms, for evaluations that must agree
    bitwise: on the card ``index_add`` (the segment sums, the backward of
    ``index_select``) otherwise adds with atomics in any order, which
    moves energies and forces by up to ~1e-6 of their max from one run to
    the next.  An op without a deterministic form warns (the warnings are
    returned in the list yielded); uninitialised memory is left as is."""
    import torch.utils.deterministic as det

    mode = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(mode, warn_only=warn_only)
        det.fill_uninitialized_memory = fill


def serve_run(pot, inputs):
    """One evaluation of ``pot`` (a potential or an ensemble)."""
    z, pos, seg, q = inputs
    return lambda: pot.apply(z, pos, seg, num_mols=len(q), q=q)


def serve_energy_only(pot, args, batch):
    """Energies of ``pot`` on the card against the same model and weights
    on the CPU (a head without forces): (relative error, energies)."""
    from torchmdnet_tpu_torch.models.model import create_model

    cpu = create_model(args, device="cpu", seed=0)
    cpu.module.load_state_dict({k: v.cpu() for k, v in
                                pot.module.state_dict().items()})
    y, f = serve_run(pot, serve_inputs(batch, pot.device))()
    y_c, _ = serve_run(cpu, serve_inputs(batch, "cpu"))()
    check(f is None and bool(torch.isfinite(y).all()),
          "serve: non-finite energies")
    return rel_err(y.cpu(), y_c)[1], y


def phase_serve():
    """Serving the AceFF recipe from a checkpoint: a seeded TensorNet2
    with the all-to-all Coulomb head written by ``save_checkpoint``, read
    by ``load_model(path, device="cuda", derivative=True,
    pallas_embedding=True, pallas_edge_mlp=True)``; energies and forces
    of a batch of 16 molecules (the recipe's ``inference_batch_size``)
    and of 128 (~7,600 atoms), each against the plain versions on the
    CPU, ms per evaluation, peak memory, a profile of each (its device
    ms) and one of the 128 batch's all-to-all Coulomb term alone; the old
    AceFF layout of the same weights; a 3-checkpoint ensemble from a zip;
    TensorNet 2 x 128 with the ``DipoleMoment`` head, and with
    ``atom_filter=1``, card against CPU."""
    from torchmdnet_tpu_torch.models.model import (
        Ensemble, create_model, load_model)
    from torchmdnet_tpu_torch.models.output_modules import (
        all_to_all_coulomb)
    from torchmdnet_tpu_torch.utils.checkpoint import save_checkpoint

    out = OUT_DIR / "serve"
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    flags = dict(ACEFF_ARGS, pallas_embedding=True, pallas_edge_mlp=True)
    paths = []
    for seed in range(3):
        writer = create_model(flags, device=dev, seed=seed)
        paths.append(save_checkpoint(out / f"aceff_{seed}.ckpt", writer,
                                     hparams=ACEFF_ARGS))
        if seed == 0:
            first = writer
        else:
            del writer
    pot = load_model(paths[0], device="cuda", **SERVE_KWARGS)
    loaded, written = pot.module.state_dict(), first.module.state_dict()
    weights_diff = max(float((loaded[k] - written[k]).abs().max())
                       for k in written)
    check(loaded.keys() == written.keys() and weights_diff == 0.0
          and pot.module.mean == first.module.mean
          and pot.module.std == first.module.std,
          f"serve: the loaded weights differ by {weights_diff}")
    batches = {n: serve_batch(n, seed=31 + n) for n in SERVE_BATCHES}

    checks = []  # (condition, message), checked after the row is printed
    row = {"phase": "serve", "tolerance": TOL, "args": {
        k: ACEFF_ARGS[k] for k in ("model", "embedding_dimension",
                                   "num_layers", "num_rbf", "cutoff_upper",
                                   "max_num_neighbors", "q_dim",
                                   "coulomb_cutoff", "output_model")},
        "overrides": SERVE_KWARGS, "weights_max_abs_diff": weights_diff}
    old = load_model(old_format(paths[0], out / "aceff_old.ckpt"),
                     device="cuda", **SERVE_KWARGS)
    ens = load_model(zip_checkpoints(out, paths), device="cuda",
                     return_std=True, **SERVE_KWARGS)
    check(isinstance(ens, Ensemble) and len(ens.members) == 3,
          "serve: the zip did not load as a 3-member ensemble")
    for n, b in batches.items():
        most = b[4]
        check(most <= ACEFF_ARGS["max_num_neighbors"],
              f"serve: {most} neighbors overflow K")
        t, tc = serve_inputs(b, dev), serve_inputs(b, "cpu")
        before = launch_counts()
        y, f = serve_run(pot, t)()
        check_launched(SERVE_KERNELS, before)
        # the loaded, written and old-format potentials evaluated without
        # the atomics' run-to-run spread (``run_to_run``: that spread)
        with deterministic() as caught:
            y_d, f_d = serve_run(pot, t)()
            y_w, f_w = serve_run(first, t)()
            y_o, _ = serve_run(old, t)()
        e_err, f_rel, energy = against_cpu(pot, pot.hparams,
                                           lambda m: serve_run(m, t)(),
                                           lambda m: serve_run(m, tc)())
        ys = serve_run(ens, t)()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = {"mols": n, "atoms": len(b[0]), "max_neighbors": most,
             "energy": energy, "energy_rel_err_vs_cpu": e_err,
             "force_rel_err_vs_cpu": f_rel,
             "vs_writer": [rel_err(y_d, y_w)[1], rel_err(f_d, f_w)[1]],
             "old_format_energy_rel_err": rel_err(y_o, y_d)[1],
             "run_to_run": [rel_err(y, y_d)[1], rel_err(f, f_d)[1]],
             "nondeterministic_ops": sorted({str(w.message)[:120]
                                             for w in caught}),
             "ensemble_std_energy_max": float(ys[2].max()),
             "ensemble_std_energy_min": float(ys[2].min()),
             "time_ms": time_ms(serve_run(pot, t), reps=5),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "ensemble_ms": time_ms(serve_run(ens, t), reps=3)}
        # an evaluation issues thousands of launches, more than the
        # launch queue holds behind device_ms's spin kernel: its device
        # time is the profile's sum of kernel times
        prof = phase_profile(f"serve_{n}", serve_run(pot, t))
        r["device_ms"], r["idle_share"] = prof["device_ms"], prof["idle_share"]
        check(r["device_ms"] > 0, f"serve {n}: the profile saw no device time")
        row[f"batch_{n}"] = r
        checks += [
            (e_err <= TOL and f_rel <= TOL,
             f"serve {n}: card vs CPU {e_err:.3g} / {f_rel:.3g}"),
            (max(r["vs_writer"]) <= 1e-6, f"serve {n}: the loaded potential "
             f"differs from the writing one {r['vs_writer']}"),
            (r["old_format_energy_rel_err"] <= SERVE_OLD_TOL,
             f"serve {n}: old format {r['old_format_energy_rel_err']:.3g}"),
            (all(bool(torch.isfinite(v).all()) for v in ys)
             and bool((ys[2] > 0).all()) and bool((ys[3] > 0).any()),
             f"serve {n}: ensemble stds not finite and positive")]
    del first, old, ens
    torch.cuda.empty_cache()

    # the 128 batch's all-to-all Coulomb term alone (forward and
    # backward, at the batch's geometry)
    mols = SERVE_BATCHES[-1]
    _, pos_t, seg_t, _ = serve_inputs(batches[mols], dev)
    charges = torch.randn(len(pos_t), 3 * ACEFF_ARGS["q_dim"], device=dev,
                          generator=torch.Generator(dev).manual_seed(3))
    qw = pot.module.output_model.qweights

    def coulomb():
        p = pos_t.detach().requires_grad_(True)
        c = charges.detach().requires_grad_(True)
        e = all_to_all_coulomb(p, seg_t, c, qw, mols,
                               pot.module.output_model.FACTOR)
        torch.autograd.grad(e.sum(), (p, c))

    phase_profile(f"serve_{mols}_all_to_all", coulomb)
    big = row[f"batch_{mols}"]
    big["all_to_all_device_ms"] = device_ms(coulomb, reps=5)
    big["all_to_all_share"] = big["all_to_all_device_ms"] / big["device_ms"]
    del pot
    torch.cuda.empty_cache()

    # TensorNet 2 x 128 with the DipoleMoment head, and with atom_filter
    b = batches[SERVE_BATCHES[0]]
    for name, extra in (("tensornet_dipole",
                         dict(output_model="DipoleMoment")),
                        ("tensornet_atom_filter",
                         dict(output_model="Scalar", atom_filter=1))):
        args = dict(flags, model="tensornet", derivative=False, **extra)
        tn = create_model(args, device=dev, seed=4)
        err, y = serve_energy_only(tn, args, b)
        row[name] = {"energy_rel_err_vs_cpu": err,
                     "energy_sum": float(y.sum())}
        checks.append((err <= TOL, f"serve {name}: card vs CPU {err:.3g}"))
        del tn
    emit(row)
    for p in list(paths) + [out / "aceff_old.ckpt", out / "aceff.zip"]:
        os.remove(p)
    for cond, what in checks:
        check(cond, what)


# ---------------------------------------------------------------- train_aceff
# the AceFF recipe trained on the card: batches of its batch_size (16) of
# phase_serve's molecules, AdamW at its lr with its force weight, no
# warm-up (its 1,000 warm-up steps would hold the LR near 0 here)
ACEFF_TRAIN_STEPS = 20
ACEFF_TRAIN_KERNELS = SERVE_KERNELS  # kernels 1, 2 and 3
ACEFF_RELOAD_TOL = 1e-5


class AceMolecules:
    """``phase_serve``'s seeded molecules (24-96 atoms, total charges −1/0/1)
    with a random energy and random forces: a dataset of numpy dicts."""

    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self.samples = []
        for _ in range(n):
            pos = serve_molecule(rng, rng.randint(24, 97))
            k = len(pos)
            self.samples.append(dict(
                z=rng.choice(SERVE_Z, k, p=SERVE_P).astype(np.int64),
                pos=pos.astype(np.float32), q=float(rng.randint(-1, 2)),
                y=rng.randn(1, 1), neg_dy=rng.randn(k, 3).astype(np.float32)))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return dict(self.samples[int(idx)])


def aceff_train_batch(n_mols, seed):
    """A batch of ``n_mols`` of ``serve_batch``'s molecules on the card with
    their charges, random energies and random forces (no ghost rows)."""
    z, pos, seg, q, most = serve_batch(n_mols, seed)
    check(most <= ACEFF_ARGS["max_num_neighbors"],
          f"train_aceff: {most} neighbors overflow K")
    rng = np.random.RandomState(seed + 1)
    out = dict(z=z, pos=pos, batch=seg, q=q,
               y=rng.randn(n_mols, 1).astype(np.float32),
               neg_dy=rng.randn(len(z), 3).astype(np.float32),
               mol_mask=np.ones(n_mols, bool))
    return {k: torch.as_tensor(v, device="cuda") for k, v in out.items()}


def phase_train_aceff():
    """The AceFF recipe (``ACEFF_ARGS``: TensorNet2 2 x 128, K = 64, q_dim
    16, the all-to-all Coulomb head, ``charge: true``) trained on the card
    with kernels 1-3 (``SERVE_KWARGS``' flags): on a batch of 16 seeded
    molecules (~860 atoms) with charges and random targets, one step's
    loss (y weight 1, ``neg_dy_weight`` 10) and every weight gradient
    against the same weights with both flags off (the plain chains) to
    1e-4 of each gradient's max |·|; two warm-up and 20 timed AdamW steps
    at lr 3e-4 (the loss must fall; kernels 1, 2 and 3 launched in every
    step), ms per step, mol/s, peak memory and a profiled step; then
    ``Trainer.fit`` for one epoch (64 train and 16 val molecules) and the
    last checkpoint through ``load_model`` into a served evaluation equal
    to the trained module's (1e-5 relative).  The same recipe with
    ``remat=True`` from the same weights: its loss and gradients against
    the step without remat (1e-4), and its own timed steps (ms, device
    ms, the steps' peak memory above the resident state, launches per
    step: kernels 1 and 3 run twice, in the forward and in the
    recompute; the neighbour sum once)."""
    from torchmdnet_tpu_torch.data.datamodule import DataModule
    from torchmdnet_tpu_torch.models.model import create_model, load_model
    from torchmdnet_tpu_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    n_mols, lr = ACEFF_ARGS["batch_size"], ACEFF_ARGS["lr"]
    neg_dy_w = ACEFF_ARGS["neg_dy_weight"]
    flags = dict(ACEFF_ARGS, **SERVE_KWARGS)
    pot = create_model(flags, device=dev, seed=5)
    plain = create_model(dict(flags, pallas_embedding=False,
                              pallas_edge_mlp=False), device=dev, seed=5)
    plain.module.load_state_dict(pot.module.state_dict())
    batch = aceff_train_batch(n_mols, seed=61)
    row = {"phase": "train_aceff", "mols": n_mols,
           "atoms": int(batch["z"].shape[0]), "lr": lr,
           "neg_dy_weight": neg_dy_w, "steps_timed": ACEFF_TRAIN_STEPS,
           "tolerance": TOL, **grads_against(pot, plain, batch,
                                             num_mols=n_mols,
                                             neg_dy_weight=neg_dy_w)}
    del plain
    rpot = create_model(dict(flags, remat=True), device=dev, seed=5)
    rpot.module.load_state_dict(pot.module.state_dict())
    remat = {k: v for k, v in grads_against(
        rpot, pot, batch, num_mols=n_mols, neg_dy_weight=neg_dy_w).items()
        if k in ("loss_rel_err", "grad_rel_err", "worst_param")}
    pot.module.requires_grad_(True)
    torch.cuda.empty_cache()
    t, counts, state, step = train_timed(
        pot, batch, n_mols, lr, ACEFF_TRAIN_STEPS, neg_dy_weight=neg_dy_w)
    row.update(t)
    prof = phase_profile("train_aceff", lambda: step(state, batch))
    row["device_ms"], row["idle_share"] = prof["device_ms"], prof["idle_share"]
    del state, step
    pot.module.requires_grad_(False)
    torch.cuda.empty_cache()
    t, _, state, step = train_timed(
        rpot, batch, n_mols, lr, ACEFF_TRAIN_STEPS, neg_dy_weight=neg_dy_w)
    prof = phase_profile("train_aceff_remat", lambda: step(state, batch))
    remat.update({k: t[k] for k in ("ms_per_step", "mol_per_s", "peak_mem_gb",
                                    "step_peak_gb", "launches_per_step",
                                    "loss_first", "loss_last")},
                 device_ms=prof["device_ms"], idle_share=prof["idle_share"])
    row["remat"] = remat
    del state, step, rpot
    torch.cuda.empty_cache()

    # Trainer.fit, one epoch, and its checkpoint served
    log_dir = OUT_DIR / "train_aceff"
    hp = dict(flags, num_epochs=1, lr_warmup_steps=0, save_interval=1,
              train_size=64, val_size=16, test_size=0, log_dir=str(log_dir),
              train_loss="mse_loss", splits=None, num_workers=0)
    tpot = create_model(hp, device=dev, seed=6)
    trainer = Trainer(tpot, hp, DataModule(hp, dataset=AceMolecules(80, 71)))
    trainer.dm.setup("fit")
    t0 = time.perf_counter()
    _, fit_counts = counted_run(trainer.fit)
    torch.cuda.synchronize()
    row["fit_s"] = time.perf_counter() - t0
    ckpts = sorted(n for n in os.listdir(log_dir)
                   if n.startswith("epoch=") and n.endswith(".ckpt"))
    check(len(ckpts) == 1, f"train_aceff: checkpoints {ckpts}")
    served = load_model(log_dir / ckpts[0], device="cuda", **SERVE_KWARGS)
    tpot.module.requires_grad_(False)
    b = serve_inputs(serve_batch(n_mols, seed=81), dev)
    y_s, f_s = serve_run(served, b)()
    y_t, f_t = serve_run(tpot, b)()
    row.update(fit_launches={k: v for k, v in fit_counts.items() if v},
               checkpoint=ckpts[0],
               served_vs_trained=[rel_err(y_s, y_t)[1], rel_err(f_s, f_t)[1]])
    emit(row)
    for name in os.listdir(log_dir):
        if name.endswith(".ckpt") or name.endswith(".native"):
            os.remove(log_dir / name)
    check(row["loss_rel_err"] <= TOL and row["grad_rel_err"] <= TOL,
          f"train_aceff: kernels vs plain loss {row['loss_rel_err']:.3g}, "
          f"gradient {row['grad_rel_err']:.3g} ({row['worst_param']})")
    check(remat["loss_rel_err"] <= TOL and remat["grad_rel_err"] <= TOL,
          f"train_aceff: remat vs no remat loss {remat['loss_rel_err']:.3g}, "
          f"gradient {remat['grad_rel_err']:.3g} ({remat['worst_param']})")
    for r in (row, remat):
        check(math.isfinite(r["loss_first"]) and math.isfinite(r["loss_last"])
              and r["loss_last"] < r["loss_first"],
              f"train_aceff: the loss did not fall ({r['loss_first']:.4g} → "
              f"{r['loss_last']:.4g})")
    for k in ACEFF_TRAIN_KERNELS:
        check(counts[k] >= ACEFF_TRAIN_STEPS,
              f"train_aceff: {k} launched {counts[k]} times in "
              f"{ACEFF_TRAIN_STEPS} steps")
        check(fit_counts[k] > 0, f"train_aceff: {k} not launched by fit")
    check(max(row["served_vs_trained"]) <= ACEFF_RELOAD_TOL,
          f"train_aceff: the served checkpoint differs from the trained "
          f"module {row['served_vs_trained']}")


# ---------------------------------------------------------------- adapters
# External over replicas of one molecule, optimize on dhfr, the exported
# AceFF program
ADAPTER_REPLICAS = 16
ADAPTER_WARMUP = 3  # External's cuda_graph_warmup_steps
GRAPH_TOL = 1e-5  # graph against eager, exported against direct
OPT_CALLS = 50
OPT_KERNELS = ("radial_embedding_fwd", "radial_embedding_bwd", "edge_mlp")


def adapter_external(ckpt, row, checks):
    """``External`` on ``ADAPTER_REPLICAS`` jittered replicas of one seeded
    AceFF molecule: eager, with ``use_cuda_graph=True`` and on the CPU;
    the graph's launches a capture, ms a call both ways."""
    from torchmdnet_tpu_torch.md.calculators import External

    rng = np.random.RandomState(91)
    mol = serve_molecule(rng, 48)
    z = spice_z(rng, len(mol))
    emb = np.tile(z, (ADAPTER_REPLICAS, 1))
    pos = (mol[None] + rng.uniform(-0.05, 0.05, (ADAPTER_REPLICAS,
                                                 len(mol), 3))
           ).astype(np.float32)
    pos_t = torch.as_tensor(pos, device="cuda")
    eager = External(ckpt, emb, device="cuda", **SERVE_KWARGS)
    graphed = External(ckpt, emb, device="cuda", use_cuda_graph=True,
                       cuda_graph_warmup_steps=ADAPTER_WARMUP,
                       **SERVE_KWARGS)
    cpu = External(ckpt, emb, device="cpu", **SERVE_KWARGS)
    (e, f), eager_counts = counted_run(lambda: eager.calculate(pos_t))
    # the first graphed call: the warm-up calls and the capture
    (e_g, f_g), first = counted_run(lambda: graphed.calculate(pos_t))
    (e_g, f_g), replayed = counted_run(lambda: graphed.calculate(pos_t))
    e_c, f_c = cpu.calculate(pos)
    per_capture = {k: first[k] // (ADAPTER_WARMUP + 1) for k in SERVE_KERNELS}
    r = {"replicas": ADAPTER_REPLICAS, "atoms": int(emb.size),
         "graph_vs_eager": [rel_err(e_g, e)[1], rel_err(f_g, f)[1]],
         "card_vs_cpu": [rel_err(e.cpu(), e_c)[1], rel_err(f.cpu(), f_c)[1]],
         "eager_launches": {k: eager_counts[k] for k in SERVE_KERNELS},
         # a replay issues the captured launches again without Python: the
         # path's launches are these per capture times the replays
         "graph_launches_per_capture": per_capture,
         "launches_counted_in_a_replay": {k: replayed[k]
                                          for k in SERVE_KERNELS},
         "eager_ms": time_ms(lambda: eager.calculate(pos_t), reps=10),
         "graph_ms": time_ms(lambda: graphed.calculate(pos_t), reps=10)}
    r["graph_replays"] = graphed._graphs[False].replays
    r["eager_over_graph"] = r["eager_ms"] / r["graph_ms"]
    row["external"] = r
    checks += [
        (max(r["graph_vs_eager"]) <= GRAPH_TOL,
         f"adapters: graph vs eager {r['graph_vs_eager']}"),
        (max(r["card_vs_cpu"]) <= TOL,
         f"adapters: External card vs CPU {r['card_vs_cpu']}"),
        (all(per_capture[k] > 0 and per_capture[k] == eager_counts[k]
             for k in SERVE_KERNELS)
         and not any(replayed[k] for k in SERVE_KERNELS),
         f"adapters: graph launches {r['graph_launches_per_capture']} a "
         f"capture, eager {r['eager_launches']}, a replay "
         f"{r['launches_counted_in_a_replay']}")]
    return per_capture


def adapter_optimize(row, checks):
    """``optimize`` on the dhfr system (TensorNet 2 x 128 exact: kernels
    1, 2 and 4): ``rebuild_every=1`` and ``25`` (skin 1 Å, K = 128 at
    5.5 Å) over ``OPT_CALLS`` seeded positions within 0.1 Å of the start
    (ms a call, timed after the first), then five of them again against
    a direct ``Potential.apply`` (K = 64 at 4.5 Å); the direct call's
    ms."""
    from torchmdnet_tpu_torch.models.model import create_model
    from torchmdnet_tpu_torch.optimize import optimize
    from torchmdnet_tpu_torch.utils.graphs import WARMUP_STEPS

    (z, pos, _, box, _), seg = dhfr_system()
    pot = create_model(dhfr_args(**DHFR_EXACT), device="cuda", seed=0)
    dev = torch.device("cuda")
    zt, st, bt = (torch.as_tensor(a, device=dev) for a in (z, seg, box))
    rng = np.random.RandomState(93)
    moves = [torch.as_tensor(pos + rng.uniform(-0.1, 0.1, pos.shape)
                             .astype(np.float32), device=dev)
             for _ in range(OPT_CALLS)]
    out = {}
    per_capture = {}
    for every in (1, 25):
        kw = {} if every == 1 else dict(rebuild_every=25, skin=1.0,
                                        k_max=DHFR_MD_K)
        step = optimize(pot, zt, st, num_mols=1, box=bt, **kw)
        # the first call: the graph's warm-up calls and its capture
        _, first = counted_run(lambda: step(moves[0]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in moves[1:]:
            step(p)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (OPT_CALLS - 1)
        errs = []
        for p in moves[::10]:
            y, f = step(p)
            y_d, f_d = pot.apply(zt, p, st, num_mols=1, box=bt)
            errs.append(max(rel_err(y, y_d)[1], rel_err(f, f_d)[1]))
        per_capture[every] = {k: first[k] // (WARMUP_STEPS + 1)
                              for k in OPT_KERNELS}
        out[f"rebuild_every_{every}"] = {
            "ms_per_call": ms,
            "max_rel_err_vs_direct": max(errs), "overflow": step.overflow(),
            "launches_first_call": {k: first[k] for k in OPT_KERNELS},
            "graph_launches_per_capture": per_capture[every],
            "graph_replays": step.runner.graph.replays}
        checks += [(max(errs) <= GRAPH_TOL and not step.overflow(),
                    f"adapters: optimize rebuild_every={every} vs direct "
                    f"{max(errs):.3g}, overflow {step.overflow()}"),
                   (all(first[k] > 0 for k in OPT_KERNELS),
                    f"adapters: optimize launches {per_capture[every]}")]
    out["direct_ms"] = wall_ms(lambda: pot.apply(zt, moves[1], st,
                                                 num_mols=1, box=bt))
    out["atoms"], out["args"] = int((seg == 0).sum()), "dhfr_args(DHFR_EXACT)"
    row["optimize"] = out
    return per_capture


def adapter_export(ckpt, row, checks):
    """``export_potential`` / ``load_exported`` of the AceFF potential at
    16 seeded molecules: the loaded program against the direct call, the
    kernels it launches, ms a call, the export's seconds and bytes."""
    from torchmdnet_tpu_torch.models.model import load_model
    from torchmdnet_tpu_torch.utils.export import (
        export_potential, load_exported)

    pot = load_model(ckpt, device="cuda", **SERVE_KWARGS)
    z, pos, seg, q = serve_inputs(serve_batch(16, seed=95), "cuda")
    t0 = time.perf_counter()
    blob = export_potential(pot, z, seg, num_mols=16, q=q)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = load_exported(blob)
    load_s = time.perf_counter() - t0
    (y, f), counts = counted_run(lambda: run(pos))
    y_d, f_d = pot.apply(z, pos, seg, num_mols=16, q=q)
    ops = sorted({str(n.target) for n in run.program.graph.nodes
                  if "tmdnet" in str(n.target)})
    r = {"mols": 16, "atoms": int(z.shape[0]), "export_s": export_s,
         "load_s": load_s, "bytes": len(blob), "operators": ops,
         "vs_direct": [rel_err(y, y_d)[1], rel_err(f, f_d)[1]],
         "launches": {k: counts[k] for k in SERVE_KERNELS},
         "ms": time_ms(lambda: run(pos), reps=10),
         "direct_ms": time_ms(serve_run(pot, (z, pos, seg, q)), reps=10)}
    row["export"] = r
    checks += [(max(r["vs_direct"]) <= GRAPH_TOL,
                f"adapters: exported vs direct {r['vs_direct']}"),
               (all(r["launches"][k] > 0 for k in SERVE_KERNELS),
                f"adapters: the exported program launched {r['launches']}")]
    return r["launches"]


def phase_adapters():
    """The inference adapters on the card: ``External`` (eager, CUDA
    graph, CPU), ``optimize`` on dhfr and the exported AceFF program, on
    phase ``serve``'s AceFF checkpoint (``save_checkpoint`` of the seed-0
    model); returns each path's launches (``kernels`` line)."""
    from torchmdnet_tpu_torch.models.model import create_model
    from torchmdnet_tpu_torch.utils.checkpoint import save_checkpoint

    out = OUT_DIR / "adapters"
    out.mkdir(parents=True, exist_ok=True)
    flags = dict(ACEFF_ARGS, pallas_embedding=True, pallas_edge_mlp=True)
    ckpt = save_checkpoint(out / "aceff_0.ckpt",
                           create_model(flags, device="cuda", seed=0),
                           hparams=ACEFF_ARGS)
    row, checks = {"phase": "adapters", "tolerance": GRAPH_TOL}, []
    t0 = time.perf_counter()
    paths = {"external_graph_per_capture": adapter_external(ckpt, row,
                                                            checks)}
    torch.cuda.empty_cache()
    opt = adapter_optimize(row, checks)
    paths["optimize_graph_per_capture"] = opt[25]
    torch.cuda.empty_cache()
    paths["exported_program"] = adapter_export(ckpt, row, checks)
    row["phase_s"] = time.perf_counter() - t0
    emit(row)
    os.remove(ckpt)
    for cond, what in checks:
        check(cond, what)
    return paths


# ---------------------------------------------------------------- data_parallel
def phase_data_parallel():
    """Data parallelism on one card: a world of 1 over NCCL steps the
    AceFF recipe through ``make_data_parallel_train_step``, whose updated
    weights must equal the single-device step's on the same batch from
    the same weights (1e-6 of each weight's max); ``Trainer`` with
    ``ngpus=2`` on this one card trains single-device (JAX's clamp)."""
    import torch.distributed as dist

    from torchmdnet_tpu_torch.data.datamodule import DataModule
    from torchmdnet_tpu_torch.models.model import create_model
    from torchmdnet_tpu_torch.parallel.dp import (
        free_port, make_data_parallel_train_step)
    from torchmdnet_tpu_torch.train.step import (
        create_train_state, make_train_step)
    from torchmdnet_tpu_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    flags = dict(ACEFF_ARGS, **SERVE_KWARGS)
    batch = aceff_train_batch(ACEFF_ARGS["batch_size"], seed=97)
    kw = dict(num_mols=ACEFF_ARGS["batch_size"],
              neg_dy_weight=ACEFF_ARGS["neg_dy_weight"])
    weights = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        for name, make in (("single", make_train_step),
                           ("nccl_world_1", make_data_parallel_train_step)):
            pot = create_model(flags, device=dev, seed=7)
            state = create_train_state(pot, lr=ACEFF_ARGS["lr"])
            with deterministic():
                _, metrics = make(pot, **kw)(state, batch)
            weights[name] = ({k: v.detach().clone() for k, v in
                              pot.module.state_dict().items()},
                             float(metrics["loss"]))
            del pot, state
    finally:
        dist.destroy_process_group()
    (w1, l1), (w2, l2) = weights["single"], weights["nccl_world_1"]
    diff = max(rel_err(w2[k], w1[k])[1] for k in w1)
    log_dir = OUT_DIR / "data_parallel"
    hp = dict(flags, ngpus=2, num_epochs=1, lr_warmup_steps=0,
              save_interval=1, train_size=32, val_size=16, test_size=0,
              log_dir=str(log_dir), train_loss="mse_loss", splits=None,
              num_workers=0)
    trainer = Trainer(create_model(hp, device=dev, seed=8), hp,
                      DataModule(hp, dataset=AceMolecules(48, 99)))
    trainer.dm.setup("fit")
    state = trainer.fit()
    row = {"phase": "data_parallel", "world_1_weights_rel_err": diff,
           "losses": [l1, l2], "trainer_ngpus_2": {
               "n_devices": trainer.n_devices, "steps": state.step,
               "world_size": trainer.world_size,
               "cards": torch.cuda.device_count()}}
    emit(row)
    for name in os.listdir(log_dir):
        if name.endswith(".ckpt") or name.endswith(".native"):
            os.remove(log_dir / name)
    check(diff <= 1e-6 and abs(l1 - l2) <= 1e-6 * abs(l1),
          f"data_parallel: world 1 vs single {diff:.3g}, losses {l1} {l2}")
    check(trainer.n_devices == min(2, torch.cuda.device_count())
          and state.step == 2,
          f"data_parallel: Trainer(ngpus=2) {row['trainer_ngpus_2']}")


# ---------------------------------------------------------------- et
# examples/ET-SPICE.yaml, ET-QM9.yaml and ET-MD17.yaml, copied (the port
# imports no yaml; tests/test_torch_recipe_args.py holds each copy, and
# ACEFF_ARGS, against its file)
ET_SPICE_ARGS = dict(
    activation="silu", atom_filter=-1, attn_activation="silu",
    batch_size=16, charge=False, cutoff_lower=0.0, cutoff_upper=10.0,
    dataset="SPICE", dataset_arg={"version": "1.1.4"},
    dataset_root="data", derivative=True, distance_influence="both",
    early_stopping_patience=50, ema_alpha_neg_dy=1.0, ema_alpha_y=1.0,
    embedding_dimension=128, inference_batch_size=16, log_dir="logs/",
    lr=0.0001, lr_factor=0.5, lr_min=1e-07, lr_patience=5,
    lr_warmup_steps=1000, max_num_neighbors=128, max_z=100,
    model="equivariant-transformer", neg_dy_weight=0.5,
    neighbor_embedding=True, ngpus=-1, num_epochs=500, num_heads=8,
    num_layers=5, num_nodes=1, num_rbf=64, num_workers=4,
    output_model="Scalar", precision=32, rbf_type="expnorm",
    redirect=False, reduce_op="add", save_interval=10, seed=1, spin=False,
    standardize=False, test_interval=10, test_size=None, train_size=0.8,
    trainable_rbf=False, val_size=0.1, vector_cutoff=True,
    weight_decay=0.0, y_weight=0.5)
ET_QM9_ARGS = dict(
    activation="silu", atom_filter=-1, attn_activation="silu",
    batch_size=128, charge=False, cutoff_lower=0.0, cutoff_upper=5.0,
    dataset="QM9", dataset_arg={"label": "energy_U0"},
    dataset_root="~/data", derivative=False, distance_influence="both",
    early_stopping_patience=150, ema_alpha_neg_dy=1.0, ema_alpha_y=1.0,
    embedding_dimension=256, inference_batch_size=128, log_dir="logs/",
    lr=0.0004, lr_factor=0.8, lr_min=1e-07, lr_patience=15,
    lr_warmup_steps=10000, max_num_neighbors=64, max_z=100,
    model="equivariant-transformer", neg_dy_weight=1.0,
    neighbor_embedding=True, ngpus=-1, num_epochs=3000, num_heads=8,
    num_layers=8, num_nodes=1, num_rbf=64, num_workers=4,
    output_model="Scalar", precision=32, prior_model="Atomref",
    rbf_type="expnorm", redirect=False, reduce_op="add", save_interval=10,
    seed=1, spin=False, standardize=False, test_interval=10,
    test_size=None, train_size=110000, trainable_rbf=False,
    val_size=10000, vector_cutoff=True, weight_decay=0.0, y_weight=1.0)
ET_MD17_ARGS = dict(
    activation="silu", attn_activation="silu", atom_filter=-1,
    batch_size=8, cutoff_lower=0.0, cutoff_upper=5.0, dataset="MD17",
    dataset_arg={"molecules": "aspirin"}, dataset_root="~/data",
    derivative=True, distance_influence="both",
    early_stopping_patience=300, ema_alpha_neg_dy=1.0, ema_alpha_y=0.05,
    embedding_dimension=128, y_weight=0.2, neg_dy_weight=0.8,
    inference_batch_size=64, log_dir="logs/", lr=0.001, lr_factor=0.8,
    lr_min=1e-07, lr_patience=30, lr_warmup_steps=1000,
    max_num_neighbors=32, max_z=100, model="equivariant-transformer",
    neighbor_embedding=True, num_epochs=3000, num_heads=8, num_layers=6,
    num_rbf=32, output_model="Scalar", precision=32, rbf_type="expnorm",
    reduce_op="add", save_interval=10, seed=1, standardize=True,
    test_interval=10, test_size=None, train_size=950, trainable_rbf=False,
    val_size=50, weight_decay=0.0, vector_cutoff=True)
# TorchMD-T and TorchMD-GN at upstream's defaults (their constructors'):
# no recipe in the repo, the models being deprecated upstream
T_GN_ARGS = dict(
    embedding_dimension=128, num_layers=6, num_rbf=50, rbf_type="expnorm",
    trainable_rbf=True, activation="silu", attn_activation="silu",
    neighbor_embedding=True, num_heads=8, distance_influence="both",
    cutoff_lower=0.0, cutoff_upper=5.0, max_z=100, max_num_neighbors=32,
    aggr="add", derivative=True, output_model="Scalar", reduce_op="add",
    precision=32, atom_filter=-1, prior_model=None)
# QM9's elements (H, C, N, O, F) and rough shares; its molecules hold
# up to 29 atoms
QM9_Z = (1, 6, 7, 8, 9)
QM9_P = (0.51, 0.35, 0.055, 0.08, 0.005)
ASPIRIN_Z = (6,) * 9 + (1,) * 8 + (8,) * 4  # C9H8O4, 21 atoms
F64_TOL = 1e-4  # float32 against float64 on the card: energies, forces
F64_GRAD_TOL = 1e-3  # the same for a force loss's weight gradients
ET_TRAIN_STEPS = 10
ET_MD_STEPS = 100


def qm9_z(rng, n):
    return rng.choice(QM9_Z, n, p=QM9_P)


def aspirin_z(rng, n):
    return rng.permutation(np.asarray(ASPIRIN_Z[:n]))


def card_inputs(batch):
    """``(z, pos, batch)`` of a ``molecule_batch`` on the card."""
    return tuple(torch.as_tensor(a, device="cuda") for a in batch[:3])


def against_float64(pot, inputs, num_mols):
    """The float32 potential's energies (and forces) against the same
    weights in float64 on the card: relative errors ``[energy, forces]``
    (forces None without ``derivative``)."""
    from torchmdnet_tpu_torch.models.model import create_model

    p64 = create_model(dict(pot.hparams, precision=64), device="cuda",
                       mean=pot.module.mean, std=pot.module.std,
                       prior_models=copy.deepcopy(list(pot.module
                                                       .prior_model)))
    p64.module.load_state_dict(pot.module.state_dict())
    z, pos, seg = inputs
    y, f = pot.apply(z, pos, seg, num_mols=num_mols)
    y64, f64 = p64.apply(z, pos.double(), seg, num_mols=num_mols)
    del p64
    return [rel_err(y.double(), y64)[1],
            None if f is None else rel_err(f.double(), f64)[1]]


def timed_evaluation(pot, inputs, num_mols, reps=5):
    """ms per evaluation (CUDA events) and the peak GB it holds."""
    z, pos, seg = inputs
    run = lambda: pot.apply(z, pos, seg, num_mols=num_mols)  # noqa: E731
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(run, reps=reps)
    return run, {"time_ms": ms,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_et_serve():
    """The ET-SPICE recipe (ET 5 x 128, 8 heads, 64 expnorm rbf, 10 Å,
    K = 128, ``vector_cutoff``, forces, the EquivariantScalar head)
    written by ``save_checkpoint`` and read by ``load_model`` on the
    card, on its ``inference_batch_size`` (16) of seeded SPICE-like
    molecules (24-96 atoms, H to Cl): energies and forces, no row past K,
    the forces against the same weights in float64, ms per evaluation,
    peak memory, and a profile (phase ``profile_et_spice``: device ms,
    idle share, kernel groups).  Then the ET-QM9 recipe (ET 8 x 256, 64
    rbf, 5 Å, K = 64, the Atomref prior with a seeded table, energies
    only) the same way on its batch of 128 QM9-sized molecules (10-29
    atoms)."""
    from torchmdnet_tpu_torch.models.model import create_model, load_model
    from torchmdnet_tpu_torch.utils.checkpoint import save_checkpoint

    out = OUT_DIR / "et_serve"
    out.mkdir(parents=True, exist_ok=True)
    row = {"phase": "et_serve", "tolerance_vs_float64": F64_TOL}
    checks = []
    table = np.random.RandomState(5).uniform(-1.0, 0.0, 100) * 1e3
    recipes = (
        ("et_spice", ET_SPICE_ARGS, ET_SPICE_ARGS, (24, 97), spice_z, 91),
        # a trained file carries its prior's arguments (upstream's
        # train.py writes them); the table comes from the state dict
        ("et_qm9", dict(ET_QM9_ARGS, prior_args=[{"initial_atomref":
                                                   table.tolist()}]),
         dict(ET_QM9_ARGS, prior_args=[{"max_z": 100}]), (10, 30), qm9_z,
         93))
    for name, args, hparams, sizes, draw_z, seed in recipes:
        n = args["inference_batch_size"]
        writer = create_model(args, device="cuda", seed=seed)
        path = save_checkpoint(out / f"{name}.ckpt", writer, hparams=hparams)
        pot = load_model(path, device="cuda")
        loaded, written = pot.module.state_dict(), writer.module.state_dict()
        weights_diff = max(float((loaded[k] - written[k]).abs().max())
                           for k in written)
        check(loaded.keys() == written.keys() and weights_diff == 0.0,
              f"et_serve {name}: the loaded weights differ by {weights_diff}")
        b = molecule_batch(n, seed, sizes, draw_z, args["cutoff_upper"])
        most = b[4]
        check(most <= args["max_num_neighbors"],
              f"et_serve {name}: {most} neighbors overflow K")
        inputs = card_inputs(b)
        y, f = pot.apply(*inputs, num_mols=n)
        y_w, _ = writer.apply(*inputs, num_mols=n)
        del writer
        errs = against_float64(pot, inputs, n)
        run, r = timed_evaluation(pot, inputs, n)
        r.update(mols=n, atoms=len(b[0]), max_neighbors=most,
                 energy_sum=float(y.sum()),
                 vs_writer_energy=rel_err(y, y_w)[1],
                 vs_float64=errs,
                 finite=bool(torch.isfinite(y).all()) and (
                     f is None or bool(torch.isfinite(f).all())))
        if name == "et_spice":
            prof = phase_profile("et_spice", run)
            r["device_ms"], r["idle_share"] = (prof["device_ms"],
                                               prof["idle_share"])
            checks.append((r["device_ms"] > 0,
                           "et_serve: the profile saw no device time"))
        row[name] = r
        checks += [
            (r["finite"] and y.shape == (n, 1)
             and (f is None) == (not args["derivative"]),
             f"et_serve {name}: non-finite or misshapen outputs"),
            (r["vs_writer_energy"] <= 1e-5,
             f"et_serve {name}: the loaded potential differs from the "
             f"writing one ({r['vs_writer_energy']:.3g})"),
            (all(e <= F64_TOL for e in errs if e is not None),
             f"et_serve {name}: float32 vs float64 {errs}")]
        del pot, run
        os.remove(path)
        torch.cuda.empty_cache()
    emit(row)
    for cond, what in checks:
        check(cond, what)


class AspirinMolecules:
    """Seeded aspirin-shaped molecules (``serve_molecule`` geometry, the
    21 atoms of C9H8O4) with a random energy and random forces: a dataset
    of numpy dicts."""

    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self.samples = []
        for _ in range(n):
            pos = serve_molecule(rng, len(ASPIRIN_Z))
            self.samples.append(dict(
                z=aspirin_z(rng, len(ASPIRIN_Z)).astype(np.int64),
                pos=pos.astype(np.float32), y=rng.randn(1, 1),
                neg_dy=rng.randn(len(pos), 3).astype(np.float32)))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return dict(self.samples[int(idx)])


def phase_et_train():
    """The ET-MD17 recipe (ET 6 x 128, 32 rbf, 5 Å, K = 32,
    ``standardize``, y weight 0.2, neg_dy weight 0.8, the y EMA 0.05,
    AdamW at 1e-3 after its 1,000-step linear warm-up, so at 1e-6 to
    1.2e-5 in these steps) trained on the card on batches of 8 seeded
    aspirin-shaped molecules with random targets: one step's loss and
    weight gradients against the same weights in float64 on the card,
    two warm-up and ``ET_TRAIN_STEPS`` timed ``make_train_step`` steps
    (ms, mol/s, peak, the loss must fall), a profiled step (device ms,
    idle share); then ``Trainer.fit`` for one epoch (64 train and 16 val
    molecules) and its checkpoint through ``load_model`` into a served
    evaluation equal to the trained module's (1e-5).  Returns the served
    potential (phase ``et_md`` runs it)."""
    from torchmdnet_tpu_torch.data.datamodule import DataModule
    from torchmdnet_tpu_torch.models.model import create_model, load_model
    from torchmdnet_tpu_torch.train.trainer import Trainer

    args = ET_MD17_ARGS
    n_mols, lr = args["batch_size"], args["lr"]
    step_kw = {k: args[k] for k in ("y_weight", "neg_dy_weight",
                                    "ema_alpha_y", "ema_alpha_neg_dy",
                                    "lr_warmup_steps")}
    log_dir = OUT_DIR / "et_train"
    log_dir.mkdir(parents=True, exist_ok=True)
    hp = dict(args, num_epochs=1, save_interval=1,
              train_size=64, val_size=16, test_size=0, log_dir=str(log_dir),
              train_loss="mse_loss", splits=None, num_workers=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # standardize
        dm = DataModule(hp, dataset=AspirinMolecules(80, 71))
        dm.setup("fit")
    stats = dict(mean=dm.mean, std=dm.std)
    pot = create_model(hp, device="cuda", seed=14, **stats)
    p64 = create_model(dict(hp, precision=64), device="cuda", seed=14,
                       **stats)
    p64.module.load_state_dict(pot.module.state_dict())
    b = molecule_batch(n_mols, 61, (21, 22), aspirin_z, args["cutoff_upper"])
    check(b[4] <= args["max_num_neighbors"],
          f"et_train: {b[4]} neighbors overflow K")
    rng = np.random.RandomState(62)
    batch = dict(z=b[0], pos=b[1], batch=b[2],
                 y=rng.randn(n_mols, 1).astype(np.float32),
                 neg_dy=rng.randn(len(b[0]), 3).astype(np.float32),
                 mol_mask=np.ones(n_mols, bool))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    row = {"phase": "et_train", "mols": n_mols, "atoms": len(b[0]),
           "lr": lr, **step_kw, "mean": dm.mean, "std": dm.std,
           "steps_timed": ET_TRAIN_STEPS,
           "tolerance_vs_float64": [F64_TOL, F64_GRAD_TOL],
           "vs_float64": grads_against(pot, p64, batch, num_mols=n_mols,
                                       y_weight=args["y_weight"],
                                       neg_dy_weight=args["neg_dy_weight"])}
    del p64
    torch.cuda.empty_cache()
    t, _, state, step = train_timed(pot, batch, n_mols, lr, ET_TRAIN_STEPS,
                                    **step_kw)
    row.update(t)
    prof = phase_profile("et_train", lambda: step(state, batch))
    row["device_ms"], row["idle_share"] = prof["device_ms"], prof["idle_share"]
    del state, step, pot
    torch.cuda.empty_cache()

    tpot = create_model(hp, device="cuda", seed=15, **stats)
    trainer = Trainer(tpot, hp, dm)
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    row["fit_s"] = time.perf_counter() - t0
    ckpts = sorted(n for n in os.listdir(log_dir)
                   if n.startswith("epoch=") and n.endswith(".ckpt"))
    check(len(ckpts) == 1, f"et_train: checkpoints {ckpts}")
    served = load_model(log_dir / ckpts[0], device="cuda")
    tpot.module.requires_grad_(False)
    inputs = card_inputs(molecule_batch(args["inference_batch_size"], 81,
                                        (21, 22), aspirin_z,
                                        args["cutoff_upper"]))
    n = args["inference_batch_size"]
    y_s, f_s = served.apply(*inputs, num_mols=n)
    y_t, f_t = tpot.apply(*inputs, num_mols=n)
    row.update(checkpoint=ckpts[0],
               served_mean_std=[served.module.mean, served.module.std],
               served_vs_trained=[rel_err(y_s, y_t)[1], rel_err(f_s, f_t)[1]])
    emit(row)
    for name in os.listdir(log_dir):
        if name.endswith(".ckpt") or name.endswith(".native"):
            os.remove(log_dir / name)
    v64 = row["vs_float64"]
    check(v64["loss_rel_err"] <= F64_TOL and v64["grad_rel_err"]
          <= F64_GRAD_TOL, f"et_train: float32 vs float64 loss "
          f"{v64['loss_rel_err']:.3g}, gradient {v64['grad_rel_err']:.3g} "
          f"({v64['worst_param']})")
    check(math.isfinite(row["loss_first"]) and math.isfinite(row["loss_last"])
          and row["loss_last"] < row["loss_first"],
          f"et_train: the loss did not fall ({row['loss_first']:.4g} → "
          f"{row['loss_last']:.4g})")
    # the file keeps them as float32 scalars
    check(all(math.isclose(a, b, rel_tol=1e-6) for a, b in zip(
        row["served_mean_std"], (dm.mean, dm.std))),
          "et_train: the checkpoint lost the mean and std")
    check(max(row["served_vs_trained"]) <= ACEFF_RELOAD_TOL,
          f"et_train: the served checkpoint differs from the trained "
          f"module {row['served_vs_trained']}")
    return served


def phase_et_md(pot):
    """``run_md`` with the ET-MD17 model (``phase_et_train``'s served
    checkpoint) on one seeded aspirin-shaped molecule: Langevin at 300 K,
    0.5 fs, lists rebuilt every 25 steps with a 1 Å skin; a 25-step
    warm-up run, then ``ET_MD_STEPS`` timed steps: ms per step, K
    overflow, the final kinetic temperature and energy."""
    from torchmdnet_tpu_torch.md.integrators import (
        KB_EV, kinetic_energy, run_md)
    from torchmdnet_tpu_torch.utils.periodic_table import ATOMIC_MASSES

    z, pos, _, _, _ = molecule_batch(1, 83, (21, 22), aspirin_z,
                                     ET_MD17_ARGS["cutoff_upper"])
    masses = ATOMIC_MASSES[z]
    kw = dict(dt=0.5, temperature=300.0, rebuild_every=25, skin=1.0)
    run_md(pot, z, pos, masses, n_steps=25, seed=1, **kw)
    t0 = time.perf_counter()
    st = run_md(pot, z, pos, masses, n_steps=ET_MD_STEPS, seed=2, **kw)
    ms = (time.perf_counter() - t0) * 1e3 / ET_MD_STEPS
    m = torch.as_tensor(masses, dtype=torch.float32, device="cuda")
    temp_k = float(2.0 * kinetic_energy(st.vel, m) / (3 * len(z) * KB_EV))
    ok = (not bool(st.overflow) and bool(torch.isfinite(st.pos).all())
          and bool(torch.isfinite(st.energy).all()))
    emit({"phase": "et_md", "atoms": len(z), "steps": st.step,
          "rebuild_every": kw["rebuild_every"], "dt_fs": kw["dt"],
          "ms_per_step": ms, "overflow": bool(st.overflow),
          "kinetic_temperature_k": temp_k,
          "energy_final": float(st.energy.sum()), "finite": ok})
    check(st.step == ET_MD_STEPS and ok,
          "et_md: overflow or non-finite state")


def phase_t_gn():
    """TorchMD-T and TorchMD-GN at upstream's defaults (``T_GN_ARGS``: 6
    x 128, 50 rbf, 5 Å, K = 32, 8 heads; GN with 128 filters and
    ``aggr="add"``), seeded weights: one energy+forces evaluation each on
    16 QM9-sized molecules (10-29 atoms, so that K = 32 holds; the
    SPICE-like batch reaches 56 neighbors at 5 Å), against the same
    weights in float64, ms per evaluation and peak memory."""
    from torchmdnet_tpu_torch.models.model import create_model

    n = 16
    b = molecule_batch(n, 95, (10, 30), qm9_z, T_GN_ARGS["cutoff_upper"])
    check(b[4] <= T_GN_ARGS["max_num_neighbors"],
          f"t_gn: {b[4]} neighbors overflow K")
    inputs = card_inputs(b)
    row = {"phase": "t_gn", "mols": n, "atoms": len(b[0]),
           "max_neighbors": b[4], "tolerance_vs_float64": F64_TOL}
    for model in ("transformer", "graph-network"):
        pot = create_model(dict(T_GN_ARGS, model=model), device="cuda",
                           seed=16)
        y, f = pot.apply(*inputs, num_mols=n)
        _, r = timed_evaluation(pot, inputs, n)
        r.update(vs_float64=against_float64(pot, inputs, n),
                 energy_sum=float(y.sum()),
                 finite=bool(torch.isfinite(y).all()
                             and torch.isfinite(f).all()))
        row[model] = r
        del pot
        torch.cuda.empty_cache()
    emit(row)
    for model in ("transformer", "graph-network"):
        r = row[model]
        check(r["finite"] and max(r["vs_float64"]) <= F64_TOL,
              f"t_gn {model}: non-finite, or float32 vs float64 "
              f"{r['vs_float64']}")


# TensorNet on revised-MD17 aspirin (a copy of examples/TensorNet-rMD17.yaml:
# the card's machine may have no yaml; tests/test_torch_recipe_args.py
# holds the copy against the file)
TENSORNET_RMD17_ARGS = dict(
    activation="silu", atom_filter=-1, batch_size=8, charge=False,
    cutoff_lower=0.0, cutoff_upper=4.5, dataset="MD17",
    dataset_arg={"molecules": "revised_aspirin"}, dataset_root="~/data",
    derivative=True, early_stopping_patience=300, ema_alpha_neg_dy=1.0,
    ema_alpha_y=0.01, embedding_dimension=128,
    equivariance_invariance_group="O(3)", gradient_clipping=40.0,
    inference_batch_size=64, log_dir="logs/", lr=0.001, lr_factor=0.8,
    lr_min=1e-08, lr_patience=25, lr_warmup_steps=500, max_num_neighbors=32,
    max_z=100, model="tensornet", neg_dy_weight=0.5, ngpus=1,
    num_epochs=10000, num_layers=2, num_nodes=1, num_rbf=32, num_workers=4,
    output_model="Scalar", precision=32, rbf_type="expnorm", redirect=False,
    reduce_op="add", save_interval=10, seed=1, spin=False, standardize=True,
    test_interval=30, test_size=None, train_size=950, trainable_rbf=False,
    val_size=50, weight_decay=0.0, y_weight=0.5)
# the phase data_cli: rMD17 aspirin's frame count, the recipe's run cut to
# one epoch (and one more on restart) and a test split of 1,000 frames
# (the recipe tests on the other 99,000), through kernels 1, 2 and 4; the
# loaders timed over one epoch each after DATA_CLI_WARMUP steps
RMD17_FRAMES = 100_000
DATA_CLI_CUTS = dict(num_epochs=1, test_size=1000, pallas_embedding=True,
                     pallas_edge_mlp=True)
DATA_CLI_WARMUP = 8
DATA_CLI_KERNELS = ("radial_embedding_fwd", "radial_embedding_bwd",
                    "edge_mlp")
# the widths the kernels used to refuse (Queue 3 item 1): kernels 1-4 at F
# = 30, R = 50 (run padded to 32 and 52), held at their rows' bars, and
# the path odd_widths: TensorNet-rMD17 and the AceFF TensorNet2 at these
# widths, one train step's loss and gradients each (ODD_ACE_MOLS molecules
# for the AceFF model)
ODD_F, ODD_R, ODD_N, ODD_K = 30, 50, 4096, 32
ODD_ACE_MOLS = 4


def write_rmd17(root, frames, seed):
    """``root/raw/rmd17/npz_data/rmd17_aspirin.npz`` in the revised-MD17
    keys: ``frames`` seeded aspirin conformers (C9H8O4, a
    ``serve_molecule`` geometry jittered by 0.03 Å a frame) with random
    energies (kcal/mol around −406,000, as the file's) and forces."""
    rng = np.random.RandomState(seed)
    base = serve_molecule(rng, len(ASPIRIN_Z))
    d = Path(root) / "raw" / "rmd17" / "npz_data"
    d.mkdir(parents=True, exist_ok=True)
    path = d / "rmd17_aspirin.npz"
    np.savez(path, nuclear_charges=np.array(ASPIRIN_Z),
             coords=base + 0.03 * rng.randn(frames, len(ASPIRIN_Z), 3),
             energies=-406_000.0 + 10.0 * rng.randn(frames),
             forces=20.0 * rng.randn(frames, len(ASPIRIN_Z), 3))
    return path


class InMemory:
    """Samples held in a list: the in-memory ``Dataset`` the loader packs
    through ``pad_samples``."""

    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return self.samples[int(idx)]


def host_pack_ms(loader):
    """Host ms to pack one batch: a whole epoch of ``loader``, no
    device."""
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return (time.perf_counter() - t0) * 1e3 / n


def timed_epoch(trainer, loader, steps=None):
    """One epoch (or its first ``steps`` batches) of ``trainer``'s train
    step fed by ``loader`` as ``Trainer.fit`` feeds it (the batches packed
    and copied in a prefetch thread): ``(ms a step, steps)``."""
    import itertools

    from torchmdnet_tpu_torch.train.trainer import prefetch_to_device

    batches = prefetch_to_device(
        (trainer._to_device_batch(b)
         for b in itertools.islice(loader, steps)), size=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    for batch in batches:
        trainer.state, _ = trainer._train_step(trainer.state, batch)
        steps += 1
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps, steps


def odd_width_rows(peak):
    """Kernels 1, 2 (its dz and dk forms), 3 and 4 at ``F = ODD_F``, ``R =
    ODD_R`` on ``ODD_N`` rows of ``ODD_K`` slots against their plain
    versions: max error per output (held to their rows' bars), ms, plain
    ms and the bound of the unpadded work."""
    from torchmdnet_tpu_torch.ops import edge_mlp as em
    from torchmdnet_tpu_torch.ops import radial_embedding as re_ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    n, k, r, f = ODD_N, ODD_K, ODD_R, ODD_F

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    count = torch.randint(8, k + 1, (n, 1), generator=gen, device=dev)
    mask = (torch.arange(k, device=dev)[None, :] < count).float()
    v = randn(n, k, 3)
    v = v / v.norm(dim=-1, keepdim=True)
    x = [torch.rand((n, k, r), generator=gen, device=dev),
         torch.rand((n, k), generator=gen, device=dev) * mask,
         v[..., 0].contiguous(), v[..., 1].contiguous(),
         v[..., 2].contiguous(), randn(n, f), randn(n, k, f) * mask[..., None],
         mask, randn(r, 3 * f, scale=1 / math.sqrt(r)), randn(3 * f, scale=0.1)]
    g = randn(n, 9 * f)
    valid = float(mask.sum())
    form = f"F = {f}, R = {r} (run padded to F = 32, R = 52)"
    rows = {}

    def row(name, kern, plain, flops, nb, tc, library=False):
        got, want = as_list(kern()), as_list(plain())
        torch.cuda.synchronize()
        check(all(torch.isfinite(t).all() for t in got if t is not None),
              f"{name}: non-finite")
        errs = [rel_err(a, b) for a, b in zip(got, want) if b is not None]
        b_ms, b_by = bound(flops, nb, peak, tc)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        rows[name] = dict(
            form=form, max_abs_err=max(e[0] for e in errs),
            max_rel_err=max(e[1] for e in errs), ms=time_ms(kern),
            device_ms=device_ms(kern), plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=plain_ms if library else None,
            gflop=flops / 1e9, gbytes=nb / 1e9)

    out = re_ops.radial_embedding_fwd_cuda(*x)
    tc = valid * 2 * r * 3 * f
    row("radial_embedding_fwd@F30R50",
        lambda: re_ops.radial_embedding_fwd_cuda(*x),
        lambda: re_ops.radial_embedding_ref(*x), tc + valid * 23 * f,
        emb_bytes(x, valid, out), tc)
    for name, dz, dk in (("radial_embedding_bwd_dz@F30R50", True, False),
                         ("radial_embedding_bwd_dkall@F30R50", True, True)):
        needs = emb_needs(dz, dk)
        outs = [t for t in re_ops.radial_embedding_bwd_cuda(x, g, dz, dk)
                if t is not None]
        tc = valid * 2 * (2 * r * 3 * f + ((r + 1) * 3 * f if dk else 0))
        row(name, lambda: re_ops.radial_embedding_bwd_cuda(x, g, dz, dk),
            lambda: re_ops.radial_embedding_bwd_ref(x, g, needs),
            tc + valid * 50 * f, emb_bytes(x, valid, g, *outs), tc)
    cw = x[1]
    live = float((cw != 0).sum())
    w = edge_pre_inputs(cw, 4322, f=f)
    flops = live * 2 * (f * 2 * f + 2 * f * 3 * f)
    nb = live * f * 4 + nbytes(*w[1:]) + n * k * 3 * f * 4
    row("edge_mlp_pre@F30R50", lambda: em.edge_mlp_pre_cuda(*w),
        lambda: em.edge_mlp_pre_ref(*w), flops, nb, flops, library=True)
    w4 = [x[0], cw, randn(r, f, scale=1 / math.sqrt(r)), randn(f, scale=0.1),
          *w[2:]]
    flops = live * 2 * (r * f + f * 2 * f + 2 * f * 3 * f)
    nb = live * r * 4 + nbytes(*w4[1:]) + n * k * 3 * f * 4
    row("edge_mlp@F30R50", lambda: em.edge_mlp_cuda(*w4),
        lambda: em.edge_mlp_ref(*w4), flops, nb, flops, library=True)
    for name, r_ in rows.items():
        check(r_["max_rel_err"] <= limit(name),
              f"{name}: {r_['max_rel_err']:.3g} of max |plain| > "
              f"{limit(name)}")
    emit({"phase": "odd_widths", "n": n, "k": k, "rows": rows})
    return rows


def odd_width_path(batch, mean, std):
    """The path ``odd_widths``: the widths the kernels used to refuse,
    through the models.  TensorNet-rMD17 at ``F = ODD_F``, ``R = ODD_R``
    with both flags (kernels 1, 2 and 4) on ``batch``, the data_cli batch
    of aspirin (standardized by the train split's ``mean``, ``std``), and
    the AceFF TensorNet2 at the same widths (kernels 1, 2
    and 3) on ``ODD_ACE_MOLS`` seeded molecules with charges: one train
    step's loss and every weight gradient each, counted (the counts set to
    0 just before and read just after).  Then each against the same weights
    with both flags off (the plain chains), held to ``TOL``.  Returns
    ``(row, launches)``."""
    from torchmdnet_tpu_torch.models.model import create_model

    dev = torch.device("cuda")
    odd = dict(embedding_dimension=ODD_F, num_rbf=ODD_R)
    runs = {"tensornet_rmd17": (
                dict(TENSORNET_RMD17_ARGS, **odd, **DATA_CLI_CUTS), batch,
                dict(num_mols=TENSORNET_RMD17_ARGS["batch_size"],
                     y_weight=TENSORNET_RMD17_ARGS["y_weight"],
                     neg_dy_weight=TENSORNET_RMD17_ARGS["neg_dy_weight"])),
            "tensornet2_aceff": (
                dict(ACEFF_ARGS, **odd, **SERVE_KWARGS),
                aceff_train_batch(ODD_ACE_MOLS, seed=63),
                dict(num_mols=ODD_ACE_MOLS,
                     neg_dy_weight=ACEFF_ARGS["neg_dy_weight"]))}
    stats = {"tensornet_rmd17": dict(mean=mean, std=std)}
    pots = {}
    for name, (args, _, _) in runs.items():
        pots[name] = create_model(args, device=dev, seed=8,
                                  **stats.get(name, {}))
        pots[name].module.requires_grad_(True)
    _, launches = counted_run(lambda: {
        name: loss_and_grads(pots[name], b, **kw)[0]
        for name, (_, b, kw) in runs.items()})
    row = {"phase": "odd_widths", "f": ODD_F, "r": ODD_R, "tolerance": TOL,
           "launches": {k: v for k, v in launches.items() if v}}
    for name, (args, b, kw) in runs.items():
        plain = create_model(dict(args, pallas_embedding=False,
                                  pallas_edge_mlp=False), device=dev, seed=8,
                             **stats.get(name, {}))
        plain.module.load_state_dict(pots[name].module.state_dict())
        row[name] = grads_against(pots[name], plain, b, **kw)
        del plain
    del pots
    torch.cuda.empty_cache()
    for k in DATA_CLI_KERNELS + ("edge_mlp_pre",):
        check(launches[k] > 0, f"odd_widths: kernel {k} was not launched")
    for name in runs:
        r = row[name]
        check(r["loss_rel_err"] <= TOL and r["grad_rel_err"] <= TOL,
              f"odd_widths {name}: kernels vs plain loss "
              f"{r['loss_rel_err']:.3g}, gradient {r['grad_rel_err']:.3g} "
              f"({r['worst_param']})")
    return row, launches


def phase_data_cli(smi, peak):
    """``examples/TensorNet-rMD17.yaml`` (TensorNet 2 x 128, 32 expnorm
    rbf, 4.5 Å, K = 32, batches of 8, ``standardize``, weights 0.5 / 0.5,
    AdamW at 1e-3 after a 500-step warm-up) trained on the card through the
    CLI, ``train.main(argv)``, from an rMD17-format file of
    ``RMD17_FRAMES`` seeded aspirin frames (random targets): the file
    processed by ``MD17(root, "revised_aspirin")`` into memory-mapped
    files (timed), the recipe run with ``DATA_CLI_CUTS`` (kernels 1, 2 and
    4 in the force pass; each must launch), its files and finite losses
    checked, its model's mean and std those of the train split; a restart
    from the last checkpoint for one more epoch continues the step and the
    optimizer.  The checkpoint's loss and weight gradients on a batch of
    the memory-mapped loader against the plain chains (``TOL``).  Then ms
    a train step and mol/s fed by the memory-mapped loader (native packer)
    and by an in-memory dataset of the same frames (``pad_samples``), one
    epoch each after a few warm-up steps, the host ms to pack a batch both
    ways, and peak memory.  The recipe's flags go in as ``to_argv`` gives
    them (no YAML file).  Then the path ``odd_widths``
    (:func:`odd_width_path`) and the odd-width kernel rows.  Returns
    ``(launches of the odd_widths path, the odd-width kernel rows)``."""
    import shutil
    import tempfile

    # the 100,000 frames' files (~70 MB) and the checkpoints live in a
    # temporary directory, removed whatever happens
    tmp = Path(tempfile.mkdtemp(prefix="data_cli_"))
    try:
        row, batch = data_cli_run(tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(row)
    check(row["vs_plain"]["loss_rel_err"] <= TOL
          and row["vs_plain"]["grad_rel_err"] <= TOL,
          f"data_cli: kernels vs plain {row['vs_plain']}")
    path_row, launches = odd_width_path(batch, *row["mean_std"])
    emit(path_row)
    return launches, odd_width_rows(peak)


def data_cli_run(tmp, smi):
    """``phase_data_cli``'s runs in the directory ``tmp``: its row."""
    import csv

    from torchmdnet_tpu_torch.data.collate import PaddedLoader
    from torchmdnet_tpu_torch.data.datamodule import DataModule
    from torchmdnet_tpu_torch.datasets import MD17
    from torchmdnet_tpu_torch.models.model import load_model
    from torchmdnet_tpu_torch.train import train as cli
    from torchmdnet_tpu_torch.train.trainer import Trainer
    from torchmdnet_tpu_torch.utils.config import to_argv

    mols = TENSORNET_RMD17_ARGS["batch_size"]
    raw = write_rmd17(tmp / "data", RMD17_FRAMES, 91)
    t0 = time.perf_counter()
    ds = MD17(str(tmp / "data"), "revised_aspirin")
    process_s = time.perf_counter() - t0
    check(len(ds) == RMD17_FRAMES, f"data_cli: {len(ds)} frames")
    hp = dict(TENSORNET_RMD17_ARGS, dataset_root=str(tmp / "data"),
              log_dir=str(tmp / "logs"), **DATA_CLI_CUTS)
    row = {"phase": "data_cli", "nvidia_smi": smi, "frames": len(ds),
           "reduced": {"num_epochs": [TENSORNET_RMD17_ARGS["num_epochs"], 1],
                       "test_size": ["the rest (99,000)", 1000],
                       "restart_epochs": 1,
                       "timed": f"one epoch a loader after "
                                f"{DATA_CLI_WARMUP} warm-up steps"},
           "process_s": process_s,
           "processed_mb": sum(p.stat().st_size for p in
                               (tmp / "data" / "processed").iterdir()) / 1e6}
    del ds
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # standardize
        t0 = time.perf_counter()
        results, launches = counted_run(lambda: cli.main(to_argv(hp)))
        row["cli_s"] = time.perf_counter() - t0
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    row["launches"] = {k: v for k, v in launches.items() if v}
    for k in DATA_CLI_KERNELS:
        check(launches[k] > 0, f"data_cli: kernel {k} was not launched")
    logs = tmp / "logs"
    names = sorted(os.listdir(logs))
    for f in ("splits.npz", "metrics.csv", "input.yaml", "best.ckpt",
              "best.ckpt.native"):
        check(f in names, f"data_cli: no {f}")
    last = [n for n in names if n.startswith("epoch=0")
            and n.endswith(".ckpt")]
    check(len(last) == 1, f"data_cli: checkpoints {names}")
    with open(logs / "metrics.csv") as fh:
        metrics = list(csv.DictReader(fh))
    losses = [float(m[k]) for m in metrics for k in m
              if k.endswith("_loss") and m[k] not in ("", None)]
    row.update(results=results,
               epochs=[{k: float(v) for k, v in m.items() if v}
                       for m in metrics],
               losses_finite=bool(losses) and all(map(math.isfinite,
                                                      losses)))
    check(row["losses_finite"] and all(map(math.isfinite, results.values())),
          "data_cli: a loss is not finite")
    # mean and std of the train split's energies, as the model carries them
    npz = np.load(raw)
    train_idx = np.load(logs / "splits.npz")["idx_train"]
    check(len(train_idx) == 950, f"data_cli: {len(train_idx)} train frames")
    y = npz["energies"][train_idx]
    served = load_model(logs / last[0], device="cuda")
    row["mean_std"] = [served.module.mean, served.module.std]
    row["train_split_mean_std"] = [float(y.mean()), float(y.std(ddof=1))]
    check(all(math.isclose(a, b, rel_tol=1e-6) for a, b in zip(
        row["mean_std"], row["train_split_mean_std"])),
          f"data_cli: the model's mean/std {row['mean_std']} are not the "
          f"train split's {row['train_split_mean_std']}")

    # the restart: one more epoch from the last checkpoint
    before = torch.load(logs / (last[0] + ".native"), weights_only=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        resumed, relaunch = counted_run(lambda: cli.main(
            ["--load-model", str(logs / last[0])] + to_argv(dict(
                hp, log_dir=str(tmp / "logs2"), num_epochs=1))))
    after_name = [n for n in os.listdir(tmp / "logs2")
                  if n.startswith("epoch=0") and n.endswith(".native")]
    check(len(after_name) == 1, f"data_cli: restart wrote {after_name}")
    after = torch.load(tmp / "logs2" / after_name[0], weights_only=True)
    steps = math.ceil(950 / TENSORNET_RMD17_ARGS["batch_size"])
    row["restart"] = dict(
        step_before=before["step"], step_after=after["step"],
        adam_step_before=float(before["optimizer"]["state"][0]["step"]),
        adam_step_after=float(after["optimizer"]["state"][0]["step"]),
        results=resumed, launches={k: v for k, v in relaunch.items() if v})
    check(before["step"] == steps and after["step"] == 2 * steps
          and row["restart"]["adam_step_after"]
          == row["restart"]["adam_step_before"] + steps,
          f"data_cli: the restart did not continue the step "
          f"{row['restart']}")

    # the loaders: memory-mapped (native packer) against in memory
    dm = DataModule(dict(hp, log_dir=None))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        dm.setup("fit")
    mm_loader = dm.train_dataloader()
    check(mm_loader._memmap_base()[0] is not None,
          "data_cli: the loader does not take the memory-mapped path")
    mem = InMemory([dm.dataset[int(i)] for i in dm.idx_train])
    mem_loader = PaddedLoader(mem, mm_loader.batch_size, shuffle=True,
                              seed=mm_loader.seed,
                              max_atoms=mm_loader.max_atoms)
    row["host_pack_ms"] = {"memmap_native": host_pack_ms(mm_loader),
                           "in_memory_pad_samples": host_pack_ms(mem_loader)}
    trainer = Trainer(served, dict(hp, log_dir=str(tmp / "timing")), dm)
    trainer._init_state()

    # the served model's loss (weights 0.5 / 0.5) and every weight gradient
    # on a batch of the memory-mapped loader, against the same weights with
    # both flags off (the plain chains)
    batch = trainer._to_device_batch(next(iter(mm_loader)))
    plain = load_model(logs / last[0], device="cuda", pallas_embedding=False,
                       pallas_edge_mlp=False)
    before = launch_counts()
    row["vs_plain"] = dict(tolerance=TOL, **grads_against(
        served, plain, batch, num_mols=mols,
        y_weight=TENSORNET_RMD17_ARGS["y_weight"],
        neg_dy_weight=TENSORNET_RMD17_ARGS["neg_dy_weight"]))
    check_launched(DATA_CLI_KERNELS, before)
    del plain

    timed_epoch(trainer, mm_loader, DATA_CLI_WARMUP)  # warm-up
    times = {name: timed_epoch(trainer, loader)[0] for name, loader in (
        ("memmap_native", mm_loader), ("in_memory_pad_samples", mem_loader))}
    row["ms_per_step"] = times
    row["mol_per_s"] = {k: mols / (v / 1e3) for k, v in times.items()}
    row["peak_gb_all"] = torch.cuda.max_memory_allocated() / 1e9
    return row, batch


def zip_checkpoints(out, paths):
    """``out/aceff.zip`` holding the checkpoints ``paths``."""
    import zipfile

    path = out / "aceff.zip"
    with zipfile.ZipFile(path, "w") as zf:
        for p in paths:
            zf.write(p, os.path.basename(p))
    return path


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from torchmdnet_tpu_torch.models.model import create_model
    from torchmdnet_tpu_torch.ops.cell_blocks import tune_stencil_window_spec
    from torchmdnet_tpu_torch.ops.config import set_matmul_precision

    set_matmul_precision("highest")
    smi, kind, peak = phase_device()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 must be off")
    system = northstar_system()
    dhfr, seg = dhfr_system()
    specs = {"grouped": dhfr_blocked_spec(dhfr, True),
             "ungrouped": dhfr_blocked_spec(dhfr, False)}
    q_specs = {"ungrouped": northstar_spec(system),
               "grouped": northstar_spec(system, grouped=True)}
    wspec = tune_stencil_window_spec(None, [system[4]] * 3,
                                     q_specs["ungrouped"], COULOMB_RC + SKIN)
    phase_tc_attributes(specs, q_specs, wspec)
    rows = phase_kernels(peak, system, dhfr, seg, specs)
    phase_shapes()
    phase_small()

    gather_pot, gather_out, gather_run = phase_energy(system)
    phase_profile("gather", gather_run)
    g_steps, g_launch = phase_md_gather(gather_pot, system)

    spec = q_specs["ungrouped"]
    pot, blocked_run, blocked_out = phase_blocked_energy(
        system, spec, gather_pot, gather_out)
    del gather_pot, gather_out, gather_run
    torch.cuda.empty_cache()
    phase_profile("blocked", blocked_run)
    b_steps, b_launch = phase_md_blocked(pot, system, spec)
    sd = pot.module.state_dict()
    del pot, blocked_run
    torch.cuda.empty_cache()
    q_paths = run_q_tiers(system, spec, sd, blocked_out)
    del sd, blocked_out
    torch.cuda.empty_cache()

    gather = phase_dhfr(dhfr, seg)
    pots, evaluate, dpos, _ = gather
    phase_profile("dhfr", lambda: evaluate(pots["tabulated"], dpos))
    phase_profile("dhfr_exact", lambda: evaluate(pots["exact"], dpos))
    blocked = phase_dhfr_blocked(dhfr, seg, specs, gather)
    pot_b, ev_b = blocked["tabulated_grouped"]
    phase_profile("dhfr_blocked", lambda: ev_b(pot_b, dpos))
    pot_x, ev_x = blocked["exact_grouped"]
    phase_profile("dhfr_blocked_exact", lambda: ev_x(pot_x, dpos))
    del blocked, pot_b, ev_b, pot_x, ev_x, gather
    torch.cuda.empty_cache()
    phase_priors(dhfr, seg, pots, evaluate, dpos)
    torch.cuda.empty_cache()
    by_path = {"gather": (g_steps, g_launch), "blocked": (b_steps, b_launch),
               **q_paths}
    for variant, path in (("tabulated", "dhfr"), ("exact", "dhfr_exact")):
        by_path[path] = phase_md_dhfr(pots[variant], dhfr, seg, path)
    spec_md = dhfr_blocked_spec(dhfr, True, 4.5 + SKIN)
    for variant, path in (("tabulated", "dhfr_blocked"),
                          ("exact", "dhfr_blocked_exact")):
        extra = DHFR_EXACT if variant == "exact" else {}
        pot = create_model(dhfr_args(cell_block_spec=spec_md, **extra),
                           device="cuda", seed=0)
        pot.module.load_state_dict(pots[variant].module.state_dict())
        by_path[path] = phase_md_dhfr_blocked(pot, dhfr, seg, spec_md, path)
        del pot
        torch.cuda.empty_cache()
    phase_md_adaptive(pots, dhfr, seg, spec_md)
    torch.cuda.empty_cache()
    by_path["train"] = phase_train()
    phase_trainer()
    phase_serve()
    torch.cuda.empty_cache()
    phase_train_aceff()
    torch.cuda.empty_cache()
    phase_et_serve()
    phase_et_md(phase_et_train())
    torch.cuda.empty_cache()
    phase_t_gn()
    torch.cuda.empty_cache()
    adapter_paths = phase_adapters()
    torch.cuda.empty_cache()
    phase_data_parallel()
    torch.cuda.empty_cache()
    odd_launches, odd_rows = phase_data_cli(smi, peak)
    launches = {k: by_path[path][1][k] for k, (_, _, path) in KERNELS.items()}
    emit({"phase": "launches", "md_steps": {p: s for p, (s, _) in
                                            by_path.items()},
          "launches": {p: ln for p, (_, ln) in by_path.items()},
          # per MD step; for blocked_exact_grouped per evaluation
          "per_step": {k: launches[k] / by_path[KERNELS[k][2]][0]
                       for k in KERNELS},
          # rows 5-7 per train step (the force pass and the parameter
          # gradient run them through their backwards)
          "train_per_step": {k: by_path["train"][1][k] / by_path["train"][0]
                             for k in ("cheb_filter", "cheb_filter_dot",
                                       "cheb_project")}})
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on its path's run")
    for k in ("cheb_filter", "cheb_filter_dot", "cheb_project"):
        check(by_path["train"][1][k] > 0,
              f"kernel {k} was not launched in the train steps")
    check(g_launch["edge_mlp_pre"] > 0 and b_launch["edge_mlp_pre"] == 0,
          "kernel 3 runs on the gather path only")
    # each q-tier runs its own base's kernels and not the other's
    for path, (_, ln) in by_path.items():
        if path.startswith("blocked"):
            tab = ln["blocked_q_fwd"] + ln["blocked_q_dq"]
            exact = ln["blocked_q_fwd_rbf"] + ln["blocked_q_dq_rbf"]
            check((tab > 0) != (exact > 0)
                  and (exact > 0) == path.startswith("blocked_exact"),
                  f"{path}: tabulated {tab} and exact {exact} q launches")

    kernels = []
    for k, (src, tpu, path) in KERNELS.items():
        row = rows[k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": tpu,
            "path": path, "launches": launches[k],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **({"form": row["form"]} if "form" in row else {}),
            # the adapters' paths: a CUDA graph's counts are a capture's
            # (each replay launches them again); the exported program's
            # are one call's
            **{path: counts[k] for path, counts in adapter_paths.items()
               if k in counts}})
    # the odd-width forms: launches of the kernel at F = 30, R = 50 on the
    # path odd_widths (kernel 2's dz and dk forms share one count)
    for name, row in odd_rows.items():
        kern = name.split("@")[0].replace("_dkall", "").replace("_dz", "")
        kernels.append({
            "name": name, "route": "cuda", "source": KERNELS[kern][0],
            "replaces": KERNELS[kern][1], "path": "odd_widths",
            "launches": odd_launches[kern],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "form": row["form"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # report the failed phase; never exit 0 after it
        traceback.print_exc()
        code = 1
    sys.exit(code)
