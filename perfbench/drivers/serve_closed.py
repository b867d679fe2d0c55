"""Batched serving in a closed loop with one client: each batch of
molecules goes to the program's ``Potential.apply`` (energies and
forces), and the next is sent when its forces are back on the host's
side of a device sync.

Set-up makes a pool of ``pool`` distinct batches from the seed, uploads
them, builds the potential and runs every batch of the pool once, so
that every shape the window sends has been seen.  The window cycles
through the pool until ``seconds`` have passed: ``serve_mol_per_s`` is
the molecules returned over the window's time, ``serve_batch_p95_ms``
the 95th percentile of the batches' times, each from the call (inputs
already on the card) to its forces synced.  A batch with a non-finite
energy or force counts in ``failed``.

The check, once the window has closed and the program is freed: the last
answer the window gave for each batch of the pool, against the
reference on the same inputs: ``force_err``, the widest force gap over
the batch's largest reference force, and ``energy_err``, the widest gap
of a molecule's energy over the sum of its reference ``|per-atom
energies|``, each the worst over the batches.
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


class Pool:
    """The traffic's batches, on the device, and the weights."""

    def __init__(self, cell, seed, device):
        t = cell.traffic
        self.cfg = cell.config["model"]
        rng = np.random.default_rng(seed)
        self.batches = []
        for _ in range(t["pool"]):
            z, pos, batch, q = systems.molecule_batch(
                rng, t["molecules"], t["atoms"], t["most_within"],
                t["elements"], t["element_p"], t["charges"], t["spacing"])
            self.batches.append(tuple(torch.as_tensor(a, device=device)
                                      for a in (z, pos, batch, q)))
        self.weights = ref.make_weights(self.cfg, seed, device)
        self.device = device


def build(pool):
    from torchmdnet_tpu_torch.models.model import create_model

    pot = create_model(pool.cfg, device=pool.device)
    pot.module.load_state_dict(pool.weights)
    return pot


def call(pot, inputs):
    z, pos, batch, q = inputs
    return pot.apply(z, pos, batch, num_mols=len(q), q=q)


def run(cell, seed, seconds, trace, t_start, device):
    t = cell.traffic
    out = Outcome()
    marks = [("start", time.perf_counter() - t_start)]
    pool = Pool(cell, seed, device)
    marks.append(("inputs and weights", time.perf_counter() - t_start))
    pot = build(pool)
    marks.append(("model", time.perf_counter() - t_start))
    for inputs in pool.batches:
        call(pot, inputs)
    sync(device)
    out.metrics["setup_s"] = time.perf_counter() - t_start
    marks.append(("warm-up", out.metrics["setup_s"]))
    print("set-up s: " + ", ".join(f"{k} {v:.2f}" for k, v in marks),
          file=sys.stderr)

    n = len(pool.batches)
    if trace:
        span_batches = [pool.batches[k % n] for k in range(t["trace_batches"])]

        def span():
            for inputs in span_batches:
                with torch.profiler.record_function("serve.batch"):
                    call(pot, inputs)
                sync(device)

        out.span = Span(capture(torch, span), pool.cfg, None, evaluations=1,
                        units=len(span_batches),
                        peak=device_peaks(device))

    sync(device)
    times, last = [], {}
    nonfinite = torch.zeros((), dtype=torch.long, device=device)
    k = 0
    t0 = time.perf_counter()
    while True:
        start = time.perf_counter()
        y, f = call(pot, pool.batches[k % n])
        sync(device)
        end = time.perf_counter()
        times.append(end - start)
        last[k % n] = (y, f)
        nonfinite += ~(torch.isfinite(y).all() & torch.isfinite(f).all())
        k += 1
        if end - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    out.attempted = k
    out.failed = int(nonfinite)
    out.metrics["serve_mol_per_s"] = k * t["molecules"] / elapsed
    out.metrics["serve_batch_p95_ms"] = 1e3 * float(
        np.percentile(times, 95))
    out.memory_peak = memory_peak(device)
    if trace:
        # the work the span's inputs asked for, counted once the
        # program's peak is read
        geoms = [geometry(pool.cfg, b[1], b[2]) for b in span_batches]
        out.span.geom = {k: sum(g[k] for g in geoms) for k in geoms[0]}

    del pot
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    out.checks = compare(cell, pool, last)
    sizes = [len(b[0]) for b in pool.batches]
    print(f"reference_s {time.perf_counter() - t_ref:.3f}; atoms a batch "
          f"{min(sizes)}-{max(sizes)}", file=sys.stderr)
    return out


def control(cell, seed, device):
    """The control's readings: the reference in TF32 in the program's
    place, on every batch of the seed's pool."""
    pool = Pool(cell, seed, device)
    answers = {}
    with ref.precision(True):
        for k, (z, pos, batch, q) in enumerate(pool.batches):
            answers[k] = ref.energy_forces(pool.weights, pool.cfg, z, pos,
                                           batch, q, len(q))[:2]
    return compare(cell, pool, answers)


def compare(cell, pool, answers):
    """``[(name, value, limit)]``: the worst over ``answers`` ({pool index:
    (energies, forces)}) of the gaps to the reference."""
    force_err = energy_err = 0.0
    with ref.precision(False):
        for k, (y, f) in sorted(answers.items()):
            z, pos, batch, q = pool.batches[k]
            e_ref, f_ref, scale = ref.energy_forces(
                pool.weights, pool.cfg, z, pos, batch, q, len(q))
            force_err = max(force_err, gap(f, f_ref))
            energy_err = max(energy_err, gap(y.flatten(), e_ref, scale))
    return [("force_err", force_err, cell.limits["force_err"]),
            ("energy_err", energy_err, cell.limits["energy_err"])]
