"""What every cell shares: the benchmark's files, the card, the peaks, the
import check and the result line.

A cell is found by its name in ``BENCHMARK.json``; its configuration,
traffic mix, limits, driver and per-layer readers are files named after
the entries there (see ``run.py``).
"""

import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# top-level module names that must not be loaded in a measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "torchmdnet_tpu")

# Published peaks, NVIDIA data sheets (dense, no sparsity): float32 outside
# the tensor cores in FLOP/s, device memory in B/s and TF32 on the tensor
# cores in FLOP/s, by board (``chip_smoke.py::PEAKS``, copied).
PEAKS = {"H100 PCIe": (51.2e12, 2.0e12, 378e12),
         "H100 NVL": (60.0e12, 3.9e12, 417.5e12),
         "H100": (67.0e12, 3.35e12, 495e12),
         "H200": (67.0e12, 4.8e12, 495e12)}


class Refused(RuntimeError):
    """The run cannot give a result (no card, a forbidden import, a
    trace that caught nothing): exit non-zero and print no result."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` with the files it
    names: ``configs/<config>.json``, ``traffic/<traffic>.json`` and
    ``workloads/<name>.json`` (the limits of its check), and the metrics
    that ``BENCHMARK.json`` gives it.  ``bench``: the file's content, or
    None to read it."""

    def __init__(self, name, bench=None):
        bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise Refused(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(ROOT / configs[self.entry["config"]]["file"])
        self.traffic = load_json(HERE / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.limits = load_json(HERE / "workloads" / f"{name}.json")["limits"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def driver(self):
        return importlib.import_module(
            f"perfbench.drivers.{self.traffic['driver']}")


class Outcome:
    """What a driver hands back: the end-to-end ``metrics``, the window's
    ``attempted`` and ``failed`` operations, the ``checks`` (name, value,
    limit) of the comparison with the reference, the traced ``span``
    (:class:`perfbench.readers.Span`, with ``--trace 1``) and the
    program's ``memory_peak`` bytes."""

    def __init__(self):
        self.metrics, self.checks = {}, []
        self.attempted = self.failed = self.memory_peak = 0
        self.span = None

    @property
    def correct(self):
        return self.failed == 0 and all(v <= lim for _, v, lim in self.checks)


def sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def memory_peak(device):
    if device.type != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated(device))


def load_reader(metric):
    """``layer_metrics/<metric>.py``, or else the reader of the name without
    its last dotted part, which a quantity split by cells shares
    (``mfu.md`` and ``mfu.serve`` read ``layer_metrics/mfu.py``)."""
    stem = metric
    while not (HERE / "layer_metrics" / f"{stem}.py").exists():
        if "." not in stem:
            raise Refused(f"no reader for the metric {metric!r}")
        stem = stem.rsplit(".", 1)[0]
    path = HERE / "layer_metrics" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_reader_" + stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gap(got, want, scale=None):
    """The widest gap over the largest reference value, or with ``scale``
    the widest of the gaps each over its own scale (inf for an answer of
    another shape)."""
    if got.shape != want.shape:
        return float("inf")
    if scale is None:
        return float((got - want).abs().max() / want.abs().max())
    return float(((got - want).abs() / scale).max())


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``torchmdnet_tpu_torch`` is not ``torchmdnet_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def peaks(name):
    """The data-sheet peaks of the card called ``name``."""
    for key in ("H100 PCIe", "H100 NVL", "H200", "H100"):
        if key in name or key.replace(" ", "-") in name:
            return PEAKS[key]
    raise Refused(f"no data-sheet peaks for {name!r}")


def device_peaks(device):
    """The data-sheet peaks of the card ``device``."""
    import torch

    return peaks(torch.cuda.get_device_name(device))


def least_seconds(work, peak):
    """The least time ``work`` can take on the card (``chip_smoke.py::
    bound``, copied): the larger of its bytes over the memory rate and its
    operations over their peak, where the ``tc`` FLOP run on the tensor
    cores as three TF32 products each (float32-accurate) and the ``fp32``
    FLOP on the float32 units beside them."""
    t_ops = max(work["fp32"] / peak[0], 3 * work["tc"] / peak[2])
    return max(t_ops, work["bytes"] / peak[1])


def power_limit():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def check_card(torch, chips):
    """Refuse to run without ``chips`` CUDA devices; returns the name."""
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell "
                      f"needs {chips}")
    return torch.cuda.get_device_name(0)


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None):
    """The last line of standard output: the fixed keys, then the numbers
    compared, each beside its limit, under ``checks`` (last)."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return json.dumps(out)
