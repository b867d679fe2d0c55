"""Run one cell of the benchmark of ``torchmdnet_tpu_torch`` once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration (``configs/``), traffic mix (``traffic/``, which names the
driver in ``drivers/``) and the limits of its check (``workloads/``) are
files named after that entry, and each per-layer metric has a reader in
``layer_metrics/``.

With ``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profiled span after the warm-up.  Either way the run compares what its
window produced with the plain reference (``reference/``) and prints each
number compared beside its limit, as the last lines of standard error
and under ``checks`` in the result.  Without the cards, or with a JAX
module loaded once the window has closed, it prints no result and exits
non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def build_kernels(cell):
    """Compile the hand-written CUDA sources that the cell's configuration
    launches (``path.kernel_sources``), all at once, into the program's
    own cache inside the checkout; a source it launches beyond them the
    program builds at its first launch, in the warm-up."""
    from torchmdnet_tpu_torch.ops.kernels import CudaSource, build

    build([CudaSource(n) for n in cell.config["path"]["kernel_sources"]])


def main(argv=None):
    args = parse(argv)
    cell = harness.Cell(args.workload)
    import torch

    name = harness.check_card(torch, cell.chips)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    build_kernels(cell)
    print(execute(cell, args, device, name), flush=True)


def execute(cell, args, device, name):
    """Run the cell's driver on ``device`` (the card ``name``), check the
    imports, read the metrics and return the result line; the numbers
    compared go to standard error, each beside its limit."""
    out = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace),
                            T_START, device)
    found = harness.forbidden_modules()
    if found:
        raise harness.Refused("loaded in the measured process: "
                              + ", ".join(found))
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = harness.load_reader(m["name"]).read(out.span)
            if value is None:
                print(f"{m['name']}: nothing to read in the span, left "
                      "out", file=sys.stderr)
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        trace = out.span.trace
        extra = {"busy_s": trace.busy_s, "window_s": trace.window_s}
        breakdown = trace.breakdown()
    else:
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in out.metrics]
        if missing:
            raise harness.Refused(f"the driver gave no {missing}")
        metrics = {m["name"]: {"value": out.metrics[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
        extra, breakdown = {}, None
    device_info = {"platform": "gpu", "kind": name, "count": cell.chips,
                   "memory_peak_bytes": out.memory_peak, **extra,
                   "power_limit_w": harness.power_limit()}
    print(f"failed {out.failed} of {out.attempted}", file=sys.stderr)
    for key, value, limit in out.checks:
        print(f"{key} {value!r} limit {limit!r}", file=sys.stderr, flush=True)
    return harness.result_line(out.correct, out.attempted, out.failed,
                               metrics, device_info, out.checks, breakdown)


if __name__ == "__main__":
    try:
        main()
    except harness.Refused as err:
        print(f"perfbench: {err}", file=sys.stderr)
        sys.exit(3)
