"""Readings of a cell's control: the reference, computed in TF32 (the
precision below the float32 that the configurations state), in the
program's place, at the cell's own size.

    python3 perfbench/control.py --workload <name> --seeds 1 2 3

prints one JSON line per seed.  The limits in ``workloads/<name>.json``
sit between the program's readings and the control's.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def main(argv=None):
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    harness.check_card(torch, cell.chips)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        readings = cell.driver().control(cell, seed, device)
        print(json.dumps({"seed": seed, "control": {
            k: v for k, v, _ in readings}}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
