"""Shared pieces of the benchmark's own tests.

Run them from the root of a checkout:

    python -m pytest perfbench/tests -q

Tests marked ``card`` need a CUDA device and skip without one; they are
decided inside a fixture, never while a module is imported.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the widths and sizes of a cell cut to what a CPU test run holds
TINY_MODEL = dict(embedding_dimension=16, num_rbf=8, q_dim=4, max_z=20,
                  q_weights=[[1.0] * 4] * 3)
TINY_TRAFFIC = {"md_chunks": dict(atoms=512, rebuild_every=5),
                "serve_closed": dict(molecules=6, pool=3, trace_batches=2)}
# the Coulomb windows of a 512-atom box need a cutoff + skin within one
# 5.5 A column
TINY_COULOMB = {"md_chunks": 4.5}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def tiny_cell(name):
    """The cell ``name``, its model and traffic cut to a size a CPU test
    holds (the limits as the cell has them)."""
    from perfbench import harness

    cell = harness.Cell(name)
    driver = cell.traffic["driver"]
    model = dict(cell.config["model"], **TINY_MODEL)
    if driver in TINY_COULOMB:
        model["coulomb_cutoff"] = TINY_COULOMB[driver]
    cell.config = dict(cell.config, model=model)
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC[driver])
    return cell


@pytest.fixture(scope="session")
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
