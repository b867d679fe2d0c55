"""The entry point: it refuses to run without a card, and its last line
has exactly the fixed keys (a run at a tiny size on the CPU, the look for
a card skipped)."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from conftest import ROOT, tiny_cell

FIXED = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "aceff_pbc10.md_25k", "--seed", "3", "--seconds", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("cell", ["aceff.serve_b128", "aceff_pbc10.md_25k"])
def test_last_line_keys(cell, one_thread, capsys):
    import torch

    sys.path.insert(0, str(ROOT / "perfbench"))
    import run

    c = tiny_cell(cell)
    args = SimpleNamespace(seed=2 ** 40 + 1, seconds=0.5, trace=0)
    line = json.loads(run.execute(c, args, torch.device("cpu"), "cpu"))
    assert list(line) == FIXED
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    err = capsys.readouterr().err.strip().splitlines()
    names = list(line["checks"])
    assert [e.split()[0] for e in err[-len(names):]] == names


@pytest.mark.parametrize("cell", ["aceff.serve_b128", "aceff_pbc10.md_25k"])
def test_traced_line(cell, one_thread, monkeypatch):
    """A traced run reads every per-layer metric of the cell from its
    span (the profile, which needs a card, stands in synthetic)."""
    import torch

    from perfbench import trace
    from perfbench.drivers import md_chunks, serve_closed

    # the names as the card's profiler gives them
    anon = "(anonymous namespace)::"
    names = (f"void {anon}q_tc_kernel<false, false, false>({anon}QParams)",
             f"void {anon}dq_tc_kernel<false, false>({anon}QParams)",
             f"void {anon}emb_fwd_tc_kernel<false>({anon}EmbParams)",
             f"void {anon}emb_bwd_tc_kernel<false, false>({anon}EmbParams)",
             f"void {anon}edge_mlp_tc_kernel<false, 128>({anon}MlpParams)",
             "void at::native::vectorized_elementwise_kernel<4>()")

    def fake_capture(torch_, run_span):
        run_span()
        device = [(10.0 * k, 10.0 * k + 9.0, n) for k, n in enumerate(names)]
        return trace.Trace(device, [(0.0, 60.0, "aten::mm")], 60.0)

    for mod in (md_chunks, serve_closed):
        monkeypatch.setattr(mod, "capture", fake_capture)
        monkeypatch.setattr(mod, "device_peaks",
                            lambda device: (67e12, 3.35e12, 495e12))
    sys.path.insert(0, str(ROOT / "perfbench"))
    import run

    c = tiny_cell(cell)
    args = SimpleNamespace(seed=2 ** 40 + 3, seconds=0.5, trace=1)
    line = json.loads(run.execute(c, args, torch.device("cpu"), "cpu"))
    assert list(line) == FIXED[:5] + ["breakdown", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in c.per_layer}
    assert line["device"]["busy_s"] == pytest.approx(54.0)
    assert len(line["breakdown"]["device_ops"]) == len(names)
