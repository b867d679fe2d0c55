"""Each cell's check, driven through a whole run at a tiny size on the
CPU (the look for a card skipped) with the timed path broken underneath,
must come out not correct; and unbroken, correct.  The faults: a step
that returns its state unchanged, half of the batch left out with the
mean of the rest in its place, and an answer altered where it is made.
(Both cells run on one chip, so there is no exchange between chips to
leave out.)"""

import time

import pytest
import torch

from conftest import tiny_cell

SEED = 2 ** 33 + 17


def run(cell):
    out = cell.driver().run(cell, SEED, 0.5, False, time.perf_counter(),
                            torch.device("cpu"))
    return out.correct, {k: v for k, v, _ in out.checks}


def altered_model(monkeypatch):
    """The model's energy moved by 0.1 eV/A times the atoms' summed x."""
    from torchmdnet_tpu_torch.models.model import TorchMDNet

    forward = TorchMDNet.forward

    def broken(self, z, pos, batch, **kw):
        return forward(self, z, pos, batch, **kw) + 0.1 * pos[:, 0].sum()

    monkeypatch.setattr(TorchMDNet, "forward", broken)


def md_fault(monkeypatch, fault):
    from perfbench.drivers import md_chunks

    build = md_chunks.build_chunk

    def broken_build(cell, system, seed):
        st, chunk = build(cell, system, seed)
        every = cell.traffic["rebuild_every"]

        def frozen(s):
            return s._replace(step=s.step + every)

        def half(s):
            s = chunk(s)
            f = s.force.clone()
            f[len(f) // 2:] = f[:len(f) // 2].mean(0)
            return s._replace(force=f)

        broken = {"state_unchanged": frozen, "half_left_out": half}[fault]
        broken.rebuild, broken.steps = chunk.rebuild, chunk.steps
        return st, broken

    monkeypatch.setattr(md_chunks, "build_chunk", broken_build)


def serve_fault(monkeypatch, fault):
    from perfbench.drivers import serve_closed

    call = serve_closed.call
    previous = []

    def stale(pot, inputs):
        # the answer of the call before, whatever was asked
        now = call(pot, inputs)
        out = previous[-1] if previous else now
        previous.append(now)
        return out

    def half(pot, inputs):
        y, f = call(pot, inputs)
        _, _, batch, q = inputs
        m = len(q) // 2
        y, f = y.clone(), f.clone()
        y[m:] = y[:m].mean()
        f[batch >= m] = 0.0
        return y, f

    monkeypatch.setattr(serve_closed, "call",
                        {"state_unchanged": stale, "half_left_out": half}[fault])


@pytest.mark.parametrize("cell", ["aceff_pbc10.md_25k", "aceff.serve_b128"])
def test_sound_run_is_correct(cell, one_thread):
    correct, checks = run(tiny_cell(cell))
    assert correct, checks


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_md_fault_is_caught(fault, monkeypatch, one_thread):
    if fault == "answer_altered":
        altered_model(monkeypatch)
    else:
        md_fault(monkeypatch, fault)
    correct, checks = run(tiny_cell("aceff_pbc10.md_25k"))
    assert not correct, checks


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_serve_fault_is_caught(fault, monkeypatch, one_thread):
    if fault == "answer_altered":
        altered_model(monkeypatch)
    else:
        serve_fault(monkeypatch, fault)
    correct, checks = run(tiny_cell("aceff.serve_b128"))
    assert not correct, checks
