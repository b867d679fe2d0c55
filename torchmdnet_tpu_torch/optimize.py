"""Repeated inference on one fixed system (counterpart of
``torchmdnet_tpu/optimize.py``, reference ``torchmdnet/optimize.py``).

``optimize`` returns ``step(pos) -> (E, F)`` specialised to one system's
atoms, molecules, box and charges:

* with ``rebuild_every <= 1`` every call builds the neighbor lists and
  evaluates, exact at any move;
* with ``rebuild_every > 1`` the lists (the model's, and the Coulomb
  head's where it has a cutoff) are built at ``cutoff + skin`` through
  :func:`~torchmdnet_tpu_torch.md.integrators.make_md_step`'s rebuild
  (JAX ``:54-63``) on the first call and every ``rebuild_every`` calls
  after it, and reused in between; edges past the true cutoff contribute
  exactly zero, so the results are exact while no atom moves more than
  ``skin/2`` from where it was at the last rebuild.

On the card the evaluation on fixed lists (JAX ``_apply``, ``:67-84``), or
the whole step with ``rebuild_every <= 1``, is captured as a CUDA graph on
its first call (``utils/graphs.py``); the list rebuild runs outside the
graph, as JAX's ``init_state`` runs outside its jitted ``_apply``
(``:88-96``).  On the CPU the step is eager.

``step.overflow()`` is True after a list ran out of slots (K overflow, as
in JAX) or, where the lists are cached, after a call whose atoms had moved
more than ``skin/2`` since the last rebuild (the condition under which
JAX's docstring says the cached lists stop being exact): check it after
use.  ``step.runner`` holds the evaluation (its ``graph``, a
:class:`~torchmdnet_tpu_torch.utils.graphs.GraphedStep`, after the first
call on the card).  Unlike the reference's NNPOps path this serves every
model.
"""

from typing import Optional

import torch

from torchmdnet_tpu_torch.ops.neighbors import NeighborMatrix, wrap_deltas
from torchmdnet_tpu_torch.utils.graphs import GraphedStep


class _Step:
    """``fn`` called eagerly, or through a :class:`GraphedStep` made on
    its first call."""

    def __init__(self, fn, graphed: bool):
        self.fn = fn
        self.graphed = graphed
        self.graph = None

    def __call__(self, *args):
        if not self.graphed:
            return self.fn(*args)
        if self.graph is None:
            self.graph = GraphedStep(self.fn, args)
        return self.graph(*args)


def optimize(potential, z, batch, *, num_mols, box=None, q=None,
             rebuild_every: int = 1, skin: float = 0.0,
             k_max: Optional[int] = None):
    """``step(pos) -> (E [num_mols, 1], F [N, 3])`` on ``potential``'s
    device (see the module docstring)."""
    dev = potential.device
    graphed = dev.type == "cuda"
    z = torch.as_tensor(z, device=dev).long()
    batch = torch.as_tensor(batch, device=dev).long()
    if box is not None:
        box = torch.as_tensor(box, dtype=potential.dtype, device=dev)
    if q is not None:
        q = torch.as_tensor(q, dtype=potential.dtype, device=dev)

    def as_pos(pos):
        return torch.as_tensor(pos, dtype=potential.dtype, device=dev)

    if rebuild_every <= 1:
        def direct(pos):
            return potential.apply(z, pos, batch, num_mols=num_mols,
                                   box=box, q=q)

        run = _Step(direct, graphed)

        def simple_step(pos):
            return run(as_pos(pos))

        simple_step.overflow = lambda: False
        simple_step.runner = run
        return simple_step

    from torchmdnet_tpu_torch.md.integrators import make_md_step

    # the MD machinery's list management (skin-padded lists, overflow)
    # without the integrator: each rebuild makes a fresh state at pos
    _, chunk, _ = make_md_step(
        potential, z, batch, torch.ones(z.shape[0]), dt=0.0,
        num_mols=num_mols, box=box, q=q, rebuild_every=rebuild_every,
        skin=skin, k_max=k_max)
    atom_mask = batch < num_mols
    half_skin = 0.5 * float(skin)

    def apply(pos, ref_pos, nbr_idx, nbr_mask, nbr_rev, *coulomb):
        delta = pos - ref_pos
        if box is not None:
            delta = wrap_deltas(delta, box if box.dim() == 2
                                else box[batch])
        moved = ((delta * delta).sum(-1) * atom_mask).max() \
            > half_skin * half_skin
        cnbr = NeighborMatrix(*coulomb) if coulomb else None
        y, neg_dy = potential.apply(
            z, pos, batch, num_mols=num_mols, box=box, q=q,
            nbr=NeighborMatrix(nbr_idx, nbr_mask, rev_slot=nbr_rev),
            coulomb_nbr=cnbr)
        return y, neg_dy, moved

    run = _Step(apply, graphed)
    cur = {"state": None, "calls": 0, "moved": None}

    def step(pos):
        pos = as_pos(pos)
        if cur["calls"] % rebuild_every == 0:
            cur["state"] = chunk.init_raw(pos)  # a state whose lists are new
        cur["calls"] += 1
        s = cur["state"]
        lists = (s.nbr_idx, s.nbr_mask, s.nbr_rev)
        if s.cnbr_idx is not None:
            lists += (s.cnbr_idx, s.cnbr_mask)
        y, neg_dy, moved = run(pos, s.pos, *lists)
        cur["moved"] = moved if cur["moved"] is None else cur["moved"] | moved
        return y, neg_dy

    def overflow():
        s = cur["state"]
        if s is None:
            return False
        return bool(s.overflow) or bool(cur["moved"])

    step.overflow = overflow
    step.runner = run
    return step
