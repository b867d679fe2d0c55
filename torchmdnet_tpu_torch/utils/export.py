"""Ahead-of-time export of a potential's ``pos -> (E, F)`` step
(counterpart of ``torchmdnet_tpu/utils/export.py``, which serializes the
jitted step as StableHLO; here a ``torch.export`` program).

``export_potential`` freezes the shapes, as JAX's does (the atom count,
the molecules, the neighbor capacity): the atom types, molecules, box,
charges and weights are constants of the program, the positions its one
input.  The forces come from ``torch.autograd.grad`` inside
``Potential.apply``; ``torch.export`` does not trace that call itself, so
the step is first traced with ``make_fx`` on fake tensors, which records
the forward and the backward as one graph of operators, and that graph
is exported.  On the card the port's kernels 1-4 are operators of the
dispatcher (``tmdnet::radial_embedding_fwd``/``_bwd``, ``tmdnet::
edge_mlp_pre``, ``tmdnet::edge_mlp``), so the program calls them and
launches the kernels when it runs; an operator with data-dependent
shapes would stop the trace with an error.  ``load_exported`` rebuilds a
callable from the artifact without the model code: it needs only the
operators' registrations, which importing this module makes.
"""

import io

import torch
from torch.fx.experimental.proxy_tensor import make_fx

# the kernels' operators must be registered to trace and to load
from torchmdnet_tpu_torch.ops import edge_mlp, radial_embedding  # noqa: F401


class _Apply(torch.nn.Module):
    """``potential.apply`` as a module whose state is the potential's."""

    def __init__(self, potential, num_mols):
        super().__init__()
        self.model = potential.module
        self._potential = potential
        self.num_mols = num_mols

    def forward(self, z, pos, batch, box, q):
        return self._potential.apply(z, pos, batch, num_mols=self.num_mols,
                                     box=box, q=q)


class _Program(torch.nn.Module):
    """The traced step over its frozen constants: ``pos -> (E, F)``."""

    def __init__(self, graph, state, consts):
        super().__init__()
        self.graph_module = graph
        self.n_state = len(state)
        for i, t in enumerate(list(state) + list(consts)):
            self.register_buffer(f"c{i}", t)

    def forward(self, pos):
        c = [getattr(self, f"c{i}") for i in range(len(self._buffers))]
        return self.graph_module(c[:self.n_state], pos, *c[self.n_state:])


def export_potential(potential, z, batch, *, num_mols, box=None, q=None,
                     path=None) -> bytes:
    """The ``torch.export`` program of ``pos [N, 3] -> (E [num_mols, 1],
    F [N, 3])`` for these atoms, as bytes (also written to ``path`` when
    given).  It runs on the potential's device."""
    dev, dtype = potential.device, potential.dtype
    consts = [torch.as_tensor(z, device=dev).long(),
              torch.as_tensor(batch, device=dev).long()]
    for t in (box, q):
        if t is not None:
            consts.append(torch.as_tensor(t, dtype=dtype, device=dev))
    wrapper = _Apply(potential, int(num_mols))
    named = dict(wrapper.named_parameters())
    named.update(wrapper.named_buffers())
    names = list(named)
    state = [named[k].detach() for k in names]

    def step(state, pos, z, batch, *rest):
        rest = list(rest)
        box_ = rest.pop(0) if box is not None else None
        q_ = rest.pop(0) if q is not None else None
        return torch.func.functional_call(
            wrapper, dict(zip(names, state)), (z, pos, batch, box_, q_))

    pos = torch.zeros((consts[0].shape[0], 3), dtype=dtype, device=dev)
    # forward and force pass as one graph of operators, on fake tensors
    graph = make_fx(step, tracing_mode="fake")(state, pos, *consts)
    program = torch.export.export(_Program(graph, state, consts), (pos,),
                                  strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(blob)
    return blob


def load_exported(path_or_bytes):
    """A callable ``pos -> (E, F)`` from :func:`export_potential`'s bytes
    or file."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        src = io.BytesIO(bytes(path_or_bytes))
    else:
        src = path_or_bytes
    program = torch.export.load(src).module()

    def run(pos):
        return program(pos)

    run.program = program
    return run
