"""A step captured once into a ``torch.cuda.CUDAGraph`` and replayed.

The port's counterpart of the JAX package's jitted fixed-shape steps
(``md/calculators.py:3-6``, ``optimize.py:9-11``): :class:`GraphedStep`
runs ``fn`` on static input buffers a few times on a side stream (the
first call builds the kernels; the last runs under
``torch.cuda.set_sync_debug_mode("error")``, so that a host sync, which
would break the capture, names its line), captures one call, and then
copies each call's inputs into the buffers and replays the graph.  A
replay issues the captured launches again without Python, so the
kernels' launch counts (``ops/kernels.py::Kernel.launches``) grow only
at the capture: a graphed path launches its counted kernels "per capture"
times the number of replays.
"""

import torch


WARMUP_STEPS = 3  # eager calls before a capture, unless a caller says


class GraphedStep:
    """``fn(*inputs) -> tuple of tensors (or None)`` as a CUDA graph over
    static copies of ``example_inputs`` (CUDA tensors, shapes fixed from
    here on).  ``warmup_steps`` eager calls precede the capture."""

    def __init__(self, fn, example_inputs, warmup_steps: int = WARMUP_STEPS):
        self.inputs = [x.detach().clone() for x in example_inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(max(int(warmup_steps), 1)):
                last = i == max(int(warmup_steps), 1) - 1
                mode = torch.cuda.get_sync_debug_mode()
                if last:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    fn(*self.inputs)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)
        self.replays = 0

    def __call__(self, *inputs):
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        self.replays += 1
        return tuple(None if o is None else o.clone() for o in self.outputs)
