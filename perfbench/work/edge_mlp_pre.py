"""Kernel 3's job on the gather path: the tail of every interaction
layer's edge MLP, ``silu(silu(silu(pre) W2 + b2) W3 + b3) * cutoff``,
forward, once for each directed pair within the cutoff, for all layers.

Per pair and layer (F channels): the products ``W2`` (2 F 2F) and ``W3``
(2 2F 3F) on the tensor cores, ~9 F on the float32 units (biases and the
cutoff); bytes: the preactivation ``[F]`` and the cutoff in, the
``[3F]`` weights out, and the weights once.  The reverse pair's weights
are the same numbers (the pair ``(j, i)`` is itself a directed pair), so
they are counted once.
"""

from perfbench.work.pairs import widths


def count(cfg, geom):
    f, _, _, layers = widths(cfg)
    p = geom["pairs"]
    return {"tc": layers * p * (2 * f * 2 * f + 2 * 2 * f * 3 * f),
            "fp32": layers * p * 9 * f,
            "bytes": layers * (p * 4 * (f + 1 + 3 * f)
                               + 4 * (2 * f * f + 6 * f * f + 5 * f))}
