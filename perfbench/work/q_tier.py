"""Kernels A and B's job on the blocked path: every interaction layer's
edge pipeline (the charge-aware edge MLP and the asymmetric neighbour sum)
and its force pass, counted from the model's equations on the pairs
within the cutoff, for all layers.

Per directed pair and layer (F channels, R radial functions): the MLP's
products ``rbf(d) W1a`` (2 R F), ``W2`` (2 F 2F) and ``W3`` (2 2F 3F)
forward and the same transposed in the force pass (the weights are
frozen), all on the tensor cores; on the float32 units the message's nine
channel products (18 F), the first layer's charge terms, activations and
cutoff (~5 F) forward, and ~44 F for the force pass's fold, reverse sum
and activation derivatives.

Bytes, each pass reading its inputs and writing its outputs once: per pair
the distance and partner index (8 B) in each pass and the distance's
cotangent (4 B) out; per atom the features ``[9F]`` and both charge terms
``[2F]`` in each pass, the message ``[9F]`` out, the cotangent ``[9F]``
in and the cotangents ``[9F + 2F]`` out; the weights once a pass.
"""

from perfbench.work.pairs import widths


def count(cfg, geom):
    f, r, _, layers = widths(cfg)
    p, n = geom["pairs"], geom["atoms"]
    mlp = 2 * r * f + 2 * f * 2 * f + 2 * 2 * f * 3 * f
    weights = 4 * (r * f + 2 * f * f + 2 * f + 6 * f * f + 3 * f)
    per_layer = {
        "tc": p * 2 * mlp,
        "fp32": p * (18 + 5 + 44) * f,
        "bytes": p * (8 + 8 + 4) + n * 4 * (11 * f + 9 * f
                                            + 11 * f + 9 * f + 11 * f)
        + 2 * weights}
    return {k: layers * v for k, v in per_layer.items()}
