"""Kernels 1 and 2's job, the radial tensor embedding and its force pass,
counted from the model's equations on the pairs within the cutoff.

Per directed pair (self pairs included; F channels, R radial functions):

- forward: the three distance projections ``rbf(d) W`` (2 R 3F FLOP, a
  product the kernels run on the tensor cores), the pair weights and the
  nine weighted sums into ``(I, A, S)`` (23 F on the float32 units);
- force pass (the weights are frozen: input gradients only): the same
  product transposed (2 R 3F) and ~44 F for the cotangents of the pair
  weights, the cutoff and the unit vector.

Bytes, each input read once and each output written once in each of the
two passes: per pair its distance, unit vector and partner index (20 B)
in each pass and the force pass's two cotangents (16 B) out; per atom
the two halves of the pair embedding (2F) in each pass, the ``[9F]``
output, and the force pass's ``[9F]`` cotangent in.
"""

from perfbench.work.pairs import widths


def count(cfg, geom):
    f, r, _, _ = widths(cfg)
    p, n = geom["pairs"], geom["atoms"]
    return {"tc": p * 2 * (2 * r * 3 * f),
            "fp32": p * (23 + 44) * f,
            "bytes": p * (20 + 20 + 16) + n * 4 * 2 * (2 * f + 9 * f)
            + 4 * (r + 1) * 3 * f}
