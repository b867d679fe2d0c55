"""The FLOP of one energy-and-forces evaluation of the TensorNet2 model
with its Coulomb head, from its equations on the atoms and pairs the
inputs hold.

Forward, per atom (F channels, q charge channels, L layers): the pair
embedding's halves (4 F^2), the embedding's scalar MLP (16 F^2) and its
three channel mixes over the nine tensor components (18 F^2), L + 1
charge heads (8 F^2 + 4 q F each), per layer the two channel mixes (36
F^2), the charge terms (4 q F) and the 3x3 products (162 F), the readout
(6 F^2) and the energy head (F^2 + F).  Per directed pair within the
cutoff (self pairs included): the embedding's projections and sums (6 R
F + 23 F) and per layer the edge MLP and message (2 R F + 16 F^2 + 23 F).
Per Coulomb pair: the charge product and the kernel (2 * 3q + 20).

The force pass computes the input gradient of every product once more
(the weights are frozen, so no weight gradients), so an evaluation is
twice the forward.
"""

from perfbench.work.pairs import widths


def flops(cfg, geom):
    f, r, q, layers = widths(cfg)
    atom = (4 * f * f + 16 * f * f + 18 * f * f
            + (layers + 1) * (8 * f * f + 4 * q * f)
            + layers * (36 * f * f + 4 * q * f + 162 * f)
            + 6 * f * f + f * f + f)
    pair = 6 * r * f + 23 * f + layers * (2 * r * f + 16 * f * f + 23 * f)
    coulomb = 2 * 3 * q + 20
    forward = (geom["atoms"] * atom + geom["pairs"] * pair
               + geom["coulomb_pairs"] * coulomb)
    return 2 * forward
