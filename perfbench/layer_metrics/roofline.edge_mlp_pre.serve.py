"""Kernel 3 (`edge_mlp_tc_kernel<false, ...>`) against the edge MLP tail of
every directed pair and layer (`work/edge_mlp_pre.py`)."""

from perfbench.readers import kernels_named, roofline

MATCH = kernels_named("edge_mlp_tc_kernel<false")


def read(span):
    return roofline(span, "edge_mlp_pre", MATCH)
