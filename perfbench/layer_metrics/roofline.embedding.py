"""Kernels 1 and 2 against the radial embedding and its force pass
(`work/embedding.py`)."""

from perfbench.readers import kernels_named, roofline

MATCH = kernels_named("emb_fwd_tc_kernel", "emb_bwd_tc_kernel",
                      "emb_dk_sum_kernel")


def read(span):
    return roofline(span, "embedding", MATCH)
