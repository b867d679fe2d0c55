"""Kernels A, A+du and B (`q_tc_kernel`, `dq_tc_kernel`) against the
interaction layers' edge pipeline and its force pass (`work/q_tier.py`)."""

from perfbench.readers import kernels_named, roofline

MATCH = kernels_named("q_tc_kernel", "dq_tc_kernel")


def read(span):
    return roofline(span, "q_tier", MATCH)
