"""Device ms a step (MD) or a batch (serving) in operations that are
neither the program's kernels nor a vendor matrix product."""

from perfbench.readers import plain_ops_ms


def read(span):
    return plain_ops_ms(span)
