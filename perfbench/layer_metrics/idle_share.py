"""1 - the union of the device's busy intervals / the span's time, in %."""

from perfbench.readers import idle_share


def read(span):
    return idle_share(span)
