"""The model's FLOP a span over its time, against TF32 / 3 (float32-accurate
products on the tensor cores)."""

from perfbench.readers import mfu


def read(span):
    return mfu(span)
