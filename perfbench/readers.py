"""What the per-layer readers share.  A reader (``layer_metrics/<metric>
.py``) gets a :class:`Span`: the traced span's :class:`~perfbench.trace.
Trace`, the work its inputs asked for, and the card's peaks.  A reader
that finds nothing to read returns None and its metric is left out of
the line; a share past 100% is a fault in the count and is refused."""

import importlib
import re

from perfbench.harness import Refused, least_seconds
from perfbench.trace import base_name, is_library, program_kernels


class Span:
    """The traced span: ``trace``, the configuration ``cfg``, ``geom``
    (the inputs' atoms and pairs, :func:`perfbench.work.pairs.geometry`),
    ``evaluations`` (energy-and-forces evaluations in it), ``units`` (the
    steps or batches of the metric's denominator) and ``peak``."""

    def __init__(self, trace, cfg, geom, evaluations, units, peak):
        self.trace, self.cfg, self.geom = trace, cfg, geom
        self.evaluations, self.units, self.peak = evaluations, units, peak


def share(value):
    if value > 100.0:
        raise Refused(f"a share of {value:.3f}% passes 100%: the work is "
                      "counted too high or the time leaves part of it out")
    return value


def roofline(span, group, match):
    """The group's least time over its device time, in %: the work of
    ``perfbench/work/<group>.py`` for the span's evaluations against the
    time of the device operations whose name ``match`` accepts."""
    seconds = span.trace.seconds_where(match)
    if seconds <= 0:
        return None
    per_eval = importlib.import_module(f"perfbench.work.{group}").count(
        span.cfg, span.geom)
    work = {k: v * span.evaluations for k, v in per_eval.items()}
    return share(100.0 * least_seconds(work, span.peak) / seconds)


def kernels_named(*keys):
    """A ``match`` for the kernels named by one of ``keys``, each a whole
    identifier in the kernel's full name, in whatever namespace
    (``q_tc_kernel`` is not ``dq_tc_kernel``); a key may carry the start
    of the template's arguments (``edge_mlp_tc_kernel<false``)."""
    found = re.compile("|".join(rf"(?<!\w){re.escape(k)}(?!\w)"
                                for k in keys))
    return lambda name: found.search(name) is not None


def plain_ops_ms(span):
    """Device ms per unit in operations that are neither the program's
    hand-written kernels nor a vendor matrix product."""
    mine = program_kernels()
    seconds = span.trace.seconds_where(
        lambda n: base_name(n) not in mine and not is_library(n))
    return 1e3 * seconds / span.units


def idle_share(span):
    return share(100.0 * span.trace.idle_share())


def mfu(span):
    """The model's FLOP over the span's time, against the rate of
    float32-accurate products on the tensor cores (TF32 / 3)."""
    flops = importlib.import_module("perfbench.work.model_step").flops(
        span.cfg, span.geom) * span.evaluations
    return share(100.0 * flops / span.trace.window_s / (span.peak[2] / 3))
