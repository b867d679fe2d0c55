"""One traced span of a run: the device's operations and the host's, read
from ``torch.profiler``, timed by CUDA events beside it.

``capture`` profiles a bounded steady span after the warm-up.  The
device's busy time is the union of the intervals in which an operation
ran (kernels overlap, so a sum of kernel times would count some time
twice), and the span's length is the CUDA events' time around it.  A
profile that caught no device activity, or more of it than the events
allow, is refused rather than read as an idle card.
"""

import re
from pathlib import Path

import numpy as np

from perfbench.harness import Refused

# where the program's hand-written kernels are defined
PROGRAM_CSRC = Path(__file__).resolve().parent.parent / \
    "torchmdnet_tpu_torch" / "csrc"
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
# a vendor matrix-product kernel (cuBLAS, cuBLASLt, CUTLASS inside them)
_LIBRARY = ("gemm", "gemv", "cublas", "splitkreduce", "xmma", "cutlass")
# the busy time may pass the events' time by timestamp rounding only
_BUSY_SLACK = 1.02


def program_kernels():
    """The names of the ``__global__`` functions in the program's
    ``csrc``: its hand-written kernels."""
    names = set()
    for path in sorted(PROGRAM_CSRC.glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text()))
    return names


def base_name(kernel):
    """``void (anonymous namespace)::q_tc_kernel<false, ...>(QParams)`` ->
    ``q_tc_kernel``; a kernel in a named namespace keeps it
    (``at::native::reduce_kernel``)."""
    name = kernel[5:] if kernel.startswith("void ") else kernel
    name = name.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def is_library(kernel):
    low = kernel.lower()
    return any(k in low for k in _LIBRARY)


def _union(intervals):
    """Merged ``[start, end]`` rows of ``intervals`` (sorted by start)."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    """Device and host events of a span (times in seconds)."""

    def __init__(self, device, host, window_s):
        self.device = sorted(device)   # (start, end, name)
        self.host = host               # (start, end, name)
        self.window_s = window_s       # CUDA events around the span
        self.busy = _union([(s, e) for s, e, _ in self.device])
        self.busy_s = sum(e - s for s, e in self.busy)
        if not self.device or self.busy_s <= 0:
            raise Refused("the profiler caught no device activity in the "
                          "traced span")
        if self.busy_s > window_s * _BUSY_SLACK + 1e-4:
            raise Refused(f"the profiler's busy time {self.busy_s:.6f} s "
                          f"passes the span's {window_s:.6f} s: the trace "
                          "disagrees with the CUDA events")

    def seconds_by_name(self):
        out = {}
        for s, e, name in self.device:
            out[name] = out.get(name, 0.0) + (e - s)
        return out

    def seconds_where(self, keep):
        """Device seconds of the operations whose name ``keep`` accepts."""
        return sum(e - s for s, e, name in self.device if keep(name))

    def idle_share(self):
        return max(0.0, 1.0 - self.busy_s / self.window_s)

    def idle_by_host(self, top=10, gaps=300):
        """The device's idle time inside the span by what the host was
        doing: each of the ``gaps`` longest gaps between busy intervals
        goes to the shortest host operation that covers half of it (or
        the one that overlaps it most), summed by name; the time before
        the first and after the last operation goes to ``span edges``."""
        edges = max(0.0, self.window_s - (self.busy[-1][1]
                                          - self.busy[0][0]))
        holes = [(b[0] - a[1], a[1], b[0])
                 for a, b in zip(self.busy, self.busy[1:])]
        holes.sort(reverse=True)
        hs = np.array([h[0] for h in self.host]) if self.host else None
        he = np.array([h[1] for h in self.host]) if self.host else None
        out = {"span edges": edges} if edges > 0 else {}
        for length, gs, ge in holes[:gaps]:
            name = "no host operation"
            if hs is not None:
                overlap = np.clip(np.minimum(he, ge) - np.maximum(hs, gs),
                                  0.0, None)
                cover = np.flatnonzero(overlap >= 0.5 * length)
                if len(cover):
                    k = cover[np.argmin((he - hs)[cover])]
                    name = self.host[k][2]
                elif overlap.max() > 0:
                    name = self.host[int(np.argmax(overlap))][2]
            out[name] = out.get(name, 0.0) + length
        rest = sum(h[0] for h in holes[gaps:])
        if rest > 0:
            out["shorter gaps"] = rest
        return sorted(out.items(), key=lambda kv: -kv[1])[:top]

    def breakdown(self, top=10):
        ops = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:200], s] for n, s in ops[:top]],
                "idle_gaps": [[n[:200], s] for n, s in self.idle_by_host(top)]}


def capture(torch, run_span):
    """Profile ``run_span()`` (host and device) between two CUDA events.
    The profiler may lay the host's ``record_function`` ranges on the
    device's timeline too; such an event bears its host range's name (a
    kernel's name is never a host operation's) and is no device work, so
    a device event named as a host event is dropped."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        run_span()
        end.record()
        end.synchronize()
    events = prof.events()
    host = [(e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
            for e in events if e.device_type != DeviceType.CUDA]
    return Trace(device_work(events, {name for _, _, name in host}), host,
                 start.elapsed_time(end) * 1e-3)


def device_work(events, host_names):
    """``(start, end, name)`` of the device's operations among the
    profiler's ``events``: neither an event the profiler flags as a user
    range nor one named as a host event."""
    from torch.autograd import DeviceType

    return [(e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
            for e in events if e.device_type == DeviceType.CUDA
            and e.name not in host_names
            and not getattr(e, "is_user_annotation", False)]
