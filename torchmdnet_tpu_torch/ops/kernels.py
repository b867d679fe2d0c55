"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source exposes plain C entry points; it is compiled with
``nvcc`` for ``sm_90a`` into its own shared library under ``_build/`` the
first time a kernel of it is launched, keyed by a hash of the source, the
shared ``csrc/*.cuh`` headers and the flags, and loaded with ``ctypes``;
the compiler's output (with ``ptxas``'s register and spill report) is
kept beside it.  Nothing is compiled at import.

Every entry point takes the CUDA stream as its last argument and returns
``cudaGetLastError()`` after its launches; :class:`Kernel` raises on a
non-zero code and counts successful launches.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class CudaSource:
    """One ``csrc`` file and the shared library built from it."""

    def __init__(self, filename: str):
        self.path = CSRC / filename
        self._lib = None

    def library_path(self) -> Path:
        # the shared headers are part of every source's key
        text = self.path.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"{self.path.stem}-{digest[:16]}.so"

    def start_build(self):
        """Start ``nvcc`` on this source unless its library exists; returns
        the running process (or None) and the library path."""
        out = self.library_path()
        if out.exists():
            return None, out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.path)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.tmp = tmp
        return proc, out

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            build([self])
            self._lib = ctypes.CDLL(str(self.library_path()))
        return self._lib


def build(sources) -> dict:
    """Compile every source that has no library yet, all ``nvcc`` processes
    at once; returns ``{source name: compiler output}`` (of the build that
    made the library, also when it was made before) and raises if one
    fails."""
    procs = [(src, *src.start_build()) for src in sources]
    logs, failed = {}, []
    for src, proc, out in procs:
        if proc is None:
            logs[src.path.name] = out.with_suffix(".log").read_text()
            continue
        log, _ = proc.communicate()
        logs[src.path.name] = log
        if proc.returncode != 0:
            failed.append(f"{src.path.name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(proc.tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


class Kernel:
    """One C entry point of a :class:`CudaSource`, with a launch count.

    ``launches`` grows by one for each successful call and nowhere else.
    """

    def __init__(self, source: CudaSource, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            lib = self.source.library()
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes + [P]
            fn.restype = I32
            err = lib.tmd_error_string
            err.argtypes = [I32]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        rc = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} "
                               f"({self._err(rc).decode()})")
        self.launches += 1


def check_cuda_args(name, tensors: dict, device) -> None:
    """Raise unless every tensor is a contiguous float32 CUDA tensor on
    ``device``."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def lane_width(n: int, multiple: int = 4) -> int:
    """``n`` rounded up to a multiple of ``multiple``: the width the
    kernels that read float4 rows take, where an op's wrapper pads an
    operand of another width (:func:`pad_lanes`)."""
    return -(-n // multiple) * multiple


def pad_lanes(t: torch.Tensor, dim: int, blocks: int, to: int):
    """``t`` with its axis ``dim``, ``blocks`` runs of ``w`` lanes each,
    widened to ``blocks`` runs of ``to`` lanes: zeros after each run's
    ``w`` (a contiguous copy; ``t`` itself where ``w == to``)."""
    dim %= t.dim()
    w = t.shape[dim] // blocks
    if w == to:
        return t
    v = t.unflatten(dim, (blocks, w))
    shape = list(v.shape)
    shape[dim + 1] = to
    out = t.new_zeros(shape)
    out.narrow(dim + 1, 0, w).copy_(v)
    return out.flatten(dim, dim + 1)


def pad_runs(tensors: dict, runs: dict, to: int) -> dict:
    """``tensors`` with the lane runs ``runs[key]`` of each, ``((dim,
    blocks), …)``, widened to ``to`` lanes by zeros (:func:`pad_lanes`);
    the keys without runs as they are."""
    out = {}
    for key, t in tensors.items():
        for dim, blocks in runs.get(key, ()):
            t = pad_lanes(t, dim, blocks, to)
        out[key] = t
    return out


def unpad_lanes(t: torch.Tensor, dim: int, blocks: int, w: int):
    """The inverse of :func:`pad_lanes`: the first ``w`` lanes of each of
    the ``blocks`` runs of axis ``dim``, contiguous."""
    dim %= t.dim()
    if t.shape[dim] == blocks * w:
        return t
    to = t.shape[dim] // blocks
    return t.unflatten(dim, (blocks, to)).narrow(dim + 1, 0, w) \
        .flatten(dim, dim + 1).contiguous()


def unpad_runs(tensors: dict, runs: dict, w: int) -> dict:
    """The inverse of :func:`pad_runs`: each run of ``runs[key]`` cut back
    to its first ``w`` lanes (:func:`unpad_lanes`); None stays None."""
    out = {}
    for key, t in tensors.items():
        for dim, blocks in runs.get(key, ()) if t is not None else ():
            t = unpad_lanes(t, dim, blocks, w)
        out[key] = t
    return out


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def null_or_ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


SECOND_ORDER_MISSING = (
    "a second derivative through {} (force training) is not ported yet "
    "(ROADMAP Queue 1 item 17, 'Training, the rest': the blocked ops' "
    "second order)")


def first_order_only(what: str, message: str = SECOND_ORDER_MISSING):
    """Decorator of an ``autograd.Function.backward`` that is not
    differentiable again (its cotangents come from kernels that have no
    derivative).  It runs the backward without a graph, as
    ``once_differentiable`` does, but where that would hang an error node
    on the outputs (which ``torch.autograd.grad`` to a weight prunes,
    dropping the higher-order terms without a word), it raises
    ``NotImplementedError`` (``message`` naming ``what``) as soon as the
    backward runs under ``create_graph`` with a saved input or the
    incoming cotangent taking a gradient.  A call without ``create_graph``
    (MD, a force pass) is unaffected."""
    def wrap(backward):
        @functools.wraps(backward)
        def first_order(ctx, *grads):
            if torch.is_grad_enabled() and any(
                    t is not None and t.requires_grad
                    for t in ctx.saved_tensors + grads):
                raise NotImplementedError(message.format(what))
            with torch.no_grad():
                return backward(ctx, *grads)
        return first_order
    return wrap


def kernel_dtype(dtype) -> bool:
    """Whether the kernels take operands of ``dtype`` (float32 only).  The
    models' fused branches ask it and take the plain chains otherwise, as
    JAX's do."""
    return dtype == torch.float32


class remat_recompute:
    """The context of a remat region's recompute in the backward
    (``models/tensornet.py::remat_call``): the neighbour sums in it skip
    their work (:func:`neighbour_sum_out`).  Re-entrant: a region that
    the force pass's second backward unpacks again is recomputed again
    under the same context object."""

    _state = threading.local()

    def __enter__(self):
        self._outer = getattr(self._state, "on", False)
        self._state.on = True

    def __exit__(self, *exc):
        self._state.on = self._outer

    @classmethod
    def active(cls) -> bool:
        return getattr(cls._state, "on", False)


def neighbour_sum_out(compute, feats9):
    """A neighbour sum's ``[N, 9F]`` output: ``compute()``, or zeros and no
    launch in a remat recompute.  There the region's output, which the
    forward kept, is the sum's; nothing in the region reads the sum's
    value after it, and its backward needs only its saved inputs.  So the
    sum runs once a step with remat as without, as JAX's policy
    ``save_only_these_names("pns_out")`` keeps its output."""
    if remat_recompute.active():
        return torch.zeros_like(feats9)
    return compute()
