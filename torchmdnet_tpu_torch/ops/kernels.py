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
import hashlib
import os
import shutil
import subprocess
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


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def null_or_ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())
