"""ctypes bindings for the native batch packer (``csrc/packer.cpp``;
counterpart of ``torchmdnet_tpu/data/_native.py``).

The library is built with ``g++ -O3 -shared -fPIC`` the first time a
batch is packed, into ``_build/`` beside the CUDA libraries, keyed by a
hash of the source and the flags.  A failed build raises with the
compiler's message: there is no quiet numpy fallback (the JAX package
falls back where its build fails).  ``CXX`` names another compiler.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "packer.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_LOCK = threading.Lock()
P = ctypes.c_void_p
I64 = ctypes.c_int64


def library_path(source=None) -> Path:
    source = Path(source or SOURCE)
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"packer-{digest[:16]}.so"


def build(source=None) -> Path:
    """Compile ``source`` (the packer) unless its library exists; returns
    the library's path.  Raises ``RuntimeError`` with the compiler's output
    when the build fails."""
    source = Path(source or SOURCE)
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as exc:
        raise RuntimeError(f"packer build failed: {' '.join(cmd)}: "
                           f"{exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"packer build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    """The packer library, built and bound on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.pack_from_memmap.restype = I64
            lib.pack_from_memmap.argtypes = [I64] + [P] * 8 + [I64, I64] \
                + [P] * 8
            lib.pack_batch.restype = I64
            lib.pack_batch.argtypes = [I64] + [P] * 5 + [I64, I64] + [P] * 6
            _LIB = lib
    return _LIB


def _vp(arr):
    return None if arr is None else arr.ctypes.data_as(P)


def _outputs(max_atoms, max_mols, has):
    """The padded output buffers; ``has``: the optional fields wanted."""
    out = {"z": np.zeros(max_atoms, np.int32),
           "pos": np.zeros((max_atoms, 3), np.float32),
           "batch": np.full(max_atoms, max_mols, np.int32),
           "mol_mask": np.zeros(max_mols, np.uint8)}
    shapes = {"y": (max_mols, 1), "neg_dy": (max_atoms, 3),
              "q": (max_mols,), "pq": (max_atoms,)}
    for key in has:
        out[key] = np.zeros(shapes[key], np.float32)
    return out


def _finish(rc, out, max_atoms, max_mols):
    if rc < 0:
        raise ValueError(f"batch exceeds capacity (max_atoms={max_atoms}, "
                         f"max_mols={max_mols})")
    out["mol_mask"] = out["mol_mask"].astype(bool)
    return out


def pack_from_memmap(dataset, mol_ids, max_atoms, max_mols):
    """Pack the molecules ``mol_ids`` of a ``MemmappedDataset`` straight
    from its mapped files into one padded batch (the fields of
    ``collate.pad_samples``: ``y`` as float32 ``[max_mols, 1]``, ``q``
    float32, ghost atoms in segment ``max_mols``)."""
    lib = _load()
    mm, props = dataset.mmaps, dataset.properties
    mol_ids = np.ascontiguousarray(np.asarray(mol_ids, np.int64))
    has = [k for k in ("y", "neg_dy", "q", "pq") if k in props]
    out = _outputs(max_atoms, max_mols, has)
    rc = lib.pack_from_memmap(
        len(mol_ids), _vp(mol_ids), _vp(mm["idx"]), _vp(mm["z"]),
        _vp(mm["pos"]), *(_vp(mm.get(k)) if k in has else None
                          for k in ("y", "neg_dy", "q", "pq")),
        max_atoms, max_mols, _vp(out["z"]), _vp(out["batch"]),
        _vp(out["pos"]), *(_vp(out.get(k)) for k in ("y", "neg_dy", "q",
                                                     "pq")),
        _vp(out["mol_mask"]))
    return _finish(rc, out, max_atoms, max_mols)


def pack_batch_native(samples, max_atoms, max_mols):
    """The atom fields (``z``, ``pos``, ``batch``, ``mol_mask`` and, where
    every sample has them, ``neg_dy`` and ``pq``) of a list of samples,
    packed by the library (JAX ``pack_batch_native``)."""
    lib = _load()
    n_mols = len(samples)
    has = [k for k in ("neg_dy", "pq") if all(k in s for s in samples)]
    sizes = np.array([len(s["z"]) for s in samples], np.int64)
    arrays = {
        "z": [np.ascontiguousarray(np.asarray(s["z"], np.int64).reshape(-1))
              for s in samples],
        "pos": [np.ascontiguousarray(np.asarray(s["pos"], np.float32))
                for s in samples]}
    for key in has:
        arrays[key] = [np.ascontiguousarray(np.asarray(s[key], np.float32))
                       for s in samples]

    def pointers(key):
        if key not in arrays:
            return None
        table = (P * n_mols)(*(a.ctypes.data for a in arrays[key]))
        arrays[key + "_ptrs"] = table  # alive until the call returns
        return ctypes.cast(table, P)

    out = _outputs(max_atoms, max_mols, has)
    rc = lib.pack_batch(
        n_mols, _vp(sizes), pointers("z"), pointers("pos"),
        pointers("neg_dy"), pointers("pq"), max_atoms, max_mols,
        _vp(out["z"]), _vp(out["batch"]), _vp(out["pos"]),
        _vp(out.get("neg_dy")), _vp(out.get("pq")), _vp(out["mol_mask"]))
    return _finish(rc, out, max_atoms, max_mols)
