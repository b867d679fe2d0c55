"""Chebyshev-tabulated edge filters (kernels 5 and 7 and row 6 of the port).

Counterpart of ``torchmdnet_tpu/ops/pallas_cheb.py``: TensorNet's
three-layer edge MLP on the rbf is a smooth function family of the edge
distance alone, so the interaction fits it once at ``T`` Chebyshev nodes
(``coeffs [T, C]``) and evaluates it per edge slot as

    cheb_filter(coeffs, d, fm)[n, k, c] = fm[n, k] · Σ_j coeffs[j, c]·cos(j·θ)

with ``θ = arccos(clip(2(d − lo)/(hi − lo) − 1, −1, 1))``.  The backward
is analytic and composes the three ops as the JAX custom VJPs do
(``_cf_bwd`` ``:214-229``, ``_cfd_bwd`` ``:279-295``, ``_cp_bwd``
``:310-319``); each is a ``torch.autograd.Function`` whose backward calls
the others' ``apply``, so every order of derivative exists:

    cheb_filter:      ∂d      = cheb_filter_dot(D·coeffs, d, fm, g)·2/(hi − lo)
                      ∂coeffs = cheb_project(d, fm, g)
    cheb_filter_dot:  ∂ct     = cot ⊗ cheb_filter(coeffs, d, fm)
                      ∂d      = cheb_filter_dot(D·coeffs, d, fm, cot·ct)·2/(hi − lo)
                      ∂coeffs = cheb_project(d, fm, cot·ct)
    cheb_project:     ∂ct     = cheb_filter(g, d, fm)

where ``D·coeffs`` is ``cheb_deriv_coeffs``, ``cheb_filter_dot``
contracts the series with a cotangent without storing the ``[N, K, C]``
filter, and ``cheb_project(d, fm, ct)[j, c] = Σ fm·cos(j·θ)·ct[..., c]``
is the adjoint of the filter in its coefficients (the JAX op takes the
product ``fm·ct``; the weight is an argument here so that the kernel
skips the slots where it is 0).  ``fm`` gets no gradient anywhere, and
``cheb_project`` gives ``d`` none, as in JAX: the projection appears only
in parameter-gradient branches.

On CUDA tensors each op launches its hand-written kernel of
``csrc/cheb_filter.cu`` (Pallas rows 5, 7 and 6) or raises; on CPU
tensors it runs its plain version, the θ form of the JAX jnp fallback.
Kernels 5 and 7 form the series product on the tensor cores in 3xTF32
(``csrc/tc_tile.cuh``, float32-accurate), from a split copy of the series
in a scratch the wrapper allocates (:func:`image_floats`); each block owns
a span of 256 slots (:func:`launch_plan`).  Row 6 runs its product on the
tensor cores in 3xTF32 too, the slots as the reduction: a block owns a 64
× 128 output tile and a chunk of slots (:func:`project_chunks`), and a
second launch sums the chunks' partials in order.
"""

import ctypes

import torch

from torchmdnet_tpu_torch.ops.cheb import cheb_deriv_coeffs, cheb_theta, cos_basis
from torchmdnet_tpu_torch.ops.kernels import (
    F32, I32, I64, P, CudaSource, Kernel, check_cuda_args, ptr)
from torchmdnet_tpu_torch.ops.tc_tile import REGION, SMEM_LIMIT, image_floats

SOURCE = CudaSource("cheb_filter.cu")
FILTER = Kernel(SOURCE, "tmd_cheb_filter",
                [P] * 5 + [I64, I32, I32, F32, F32])
FILTER_DOT = Kernel(SOURCE, "tmd_cheb_filter_dot",
                    [P] * 6 + [I64, I32, I32, F32, F32])
PROJECT = Kernel(SOURCE, "tmd_cheb_project",
                 [P] * 5 + [I64, I32, I32, I32, F32, F32])
_TC_SPAN = 256  # slots a kernel 5 or 7 block owns (kSpan), a row 6 span
_PROJECT_WINDOW = 3072  # slots a row 6 block compacts at once (kProjectSlots)
# row 6 blocks wanted in flight an SM: two fit (shared memory, registers),
# and an H100 ran two 13% faster than one (the second hides the first's
# barrier and shared-memory latencies)
_PROJECT_BLOCKS_PER_SM = 2


def _basis(d, T, lo, hi):
    """``[..., T]`` basis ``cos(j·θ(d))``."""
    return cos_basis(cheb_theta(d, lo, hi), T)


def cheb_filter_ref(coeffs, d, fmask, lo: float, hi: float):
    """Plain version of kernel 5 (``pallas_cheb.py:162-167``):
    ``fm · basis(d) @ coeffs`` → ``[*d.shape, C]``."""
    attr = torch.matmul(_basis(d, coeffs.shape[0], lo, hi), coeffs)
    return attr * fmask[..., None]


def cheb_filter_dot_ref(coeffs, d, fmask, ct, lo: float, hi: float):
    """Plain version of kernel 7 (``:257-261``):
    ``fm · Σ_c (basis(d) @ coeffs)·ct`` → ``d.shape``."""
    g = torch.matmul(_basis(d, coeffs.shape[0], lo, hi), coeffs)
    return (g * ct).sum(-1) * fmask


def cheb_project_ref(d, fmask, ct, T: int, lo: float, hi: float):
    """Plain version of row 6 (``:190-193``, with ``ctw = fm·ct``):
    ``out[j, c] = Σ_{n,k} fm[n,k]·cos(j·θ[n,k])·ct[n,k,c]`` → ``[T, C]``."""
    basis = (_basis(d, T, lo, hi) * fmask[..., None]).reshape(-1, T)
    return basis.t() @ ct.reshape(-1, ct.shape[-1])


def tc_smem(dot: bool) -> int:
    """Dynamic shared memory of a kernel 5 (``dot`` False) or kernel 7
    launch: 1 KB to align the region, the region, θ and fm, kernel 7's
    [2, 64] warpgroup sums, then the span's live and dead offsets and the
    warp counts (the basis lives in registers)."""
    return 1024 + 4 * (REGION + 2 * 64 + (128 if dot else 0)) \
        + 4 * (2 * _TC_SPAN + 16)


def launch_plan(e: int) -> dict:
    """``(blocks, span, dynamic shared memory)`` of kernels 5 and 7 at
    ``e`` slots; block ``b`` owns the slots ``[b·span, b·span + span)``
    below ``e``."""
    blocks = -(-e // _TC_SPAN)
    return {"cheb_filter": (blocks, _TC_SPAN, tc_smem(False)),
            "cheb_filter_dot": (blocks, _TC_SPAN, tc_smem(True))}


def kernel_attributes(t: int, c: int) -> dict:
    """What the compiler and the launch give kernels 5 and 7 and row 6:
    registers and local (spill) bytes a thread, static and dynamic shared
    memory a block, resident blocks an SM, and for kernels 5 and 7 the
    floats of their split-series scratch at ``(t, c)``.  Builds the
    library; launches nothing."""
    out = (ctypes.c_int * 5)()
    lib = SOURCE.library()
    fn = lib.tmd_cheb_attributes
    fn.argtypes = [I32, P]
    fn.restype = I32
    lib.tmd_tc_image_floats.argtypes = [I32, I32]
    lib.tmd_tc_image_floats.restype = I32
    attrs = {}
    for row, name in ((5, "cheb_filter"), (7, "cheb_filter_dot"),
                      (6, "cheb_project")):
        rc = fn(row, ctypes.cast(out, P))
        if rc != 0:
            raise RuntimeError(f"tmd_cheb_attributes: CUDA error {rc}")
        attrs[name] = dict(zip(("registers", "local_bytes", "static_smem",
                                "dynamic_smem", "blocks_per_sm"), out))
        if row != 6:
            attrs[name]["image_floats"] = lib.tmd_tc_image_floats(t, c)
    return attrs


def _check(name, tensors, t, c, smem):
    """Raise unless every tensor is a contiguous, 16-byte aligned float32
    tensor of its shape on one CUDA device and the launch fits shared
    memory."""
    dev = tensors["d"].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expects CUDA tensors, got {dev}")
    check_cuda_args(name, tensors, dev)
    shape = tuple(tensors["d"].shape)
    want = dict(d=shape, fmask=shape, coeffs=(t, c), ct=shape + (c,))
    for key, ten in tensors.items():
        if tuple(ten.shape) != want[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(ten.shape)}, "
                             f"expected {want[key]}")
        if ten.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")
    if c % 4 or t < 1 or smem > SMEM_LIMIT:
        raise ValueError(f"{name}: channels {c} must be a multiple of 4, "
                         f"series terms {t} at least 1, and {smem} bytes of "
                         f"shared memory at most {SMEM_LIMIT}")
    return dev


def filter_tc(coeffs, d, fmask, ct, lo: float, hi: float):
    """Kernel 5 (``ct`` None: returns ``[*d.shape, C]``) or kernel 7
    (returns ``d.shape``) on CUDA tensors."""
    t, c = coeffs.shape
    dot = ct is not None
    tensors = dict(d=d, fmask=fmask, coeffs=coeffs)
    if dot:
        tensors["ct"] = ct
    dev = _check("cheb_filter_dot" if dot else "cheb_filter", tensors, t, c,
                 tc_smem(dot))
    out = torch.empty(tuple(d.shape) + (() if dot else (c,)),
                      dtype=torch.float32, device=dev)
    image = torch.empty(image_floats(t, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if dot:
            FILTER_DOT(ptr(d), ptr(fmask), ptr(coeffs), ptr(ct), ptr(out),
                       ptr(image), d.numel(), t, c, lo, hi)
        else:
            FILTER(ptr(d), ptr(fmask), ptr(coeffs), ptr(out), ptr(image),
                   d.numel(), t, c, lo, hi)
    return out


def cheb_filter_cuda(coeffs, d, fmask, lo: float, hi: float):
    """Kernel 5 on CUDA tensors: returns ``[*d.shape, C]``."""
    return filter_tc(coeffs, d, fmask, None, lo, hi)


def cheb_filter_dot_cuda(coeffs, d, fmask, ct, lo: float, hi: float):
    """Kernel 7 on CUDA tensors: returns ``d.shape``."""
    return filter_tc(coeffs, d, fmask, ct, lo, hi)


def project_smem() -> int:
    """Dynamic shared memory of a row 6 launch: 1 KB to align the planes,
    two stages of split ct planes (each 2 × 128 × 16 floats), a ring of 4
    raw ct stages (16 × 128 floats each), a window's θ, fm and slot offsets
    (3,072 slots, 12 a thread, each array with a 16-slot stage of pad) and
    the 8 warp counts (the basis lives in registers)."""
    window = _PROJECT_WINDOW + 16
    return 1024 + 4 * (2 * 2 * 128 * 16 + 4 * 16 * 128 + 3 * window) + 4 * 8


def project_chunks(e: int, t: int, c: int, sms: int = 132) -> list:
    """Row 6's chunks along the slots: the ``[first, end)`` 256-slot spans
    of each, the ⌈e/256⌉ spans cut evenly (chunk z from ⌊z·S/Z⌋) into
    about two blocks an SM (the most that fit) over the ``⌈C/128⌉ ×
    ⌈T/64⌉`` output tiles, at least one chunk, at most one a span (none
    without slots); a block walks its chunk 3,072 slots at a time, as the
    kernel cuts it."""
    spans = -(-e // _TC_SPAN)
    tiles = -(-c // 128) * -(-t // 64)
    z = min(spans, max(1, -(-_PROJECT_BLOCKS_PER_SM * sms // tiles)))
    return [(i * spans // z, (i + 1) * spans // z) for i in range(z)]


def project_plan(e: int, t: int, c: int, sms: int = 132) -> dict:
    """Row 6's launch at ``e`` slots: the grid ``(⌈C/128⌉, ⌈T/64⌉,
    chunks)``, dynamic shared memory, and the floats of the partial
    scratch (none with one chunk: the block writes the output)."""
    chunks = len(project_chunks(e, t, c, sms))
    return {"grid": (-(-c // 128), -(-t // 64), chunks),
            "smem": project_smem(),
            "partial_floats": chunks * t * c if chunks > 1 else 0}


def cheb_project_cuda(d, fmask, ct, T: int, lo: float, hi: float):
    """Row 6 on CUDA tensors: returns ``[T, C]``."""
    c = ct.shape[-1]
    dev = _check("cheb_project", dict(d=d, fmask=fmask, ct=ct), T, c,
                 project_smem())
    plan = project_plan(d.numel(), T, c, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    partial = torch.empty(max(plan["partial_floats"], 1), dtype=torch.float32,
                          device=dev)
    out = torch.empty((T, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        PROJECT(ptr(d), ptr(fmask), ptr(ct), ptr(partial), ptr(out),
                d.numel(), T, c, plan["grid"][2], lo, hi)
    return out


# The dispatch: the kernel for CUDA tensors, the plain version for CPU ones.
def filter_fwd(coeffs, d, fmask, lo, hi):
    return (cheb_filter_cuda if d.is_cuda else cheb_filter_ref)(
        coeffs, d, fmask, lo, hi)


def filter_dot_fwd(coeffs, d, fmask, ct, lo, hi):
    return (cheb_filter_dot_cuda if d.is_cuda else cheb_filter_dot_ref)(
        coeffs, d, fmask, ct, lo, hi)


def project_fwd(d, fmask, ct, T, lo, hi):
    return (cheb_project_cuda if d.is_cuda else cheb_project_ref)(
        d, fmask, ct, T, lo, hi)


class _ChebFilter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coeffs, d, fmask, lo, hi):
        ctx.save_for_backward(coeffs, d, fmask)
        ctx.lo, ctx.hi = lo, hi
        return filter_fwd(coeffs, d, fmask, lo, hi)

    @staticmethod
    def backward(ctx, g):
        coeffs, d, fmask = ctx.saved_tensors
        lo, hi = ctx.lo, ctx.hi
        g = g.contiguous()
        dcoeffs = dd = None
        if ctx.needs_input_grad[1]:
            dser = cheb_deriv_coeffs(coeffs).contiguous()
            dd = _ChebFilterDot.apply(dser, d, fmask, g, lo, hi) * (
                2.0 / (hi - lo))
        if ctx.needs_input_grad[0]:
            dcoeffs = _ChebProject.apply(d, fmask, g, coeffs.shape[0], lo, hi)
        return dcoeffs, dd, None, None, None


class _ChebFilterDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coeffs, d, fmask, ct, lo, hi):
        ctx.save_for_backward(coeffs, d, fmask, ct)
        ctx.lo, ctx.hi = lo, hi
        return filter_dot_fwd(coeffs, d, fmask, ct, lo, hi)

    @staticmethod
    def backward(ctx, cot):
        coeffs, d, fmask, ct = ctx.saved_tensors
        lo, hi = ctx.lo, ctx.hi
        need_c, need_d, _, need_ct = ctx.needs_input_grad[:4]
        dcoeffs = dd = dct = None
        if need_ct:
            dct = cot[..., None] * _ChebFilter.apply(coeffs, d, fmask, lo, hi)
        if need_c or need_d:
            cct = (cot[..., None] * ct).contiguous()
        if need_d:
            dser = cheb_deriv_coeffs(coeffs).contiguous()
            dd = _ChebFilterDot.apply(dser, d, fmask, cct, lo, hi) * (
                2.0 / (hi - lo))
        if need_c:
            dcoeffs = _ChebProject.apply(d, fmask, cct, coeffs.shape[0], lo,
                                         hi)
        return dcoeffs, dd, None, dct, None, None


class _ChebProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, fmask, ct, T, lo, hi):
        ctx.save_for_backward(d, fmask)
        ctx.lo, ctx.hi = lo, hi
        return project_fwd(d, fmask, ct, T, lo, hi)

    @staticmethod
    def backward(ctx, g):
        d, fmask = ctx.saved_tensors
        dct = None
        if ctx.needs_input_grad[2]:
            dct = _ChebFilter.apply(g.contiguous(), d, fmask, ctx.lo, ctx.hi)
        return None, None, dct, None, None, None


def cheb_filter_dot(coeffs, d, fmask, ct, lo: float, hi: float):
    """``fmask · Σ_c (Σ_j coeffs[j]·T_j(x(d)))[c]·ct[..., c]`` →
    ``d.shape``, differentiable in ``coeffs``, ``d`` and ``ct``."""
    return _ChebFilterDot.apply(coeffs.contiguous(), d.contiguous(),
                                fmask.contiguous(), ct.contiguous(),
                                float(lo), float(hi))


def cheb_project(d, fmask, ct, T: int, lo: float, hi: float):
    """``[T, C]``: ``Σ_{n,k} fmask·cos(j·θ(d))·ct[n, k, c]``, the
    coefficient gradient of :func:`cheb_filter`; differentiable in
    ``ct``."""
    return _ChebProject.apply(d.contiguous(), fmask.contiguous(),
                              ct.contiguous(), int(T), float(lo), float(hi))


def cheb_filter(coeffs, d, fmask, lo: float, hi: float):
    """``fmask · Σ_j coeffs[j]·T_j(x(d))`` → ``[*d.shape, C]`` (see the
    module docstring); ``fmask`` is a float mask that is 0 wherever the
    filter must not contribute."""
    return _ChebFilter.apply(coeffs.contiguous(), d.contiguous(),
                             fmask.contiguous(), float(lo), float(hi))
