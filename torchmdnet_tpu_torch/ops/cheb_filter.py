"""Chebyshev-tabulated edge filters (kernels 5 and 7 of the port).

Counterpart of ``torchmdnet_tpu/ops/pallas_cheb.py``: TensorNet's
three-layer edge MLP on the rbf is a smooth function family of the edge
distance alone, so the interaction fits it once at ``T`` Chebyshev nodes
(``coeffs [T, C]``) and evaluates it per edge slot as

    cheb_filter(coeffs, d, fm)[n, k, c] = fm[n, k] · Σ_j coeffs[j, c]·cos(j·θ)

with ``θ = arccos(clip(2(d − lo)/(hi − lo) − 1, −1, 1))``.  The backward
is analytic (``_cf_bwd``, ``:214-226``): the x-derivative of a series is
another series (``cheb_deriv_coeffs``), so

    ∂d      = cheb_filter_dot(cheb_deriv_coeffs(coeffs), d, fm, g)·2/(hi − lo)
    ∂coeffs = cheb_project(d, g·fm, T)

where ``cheb_filter_dot`` contracts the series with a cotangent without
storing the ``[N, K, C]`` filter, and ``cheb_project`` is the basis
transposed against a cotangent.  ``fm`` gets no gradient.

On CUDA tensors the filter and the filter-dot launch the hand-written
kernels of ``csrc/cheb_filter.cu`` (Pallas rows 5 and 7) or raise;
``cheb_project`` (row 6) has no kernel yet, so a coefficient gradient on
CUDA raises: force-only MD never asks for it (the weights are frozen).  On
CPU tensors all three run the plain versions, the θ form of the JAX jnp
fallback.  First order only.
"""

import torch
from torch.autograd.function import once_differentiable

from torchmdnet_tpu_torch.ops.cheb import cheb_deriv_coeffs, cheb_theta, cos_basis
from torchmdnet_tpu_torch.ops.kernels import (
    F32, I32, I64, P, CudaSource, Kernel, check_cuda_args, ptr)

SOURCE = CudaSource("cheb_filter.cu")
FILTER = Kernel(SOURCE, "tmd_cheb_filter", [P] * 4 + [I64, I32, I32, F32, F32])
FILTER_DOT = Kernel(SOURCE, "tmd_cheb_filter_dot",
                    [P] * 5 + [I64, I32, I32, F32, F32])
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


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


def cheb_project_ref(d, ctw, T: int, lo: float, hi: float):
    """Plain version of row 6 (``:190-193``):
    ``out[j, c] = Σ_{n,k} cos(j·θ[n,k])·ctw[n,k,c]`` → ``[T, C]``."""
    basis = _basis(d, T, lo, hi).reshape(-1, T)
    return basis.t() @ ctw.reshape(-1, ctw.shape[-1])


def _check(name, tensors, t, c):
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
    smem = 4 * (64 * (t + 4) + 32 * 128 + 128) + 4 * (2 * 256 + 16)
    if c % 4 or t < 1 or smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: channels {c} must be a multiple of 4 and "
                         f"{t} series terms must fit shared memory")
    return dev


def cheb_filter_cuda(coeffs, d, fmask, lo: float, hi: float):
    """Kernel 5 on CUDA tensors: returns ``[*d.shape, C]``."""
    t, c = coeffs.shape
    dev = _check("cheb_filter", dict(d=d, fmask=fmask, coeffs=coeffs), t, c)
    out = torch.empty(tuple(d.shape) + (c,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        FILTER(ptr(d), ptr(fmask), ptr(coeffs), ptr(out), d.numel(), t, c,
               lo, hi)
    return out


def cheb_filter_dot_cuda(coeffs, d, fmask, ct, lo: float, hi: float):
    """Kernel 7 on CUDA tensors: returns ``d.shape``."""
    t, c = coeffs.shape
    dev = _check("cheb_filter_dot",
                 dict(d=d, fmask=fmask, coeffs=coeffs, ct=ct), t, c)
    out = torch.empty(d.shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        FILTER_DOT(ptr(d), ptr(fmask), ptr(coeffs), ptr(ct), ptr(out),
                   d.numel(), t, c, lo, hi)
    return out


def filter_fwd(*args):
    """Kernel 5 for CUDA tensors, its plain version for CPU tensors."""
    return (cheb_filter_cuda if args[1].is_cuda else cheb_filter_ref)(*args)


def cheb_filter_dot(coeffs, d, fmask, ct, lo: float, hi: float):
    """``fmask · Σ_c (Σ_j coeffs[j]·T_j(x(d)))[c]·ct[..., c]`` →
    ``d.shape``, without a gradient of its own: kernel 7 for CUDA
    tensors, its plain version for CPU tensors."""
    return (cheb_filter_dot_cuda if d.is_cuda else cheb_filter_dot_ref)(
        coeffs, d, fmask, ct, lo, hi)


def cheb_project(d, ctw, T: int, lo: float, hi: float):
    """``[T, C]`` projection of ``ctw`` on the basis (the coefficient
    gradient); CPU tensors only until row 6 has its kernel."""
    if d.is_cuda:
        raise NotImplementedError(
            "cheb_project (the coefficient gradient, Pallas row 6) has no "
            "CUDA kernel yet (ROADMAP Queue 1, 'Training')")
    return cheb_project_ref(d, ctw, T, lo, hi)


class _ChebFilter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coeffs, d, fmask, lo, hi):
        ctx.save_for_backward(coeffs, d, fmask)
        ctx.lo, ctx.hi = lo, hi
        return filter_fwd(coeffs, d, fmask, lo, hi)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        coeffs, d, fmask = ctx.saved_tensors
        lo, hi = ctx.lo, ctx.hi
        g = g.contiguous()
        dcoeffs = dd = None
        if ctx.needs_input_grad[1]:
            dser = cheb_deriv_coeffs(coeffs).contiguous()
            dd = cheb_filter_dot(dser, d, fmask, g, lo, hi) * (2.0 / (hi - lo))
        if ctx.needs_input_grad[0]:
            dcoeffs = cheb_project(d, g * fmask[..., None], coeffs.shape[0],
                                   lo, hi)
        return dcoeffs, dd, None, None, None


def cheb_filter(coeffs, d, fmask, lo: float, hi: float):
    """``fmask · Σ_j coeffs[j]·T_j(x(d))`` → ``[*d.shape, C]`` (see the
    module docstring); ``fmask`` is a float mask that is 0 wherever the
    filter must not contribute."""
    return _ChebFilter.apply(coeffs.contiguous(), d.contiguous(),
                             fmask.contiguous(), float(lo), float(hi))
