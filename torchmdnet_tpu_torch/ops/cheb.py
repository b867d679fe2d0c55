"""Chebyshev series helpers of the θ-tabulated blocked q-tier.

Counterpart of ``cheb_nodes`` and ``cheb_fit_matrix``
(``torchmdnet_tpu/ops/cheb.py:25-37``) and of ``cheb_deriv_coeffs``
(``torchmdnet_tpu/ops/pallas_cheb.py:49-64``, not a kernel; here one
matrix product instead of an op per series term).  A smooth
function ``f`` on ``[lo, hi]`` sampled at the ``T`` first-kind nodes is
fitted as ``coeffs = P @ f(nodes)`` and evaluated at ``d`` as
``Σ_j coeffs_j · T_j(x)``, ``x = clip(2(d − lo)/(hi − lo) − 1, −1, 1)``,
``T_j(x) = cos(j·arccos x)``.
"""

import math

import torch


def cheb_nodes(T: int, lo: float, hi: float, dtype=torch.float32, device=None):
    """First-kind nodes mapped to ``[lo, hi]``, node order ``k = 0..T-1``."""
    k = torch.arange(T, dtype=dtype, device=device)
    x = torch.cos(math.pi * (k + 0.5) / T)
    return (x + 1.0) * 0.5 * (hi - lo) + lo


def cheb_fit_matrix(T: int, dtype=torch.float32, device=None):
    """``P [T, T]`` with ``coeffs = P @ f(cheb_nodes)`` (discrete cosine fit)."""
    k = torch.arange(T, dtype=dtype, device=device)
    j = torch.arange(T, dtype=dtype, device=device)[:, None]
    P = (2.0 / T) * torch.cos(math.pi * j * (k + 0.5) / T)
    P[0] *= 0.5
    return P


def cheb_deriv_matrix(T: int, dtype=torch.float32, device=None):
    """``D [T, T]`` with ``cheb_deriv_coeffs(c) = D @ c``: the recurrence
    ``c'_j = c'_{j+2} + 2(j+1)·c_{j+1}`` unrolled, ``D[j, m] = 2m`` for
    ``m > j`` with ``m − j`` odd, row 0 halved."""
    j = torch.arange(T, device=device)[:, None]
    m = torch.arange(T, device=device)[None, :]
    D = torch.where((m > j) & ((m - j) % 2 == 1), 2.0 * m, 0.0).to(dtype)
    D[0] *= 0.5
    return D


def cheb_deriv_coeffs(coeffs):
    """``[T, C]`` series → ``[T, C]`` series of ``d/dx`` (degree drops by
    one), as one product with :func:`cheb_deriv_matrix` (the JAX package
    unrolls the recurrence, one small op per term)."""
    T = coeffs.shape[0]
    return cheb_deriv_matrix(T, coeffs.dtype, coeffs.device) @ coeffs


def cheb_theta(d, lo: float, hi: float):
    """``θ = arccos(clip(2(d − lo)/(hi − lo) − 1, −1, 1))``, so that
    ``T_j = cos(j·θ)``."""
    x = torch.clamp(2.0 * (d - lo) / (hi - lo) - 1.0, -1.0, 1.0)
    return torch.arccos(x)


def cos_basis(theta, T: int):
    """``[..., T]`` basis ``cos(j·θ)``."""
    j = torch.arange(T, dtype=theta.dtype, device=theta.device)
    return torch.cos(theta[..., None] * j)
