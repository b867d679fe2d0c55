"""Radial basis expansion and cutoff function.

Counterpart of ``torchmdnet_tpu/ops/rbf.py`` (Gaussian and expnorm
smearing and the cosine cutoff; reference ``torchmdnet/models/utils.py:
316-407, 500-528``).
"""

import math

import numpy as np
import torch


def cosine_cutoff(dist, cutoff_upper: float, cutoff_lower: float = 0.0):
    """Cosine switching function, 1 at the (lower) cutoff → 0 at the upper;
    zero outside ``(lower, upper)``."""
    if cutoff_lower > 0.0:
        c = 0.5 * (torch.cos(
            math.pi * (2.0 * (dist - cutoff_lower)
                       / (cutoff_upper - cutoff_lower) + 1.0)) + 1.0)
        return c * (dist < cutoff_upper) * (dist > cutoff_lower)
    c = 0.5 * (torch.cos(dist * (math.pi / cutoff_upper)) + 1.0)
    return c * (dist < cutoff_upper)


def gauss_rbf(dist, offset, coeff):
    """Gaussian smearing ``exp(coeff · (d − offset)²)``; ``dist [...]`` →
    ``[..., R]`` (``offset [R]``, ``coeff`` a scalar or ``[R]``)."""
    d = dist[..., None] - offset
    return torch.exp(coeff * d * d)


def gauss_initial_params(cutoff_lower, cutoff_upper, num_rbf):
    """Offsets evenly spaced over the cutoff range and
    ``coeff = −0.5 / Δ²`` (reference ``models/utils.py:330-340``),
    float32."""
    offset = np.linspace(cutoff_lower, cutoff_upper, num_rbf,
                         dtype=np.float32)
    coeff = np.float32(-0.5) / (offset[1] - offset[0]) ** 2
    return torch.from_numpy(offset), torch.tensor(coeff, dtype=torch.float32)


def expnorm_rbf(dist, means, betas, alpha: float, cutoff_upper: float,
                cutoff_lower: float = 0.0):
    """``f_k(d) = cutoff(d) · exp(-β_k (exp(α(lower - d)) - μ_k)²)`` with the
    window ``CosineCutoff(0, upper)``; ``dist [...]`` → ``[..., R]``."""
    d = dist[..., None]
    window = cosine_cutoff(d, cutoff_upper, 0.0)
    arg = torch.exp(alpha * (cutoff_lower - d)) - means
    return window * torch.exp(-betas * arg * arg)


def expnorm_initial_params(cutoff_lower, cutoff_upper, num_rbf):
    """PhysNet defaults (reference ``models/utils.py:382-395``), float32."""
    start_value = math.exp(-cutoff_upper + cutoff_lower)
    means = np.linspace(start_value, 1.0, num_rbf).astype(np.float32)
    beta = (2.0 / num_rbf * (1.0 - start_value)) ** -2
    betas = np.full((num_rbf,), beta, np.float32)
    return torch.from_numpy(means), torch.from_numpy(betas)
