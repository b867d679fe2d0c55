"""Cartesian rank-2 tensor algebra on compact irreps.

Counterpart of ``torchmdnet_tpu/ops/tensor_algebra.py``.  A tensor field is
stored as its irreducible parts:

* ``I`` ``[N, F]``: scalar part (the tensor is ``I·𝟙``);
* ``A`` ``[N, 3, F]``: axial vector of the antisymmetric part;
* ``S`` ``[N, 5, F]``: symmetric-traceless part as ``(xx, xy, xz, yy, yz)``
  with ``zz = -(xx + yy)``.
"""

from typing import NamedTuple

import torch


class Irreps(NamedTuple):
    I: torch.Tensor  # [N, F]
    A: torch.Tensor  # [N, 3, F]
    S: torch.Tensor  # [N, 5, F]


def vector_to_skewtensor(vec):
    """Axial vector ``[..., 3, F]`` → skew tensor ``[..., 3, 3, F]``."""
    zero = torch.zeros_like(vec[..., 0, :])
    vx, vy, vz = vec[..., 0, :], vec[..., 1, :], vec[..., 2, :]
    rows = torch.stack([zero, -vz, vy, vz, zero, -vx, -vy, vx, zero], dim=-2)
    return rows.reshape(vec.shape[:-2] + (3, 3) + vec.shape[-1:])


def skewtensor_to_vector(t):
    """Skew tensor ``[..., 3, 3, F]`` → axial vector ``[..., 3, F]``."""
    return 0.5 * torch.stack([
        t[..., 2, 1, :] - t[..., 1, 2, :],
        t[..., 0, 2, :] - t[..., 2, 0, :],
        t[..., 1, 0, :] - t[..., 0, 1, :],
    ], dim=-2)


def compose_tensor(irr: Irreps):
    """Compact irreps → full tensor ``[..., 3, 3, F]``."""
    I, A, S = irr
    eye = torch.eye(3, dtype=I.dtype, device=I.device)
    full = I[..., None, None, :] * eye[..., None]
    full = full + vector_to_skewtensor(A)
    sxx, sxy, sxz, syy, syz = (S[..., c, :] for c in range(5))
    szz = -(sxx + syy)
    srows = torch.stack([sxx, sxy, sxz, sxy, syy, syz, sxz, syz, szz],
                        dim=-2).reshape(S.shape[:-2] + (3, 3) + S.shape[-1:])
    return full + srows


def decompose_tensor(t) -> Irreps:
    """Full tensor ``[..., 3, 3, F]`` → compact irreps."""
    I = (t[..., 0, 0, :] + t[..., 1, 1, :] + t[..., 2, 2, :]) / 3.0
    A = skewtensor_to_vector(t)

    def sym(a, b):
        return 0.5 * (t[..., a, b, :] + t[..., b, a, :])

    S = torch.stack([t[..., 0, 0, :] - I, sym(0, 1), sym(0, 2),
                     t[..., 1, 1, :] - I, sym(1, 2)], dim=-2)
    return Irreps(I, A, S)


def irreps_norm2(irr: Irreps):
    """Squared Frobenius norms of the three parts, each ``[..., F]``:
    ‖I·𝟙‖² = 3I², ‖A_skew‖² = 2|a|², ‖S‖² = 2(xx²+xy²+xz²+yy²+yz²+xx·yy)."""
    I, A, S = irr
    nI = 3.0 * I * I
    nA = 2.0 * torch.sum(A * A, dim=-2)
    sxx, sxy, sxz, syy, syz = (S[..., c, :] for c in range(5))
    nS = (sxx * sxx + syy * syy + (sxx + syy) ** 2
          + 2.0 * (sxy * sxy + sxz * sxz + syz * syz))
    return nI, nA, nS


def irreps_norm3(irr: Irreps):
    """Concatenated per-part squared norms ``[..., 3F]``."""
    return torch.cat(irreps_norm2(irr), dim=-1)


def tensor_frobenius_norm2(irr: Irreps):
    """‖X‖² of the composed tensor per (node, channel): ``[..., F]``."""
    nI, nA, nS = irreps_norm2(irr)
    return nI + nA + nS


def _matmul_3x3(y, m):
    """Per-(node, channel) 3×3 product of ``[..., 3, 3, F]`` tensors, as one
    broadcast multiply and a sum over the inner index (an einsum would
    batch millions of 3×3 matrix products)."""
    return (y.unsqueeze(-2) * m.unsqueeze(-4)).sum(-3)


def tensor_matmul_o3(y, m):
    """O(3)-equivariant product ``Y·M + M·Y``."""
    return _matmul_3x3(y, m) + _matmul_3x3(m, y)


def tensor_matmul_so3(y, m):
    """SO(3)-equivariant product ``Y·M``."""
    return _matmul_3x3(y, m)
