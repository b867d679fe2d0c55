"""Dense per-atom neighbor matrices.

Counterpart of ``torchmdnet_tpu/ops/neighbors.py``.  Row ``i`` of
``idx[N, K]`` holds the indices ``j`` of up to ``K`` neighbors in candidate
order (ascending ``j`` for the brute strategy; stencil cell, then rank in
cell for the cell strategy), valid slots first, with ``mask[N, K]``
marking them.  Padded slots point at the row's own atom, so gathers
through them stay in bounds.  An entry ``(i, k)`` is the directed edge
``i ← j`` with ``delta = pos[i] - pos[j]`` (minimum image), kept when
``dist < cutoff_upper`` and, for ``i != j``, ``dist >= cutoff_lower``.
An atom with more than ``K`` neighbors sets ``overflow`` (a device bool,
so a build never waits for the host).

The index build holds no gradient; :func:`neighbor_geometry` recomputes
the differentiable geometry from ``pos`` and a fixed index set.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from torchmdnet_tpu_torch.ops.message_passing import (
    gather_pair_deltas, reverse_slots)

# Elements of the [rows, candidates] work arrays built at once; bounds the
# build's transient memory at large N.
_BUILD_BLOCK = 1 << 24


class NeighborMatrix(NamedTuple):
    idx: torch.Tensor  # [N, K] int64; padded slots point at own row
    mask: torch.Tensor  # [N, K] bool
    num_neighbors: Optional[torch.Tensor] = None  # [N] true count (may exceed K)
    overflow: Optional[torch.Tensor] = None  # [] bool
    rev_slot: Optional[torch.Tensor] = None  # [N, K] slot of n in row idx[n,k]


def wrap_deltas(delta, box):
    """Triclinic minimum-image reduction of ``delta [..., 3]``; ``box``
    broadcastable ``[..., 3, 3]`` with rows (a, b, c) in reduced form."""
    a, b, c = box[..., 0, :], box[..., 1, :], box[..., 2, :]
    delta = delta - torch.round(delta[..., 2] / c[..., 2])[..., None] * c
    delta = delta - torch.round(delta[..., 1] / b[..., 1])[..., None] * b
    delta = delta - torch.round(delta[..., 0] / a[..., 0])[..., None] * a
    return delta


def _compact(adj, cand, k_max):
    """Keep the first ``k_max`` valid candidates of each row, in candidate
    order.  ``adj``/``cand``: [rows, C].  Returns ``(idx1, count)`` with
    ``idx1 = atom index + 1`` on kept slots and 0 elsewhere."""
    rows, width = adj.shape
    rank = torch.cumsum(adj, dim=1) - 1
    keep = adj & (rank < k_max)
    row_ids = torch.arange(rows, device=adj.device)[:, None]
    # rejected candidates all land on one spare slot past the end
    flat = torch.where(keep, row_ids * k_max + rank, rows * k_max)
    idx1 = torch.zeros(rows * k_max + 1, dtype=torch.long, device=adj.device)
    idx1.scatter_(0, flat.reshape(-1), (cand.long() + 1).reshape(-1)
                  * keep.reshape(-1))
    return idx1[:-1].view(rows, k_max), adj.sum(dim=1)


def _finish(idx1, count, k_max, extra_overflow=None):
    n = idx1.shape[0]
    mask = idx1 > 0
    row = torch.arange(n, device=idx1.device)[:, None]
    idx = torch.where(mask, idx1 - 1, row)
    overflow = (count > k_max).any()
    if extra_overflow is not None:
        overflow = overflow | extra_overflow
    return NeighborMatrix(idx, mask, count, overflow, reverse_slots(idx, mask))


@torch.no_grad()
def brute_neighbor_matrix(pos, batch=None, *, k_max: int, cutoff_upper: float,
                          cutoff_lower: float = 0.0, loop: bool = False,
                          box=None, atom_mask=None) -> NeighborMatrix:
    """O(N²) neighbor matrix, row-blocked so the [rows, N] work arrays stay
    bounded."""
    n = pos.shape[0]
    dev = pos.device
    if batch is None:
        batch = torch.zeros(n, dtype=torch.long, device=dev)
    pos = pos.detach()
    cols = torch.arange(n, device=dev)
    block = max(1, _BUILD_BLOCK // max(n, 1))
    idx1s, counts = [], []
    for s in range(0, n, block):
        rows = torch.arange(s, min(n, s + block), device=dev)
        delta = pos[rows, None, :] - pos[None, :, :]
        if box is not None:
            delta = wrap_deltas(
                delta, box if box.dim() == 2 else box[batch[rows]][:, None])
        d2 = (delta * delta).sum(-1)
        is_self = rows[:, None] == cols[None, :]
        adj = d2 < cutoff_upper * cutoff_upper
        if cutoff_lower > 0.0:
            adj &= (d2 >= cutoff_lower * cutoff_lower) | is_self
        adj &= batch[rows, None] == batch[None, :]
        if not loop:
            adj &= ~is_self
        if atom_mask is not None:
            adj &= atom_mask[rows, None] & atom_mask[None, :]
        idx1, count = _compact(adj, cols.expand(len(rows), n), k_max)
        idx1s.append(idx1)
        counts.append(count)
    return _finish(torch.cat(idx1s), torch.cat(counts), k_max)


def pick_cell_grid(box_diag, cutoff: float, n_atoms: int,
                   capacity_factor: float = 2.5):
    """Choose ``(cells_per_dim, stencil, cell_capacity)`` minimising the
    candidate width ``(2S+1)³ · capacity``: finer cells with a wider ±S
    stencil cover the cutoff sphere more tightly at large cutoffs."""
    bd = np.asarray(box_diag, dtype=np.float64)
    best = None
    for s in (1, 2, 3, 4):
        dims = np.floor(bd * s / cutoff).astype(np.int64)
        dims = np.maximum(dims, 2 * s + 1)
        if np.any(bd / dims * s < cutoff):  # box too small for this S
            continue
        occ = n_atoms / float(np.prod(dims))
        cap = int(np.ceil(occ * capacity_factor)) + 8
        width = (2 * s + 1) ** 3 * cap
        if best is None or width < best[0]:
            best = (width, tuple(int(d) for d in dims), s, cap)
    if best is None:  # degenerate tiny box: single 27-stencil cell grid
        dims = np.maximum(np.floor(bd / cutoff).astype(np.int64), 3)
        occ = n_atoms / float(np.prod(dims))
        return (tuple(int(d) for d in dims), 1,
                int(np.ceil(occ * capacity_factor)) + 8)
    return best[1], best[2], best[3]


@torch.no_grad()
def cell_neighbor_matrix(pos, batch=None, *, k_max: int, cutoff_upper: float,
                         cutoff_lower: float = 0.0, loop: bool = False,
                         box=None, atom_mask=None, cell_capacity: int = 64,
                         cells_per_dim: Optional[tuple] = None,
                         stencil: int = 1,
                         column_partition: Optional[tuple] = None
                         ) -> NeighborMatrix:
    """O(N·(2S+1)³·capacity) neighbor matrix via sort-based binning into a
    dense ``[n_cells+1, capacity]`` table and a ±S cell stencil.  Requires
    an orthogonal ``box`` (its diagonal is used).  A cell holding more
    than ``cell_capacity`` atoms sets ``overflow``.

    ``column_partition`` (9 slot budgets, the grouped blocked tier; JAX
    ``neighbors.py:400-440``) splits the slot axis into one range per
    stencil xy-column ``(dx, dy)`` in ``ij`` order: the candidates of
    column ``g`` are the contiguous ``[g·3·capacity, (g+1)·3·capacity)``
    (the stencil runs dx slowest, then dy, then dz), and each group keeps
    its first ``column_partition[g]`` in candidate order, its empty slots
    pointing at the row itself.  A group that overflows its budget sets
    ``overflow``.  It needs ``stencil == 1`` and ``k_max ==
    sum(column_partition)``."""
    n = pos.shape[0]
    dev = pos.device
    if box is None:
        raise ValueError("cell strategy requires a box")
    if box.dim() == 3:
        box = box[0]
    if batch is None:
        batch = torch.zeros(n, dtype=torch.long, device=dev)
    box_diag = torch.diagonal(box).to(pos.dtype)
    if cells_per_dim is None:
        bd = box_diag.double().cpu().numpy()
        dims_np = np.maximum(np.floor(bd * stencil / cutoff_upper).astype(np.int64),
                             2 * stencil + 1)
        cells_per_dim = tuple(int(d) for d in dims_np)
    pos = pos.detach()
    nx, ny, nz = cells_per_dim
    n_cells = nx * ny * nz
    dims = torch.tensor([nx, ny, nz], dtype=torch.long, device=dev)

    frac = pos / box_diag
    frac = frac - torch.floor(frac)
    cell_xyz = torch.minimum((frac * dims).long().clamp_min(0), dims - 1)
    cell_id = (cell_xyz[:, 0] * ny + cell_xyz[:, 1]) * nz + cell_xyz[:, 2]
    if atom_mask is not None:
        cell_id = torch.where(atom_mask, cell_id, n_cells)  # ghosts: spare bin

    sorted_cell, order = torch.sort(cell_id, stable=True)
    seg_start = torch.searchsorted(sorted_cell, sorted_cell, right=False)
    rank = torch.arange(n, device=dev) - seg_start
    cell_count = torch.bincount(sorted_cell, minlength=n_cells + 1)
    cell_overflow = (cell_count[:n_cells] > cell_capacity).any()
    table = torch.full((n_cells + 1, cell_capacity), n, dtype=torch.long,
                       device=dev)
    in_cap = rank < cell_capacity
    table[torch.where(in_cap, sorted_cell, n_cells),
          rank.clamp(0, cell_capacity - 1)] = torch.where(in_cap, order, n)

    S = int(stencil)
    if column_partition is not None:
        column_partition = tuple(int(g) for g in column_partition)
        if S != 1 or len(column_partition) != 9:
            raise ValueError("column_partition needs the 3x3 stencil "
                             "(stencil=1) and 9 budgets")
        if k_max != sum(column_partition):
            raise ValueError(f"k_max={k_max} must equal sum(column_partition)"
                             f"={sum(column_partition)}")
    r = torch.arange(-S, S + 1, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    width = offs.shape[0] * cell_capacity
    table_safe = table.clamp_max(n - 1)
    block = max(1, _BUILD_BLOCK // width)
    idx1s, counts = [], []
    for s in range(0, n, block):
        rows = torch.arange(s, min(n, s + block), device=dev)
        ncell_xyz = (cell_xyz[rows, None, :] + offs[None]) % dims
        ncell_id = (ncell_xyz[..., 0] * ny + ncell_xyz[..., 1]) * nz + ncell_xyz[..., 2]
        cand = table[ncell_id].reshape(len(rows), width)
        cand_safe = table_safe[ncell_id].reshape(len(rows), width)
        d2 = torch.zeros(cand.shape, dtype=pos.dtype, device=dev)
        for c in range(3):
            dc = pos[rows, c, None] - pos[cand_safe, c]
            dc = dc - torch.round(dc / box_diag[c]) * box_diag[c]
            d2 = d2 + dc * dc
        is_self = cand_safe == rows[:, None]
        adj = (cand < n) & (d2 < cutoff_upper * cutoff_upper)
        if cutoff_lower > 0.0:
            adj &= (d2 >= cutoff_lower * cutoff_lower) | is_self
        if not loop:
            adj &= ~is_self
        adj &= batch[rows, None] == batch[cand_safe]
        if atom_mask is not None:
            adj &= atom_mask[rows, None] & atom_mask[cand_safe]
        if column_partition is None:
            idx1, count = _compact(adj, cand_safe, k_max)
        else:
            gsz = 3 * cell_capacity
            parts = [_compact(adj[:, g * gsz:(g + 1) * gsz],
                              cand_safe[:, g * gsz:(g + 1) * gsz], kg)
                     for g, kg in enumerate(column_partition)]
            idx1 = torch.cat([p[0] for p in parts], dim=1)
            count = adj.sum(dim=1)
            for (_, cg), kg in zip(parts, column_partition):
                cell_overflow = cell_overflow | (cg > kg).any()
        idx1s.append(idx1)
        counts.append(count)
    return _finish(torch.cat(idx1s), torch.cat(counts), k_max, cell_overflow)


def build_neighbor_matrix(pos, batch=None, *, strategy: str = "brute",
                          **kwargs) -> NeighborMatrix:
    """Strategy dispatch (``"brute"`` or ``"cell"``); the brute strategy
    drops the cell options, ``column_partition`` among them, as JAX
    ``neighbors.py:510-511`` does."""
    if strategy == "brute":
        for key in ("cell_capacity", "cells_per_dim", "stencil",
                    "column_partition"):
            kwargs.pop(key, None)
        return brute_neighbor_matrix(pos, batch, **kwargs)
    if strategy == "cell":
        return cell_neighbor_matrix(pos, batch, **kwargs)
    raise ValueError(f"Unknown neighbor strategy: {strategy!r}")


def neighbor_geometry(pos, nbr: NeighborMatrix, box=None, batch=None):
    """Differentiable ``(delta, dist)`` from positions and a fixed index set:
    ``delta[i,k] = pos[i] - pos[idx[i,k]]`` (minimum image), both zero on
    padded slots, with no NaN gradient at ``d = 0``.

    With ``nbr.rev_slot`` (every list build here fills it) the position gather
    is :func:`~torchmdnet_tpu_torch.ops.message_passing.gather_pair_deltas`,
    whose backward is a reverse gather instead of an atomic scatter (JAX
    ``:533-539``); without it, plain indexing.  That transpose is exact on
    a symmetric edge set: after a K overflow the forces differ from the
    indexing's exactly as the JAX package's do."""
    if nbr.rev_slot is not None:
        delta = gather_pair_deltas(pos, nbr.idx, nbr.rev_slot, nbr.mask)
    else:
        delta = pos[:, None, :] - pos[nbr.idx]
    if box is not None:
        if box.dim() == 3:
            if batch is None:
                batch = torch.zeros(pos.shape[0], dtype=torch.long,
                                    device=pos.device)
            box = box[batch][:, None]
        delta = wrap_deltas(delta, box)
    delta = torch.where(nbr.mask[..., None], delta, 0.0)
    d2 = (delta * delta).sum(-1)
    pos_d2 = d2 > 0.0
    dist = torch.where(pos_d2, torch.sqrt(torch.where(pos_d2, d2, 1.0)), 0.0)
    return delta, dist
