"""Cell-blocked sort and stencil-window pieces.

Counterpart of the parts of ``torchmdnet_tpu/ops/cell_blocks.py`` that a
Hopper card needs.  Atoms are sorted by (xy-column, fine z-bin) and each
column is padded with ghost rows to a multiple of ``cap``, so every block
of ``cap`` consecutive sorted rows lies in one column.  The model runs in
this sorted row space: the q-tier kernels (``ops/blocked_q.py``) gather
by the sorted-space neighbor index directly, and the windowed Coulomb
(``ops/windowed_coulomb.py``) walks, for each block and each of its
``(2S+1)²`` stencil columns, the exact row pieces whose z-bins lie within
the cutoff of the block's own z-range (up to two pieces with the
periodic z-wrap).

Not ported, because they are TPU workarounds: the 8-row flooring of
piece starts, the run packing and merge of ``_plan_impl`` (``:595-679``),
``edge_rel``/``rel``/``run_starts`` and the one-hot windows.  The
``rpc``/``rlh``/``nrp`` fields of the specs are TPU DMA budgets; they are
kept so that a JAX spec converts as ``CellBlockSpec(**spec._asdict())``,
and nothing here reads them.
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


class CellBlockSpec(NamedTuple):
    """Static sort geometry (same fields as the JAX spec)."""

    nx: int          # xy-columns (each at least the cutoff wide)
    ny: int
    nzf: int         # fine z-bins per column
    cap: int         # rows per block
    rpc: int         # TPU run budget per stencil column (unused here)
    rlh: int         # TPU rows per run (unused here)
    n_pad: int       # sorted row count: N plus per-column padding
    cut_bins: int    # cutoff in fine z-bins (ceil) + 1 slop bin
    precise: bool = False  # JAX tier flag; the port always computes f32
    col_slots: Optional[tuple] = None  # grouped tier: 9 slot budgets
    nrp: Optional[int] = None          # TPU packed-run budget (unused here)

    @property
    def n_blocks(self) -> int:
        return self.n_pad // self.cap


class StencilWindowSpec(NamedTuple):
    """A secondary ±S column stencil over a :class:`CellBlockSpec` sort
    (the windowed Coulomb's cutoff)."""

    s: int           # stencil radius in xy-columns
    cut_bins: int    # cutoff in fine z-bins (ceil) + 1 slop bin
    rpc: int = 0     # TPU run budget (unused here)
    rlh: int = 0     # TPU rows per run (unused here)

    @property
    def nsc(self) -> int:
        return (2 * self.s + 1) ** 2


class CellBlocks(NamedTuple):
    """The sort of one rebuild."""

    perm: torch.Tensor       # [n_pad] sorted row → original atom (N = ghost)
    inv_perm: torch.Tensor   # [N] original atom → sorted row
    mask_rows: torch.Tensor  # [n_pad] bool, real-atom rows


class StencilWindows(NamedTuple):
    """Exact row pieces ``[a1, e1)`` and ``[a2, e2)`` of each block's
    stencil columns, ``[n_blocks, (2S+1)²]`` int64 each."""

    a1: torch.Tensor
    e1: torch.Tensor
    a2: torch.Tensor
    e2: torch.Tensor


def make_cell_block_spec(box_diag, cutoff: float, n_atoms: int, *,
                         cap: int = 8, rpc: Optional[int] = None,
                         rlh: int = 8, zf_width: float = 1.0,
                         headroom: float = 1.35,
                         precise: bool = False) -> CellBlockSpec:
    """Static knobs from the box (port of ``make_cell_block_spec``,
    ``cell_blocks.py:150-193``; same arithmetic, same fields)."""
    bd = np.asarray(box_diag, dtype=np.float64)
    nx = max(int(bd[0] // cutoff), 1)
    ny = max(int(bd[1] // cutoff), 1)
    nzf = max(int(bd[2] / zf_width), 1)
    zbin = bd[2] / nzf
    cut_bins = int(np.ceil(cutoff / zbin)) + 1
    ncols = nx * ny
    rlh = max(int(np.ceil(rlh / 8) * 8), 8)
    npm = int(np.lcm(cap, 16))
    n_pad = int(np.ceil((n_atoms + ncols * cap) / npm) * npm)
    if rpc is None:
        rho_col = n_atoms / ncols / bd[2]
        span = cap / max(rho_col, 1e-9)
        z_ext = 2.0 * (cut_bins + 1) * zbin + span
        rows = z_ext * rho_col * headroom + 2 * 8
        rpc = max(int(np.ceil(rows / rlh)), 2)
    return CellBlockSpec(nx=nx, ny=ny, nzf=nzf, cap=cap, rpc=rpc, rlh=rlh,
                         n_pad=n_pad, cut_bins=cut_bins, precise=precise)


def tune_cell_block_spec(pos, box_diag, cutoff: float, *, cap: int = 8,
                         rlh: int = 8, zf_width: float = 1.0,
                         precise: bool = False,
                         column_slots: bool = False) -> CellBlockSpec:
    """The spec for ``pos``.  The JAX tuner measures the TPU run budgets
    (``rpc``, ``nrp``) on a probe plan; its sort fields (nx, ny, nzf, cap,
    n_pad, cut_bins) are those of :func:`make_cell_block_spec`, which is
    all the port reads.

    ``column_slots`` adds the grouped tier's per-stencil-column slot
    budgets ``col_slots``, measured as JAX ``cell_blocks.py:311-341``
    does: a cell list on the sorted positions with ``k_probe = min(
    ceil(occ·10) + 32, n_pad)`` slots, then :func:`tune_column_slots`.  It
    raises for an xy grid under 3×3 and for a probe that overflows."""
    pos = torch.as_tensor(pos, dtype=torch.float32)
    n_atoms = int(pos.shape[0])
    spec = make_cell_block_spec(box_diag, cutoff, n_atoms, cap=cap, rlh=rlh,
                                zf_width=zf_width, precise=precise)
    if not column_slots:
        return spec
    if spec.nx < 3 or spec.ny < 3:
        raise ValueError(
            f"column_slots needs a >=3x3 xy grid (got {spec.nx}x{spec.ny}): "
            "box too small for the grouped tier at this cutoff")
    from torchmdnet_tpu_torch.ops.neighbors import cell_neighbor_matrix

    bd = np.asarray(box_diag, dtype=np.float64)
    bd_t = torch.as_tensor(bd, dtype=torch.float32, device=pos.device)
    blocks = plan_cell_blocks(pos, bd_t, spec)
    am = blocks.mask_rows
    perm = torch.clamp(blocks.perm, max=n_atoms - 1)
    pos_s = torch.where(am[:, None], pos[perm], 0.0)
    nz = max(int(bd[2] // cutoff), 3)
    occ = n_atoms / (spec.nx * spec.ny * nz)
    probe = cell_neighbor_matrix(
        pos_s, k_max=min(int(np.ceil(occ * 10)) + 32, spec.n_pad),
        cutoff_upper=cutoff, loop=True, box=torch.diag(bd_t), atom_mask=am,
        cells_per_dim=(spec.nx, spec.ny, nz),
        cell_capacity=int(np.ceil(occ * 2.5)) + 8)
    if bool(probe.overflow):
        raise ValueError("column_slots probe neighbor list overflowed")
    return spec._replace(col_slots=tune_column_slots(
        spec, probe.idx, probe.mask, pos_s, bd_t))


def tune_column_slots(spec: CellBlockSpec, idx, mask, pos_s,
                      box_diag) -> tuple:
    """Per-stencil-column slot budgets of the grouped tier (JAX
    ``cell_blocks.py:408-439``) from a sorted-space neighbor matrix
    ``idx``/``mask [n_pad, K]`` on ``pos_s``: the most neighbors any row
    has in stencil column ``g`` (``(dx, dy)`` in ``ij`` order, around the
    column of the row's block), plus 2 slots of slack (JAX's default).

    Each budget is rounded up so that ``cap·budget`` is a multiple of 128,
    as JAX does: a Mosaic lane alignment of its grouped kernels that the
    port's kernels do not need, kept because it fixes K′ = Σ budgets, so a
    spec tuned here equals the JAX spec on the same positions and both
    packages build the same lists."""
    box_diag = torch.as_tensor(box_diag, dtype=pos_s.dtype,
                               device=pos_s.device)
    col_s, _ = _column_bins(pos_s, box_diag, spec)
    blk = torch.arange(spec.n_pad, device=pos_s.device) // spec.cap
    first = col_s.view(spec.n_blocks, spec.cap)[:, 0]
    cx, cy = first // spec.ny, first % spec.ny
    dx = torch.tensor([-1, -1, -1, 0, 0, 0, 1, 1, 1], device=pos_s.device)
    dy = torch.tensor([-1, 0, 1, -1, 0, 1, -1, 0, 1], device=pos_s.device)
    scol = (((cx[:, None] + dx) % spec.nx) * spec.ny
            + (cy[:, None] + dy) % spec.ny)
    eq = scol[blk][:, None, :] == col_s[idx][:, :, None]   # [n_pad, K, 9]
    maxima = (eq & mask[:, :, None]).sum(dim=1).max(dim=0).values.tolist()
    lane_q = lane_quantum(spec.cap)
    return tuple(int(math.ceil((m + 2) / lane_q)) * lane_q for m in maxima)


def lane_quantum(cap: int) -> int:
    """The step of a column budget: ``cap·budget`` stays a multiple of 128
    (:func:`tune_column_slots`)."""
    return max(128 // math.gcd(cap, 128), 1)


def tune_stencil_window_spec(pos, box_diag, spec: CellBlockSpec,
                             cutoff: float) -> StencilWindowSpec:
    """Stencil radius and z-cut for a secondary cutoff over ``spec``'s
    sort (port of ``cell_blocks.py:374-387``).  The port walks exact
    pieces, so it needs no run budget and ``pos`` is not read; the
    argument keeps the JAX signature."""
    bd = np.asarray(box_diag, dtype=np.float64)
    wx, wy = bd[0] / spec.nx, bd[1] / spec.ny
    s = max(int(np.ceil(cutoff / wx)), int(np.ceil(cutoff / wy)), 1)
    if 2 * s + 1 > min(spec.nx, spec.ny):
        raise ValueError(
            f"stencil 2S+1={2 * s + 1} exceeds the {spec.nx}x{spec.ny} xy "
            "grid (a wrapped stencil would double-count columns): box too "
            f"small for a direct-pair window at cutoff {cutoff}")
    cut_bins = int(np.ceil(cutoff / (bd[2] / spec.nzf))) + 1
    return StencilWindowSpec(s=s, cut_bins=cut_bins)


def _column_bins(pos, box_diag, spec: CellBlockSpec):
    """(column id, fine z-bin) per atom, periodic-wrapped, int64."""
    frac = pos / box_diag[None, :]
    frac = frac - torch.floor(frac)
    cx = torch.clamp((frac[:, 0] * spec.nx).to(torch.int64), 0, spec.nx - 1)
    cy = torch.clamp((frac[:, 1] * spec.ny).to(torch.int64), 0, spec.ny - 1)
    zf = torch.clamp((frac[:, 2] * spec.nzf).to(torch.int64), 0, spec.nzf - 1)
    return cx * spec.ny + cy, zf


def _sort(pos, box_diag, spec: CellBlockSpec):
    n = pos.shape[0]
    dev = pos.device
    ncols = spec.nx * spec.ny
    col, zf = _column_bins(pos, box_diag, spec)
    order = torch.sort(col * (spec.nzf + 1) + zf, stable=True).indices
    csize = torch.bincount(col, minlength=ncols)
    cal = (csize + spec.cap - 1) // spec.cap * spec.cap
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    cstart_pad = torch.cat([zero, torch.cumsum(cal, 0)])
    cstart = torch.cat([zero, torch.cumsum(csize, 0)])
    c_sorted = col[order]
    row_pad = cstart_pad[c_sorted] + (
        torch.arange(n, device=dev) - cstart[c_sorted])
    perm = torch.full((spec.n_pad,), n, dtype=torch.int64, device=dev)
    perm[row_pad] = order
    inv_perm = torch.empty(n, dtype=torch.int64, device=dev)
    inv_perm[order] = row_pad
    return col, zf, csize, cstart, cstart_pad, perm, inv_perm


@torch.no_grad()
def plan_cell_blocks(pos, box_diag, spec: CellBlockSpec) -> CellBlocks:
    """The sort of ``_plan_impl`` (``cell_blocks.py:498-514``): the same
    permutation as the JAX package's ``plan_cell_blocks``.  ``pos [N, 3]``
    in the original atom order, ``box_diag [3]``."""
    return plan_cell_blocks_and_windows(pos, box_diag, spec)[0]


@torch.no_grad()
def plan_stencil_windows(pos, box_diag, spec: CellBlockSpec,
                         wspec: StencilWindowSpec) -> StencilWindows:
    """Exact piece bounds of every block's ±S stencil columns over the
    same sort as :func:`plan_cell_blocks` (``cell_blocks.py:532-593``,
    before the 8-row floor).  A pair within the ``wspec`` cutoff lies in
    each other's pieces (|Δzbin| ≤ cut_bins − 1 and |Δcolumn| ≤ S); each
    row of a column appears in at most one piece."""
    return plan_cell_blocks_and_windows(pos, box_diag, spec, wspec)[1]


@torch.no_grad()
def plan_cell_blocks_and_windows(pos, box_diag, spec: CellBlockSpec,
                                 wspec: Optional[StencilWindowSpec] = None):
    """``(plan_cell_blocks(...), plan_stencil_windows(...))`` from one
    sort; the windows are None without ``wspec``."""
    if wspec is not None and 2 * wspec.s + 1 > min(spec.nx, spec.ny):
        raise ValueError(
            f"stencil 2S+1={2 * wspec.s + 1} exceeds grid "
            f"min(nx, ny)={min(spec.nx, spec.ny)}: wrapped duplicate columns")
    pos = pos.detach()
    dev = pos.device
    box_diag = torch.as_tensor(box_diag, dtype=pos.dtype, device=dev)
    n = pos.shape[0]
    col, zf, csize, cstart, cstart_pad, perm, inv_perm = _sort(pos, box_diag,
                                                               spec)
    mask_rows = perm < n
    blocks = CellBlocks(perm, inv_perm, mask_rows)
    if wspec is None:
        return blocks, None
    nzf, cap, nb = spec.nzf, spec.cap, spec.n_blocks
    ncols = spec.nx * spec.ny

    # bin_start[c, z]: first padded row of z-bin z in column c; z = nzf is
    # the end of the column's real rows
    bcount = torch.bincount(col * nzf + zf, minlength=ncols * nzf)
    bin_excl = torch.cumsum(bcount, 0) - bcount
    col_of_bin = torch.arange(ncols * nzf, device=dev) // nzf
    bin_start_flat = cstart_pad[col_of_bin] + (bin_excl - cstart[col_of_bin])
    col_real_end = cstart_pad[:-1] + csize
    bin_start = torch.cat([bin_start_flat.view(ncols, nzf),
                           col_real_end[:, None]], dim=1)

    # block z-range from the block's own real rows, widened by cut_bins
    perm_safe = torch.clamp(perm, max=n - 1)
    zf_b = torch.where(mask_rows, zf[perm_safe], -1).view(nb, cap)
    any_real = (zf_b >= 0).any(dim=1)
    zlo = torch.where(zf_b >= 0, zf_b, nzf).min(dim=1).values - wspec.cut_bins
    zhi = zf_b.max(dim=1).values + wspec.cut_bins
    zlo = torch.where(any_real, zlo, 0)[:, None]
    zhi = torch.where(any_real, zhi, -1)[:, None]

    # stencil columns, (dx, dy) in ij order, periodic
    col_b = torch.where(mask_rows, col[perm_safe], 0).view(nb, cap)[:, 0]
    cx, cy = col_b // spec.ny, col_b % spec.ny
    offs = torch.arange(-wspec.s, wspec.s + 1, device=dev)
    dx = offs.repeat_interleave(2 * wspec.s + 1)
    dy = offs.repeat(2 * wspec.s + 1)
    scol = ((cx[:, None] + dx) % spec.nx) * spec.ny + (cy[:, None] + dy) % spec.ny

    def bsz(z):
        zc = torch.clamp(z, 0, nzf).expand_as(scol)
        return bin_start[scol, zc]

    wrap_lo, wrap_hi = zlo < 0, zhi >= nzf
    wrapped = wrap_lo | wrap_hi
    whole = (wrap_lo & wrap_hi) | ((zhi - zlo + 1) >= nzf)
    lo_w = torch.where(wrap_lo, zlo + nzf, zlo)
    hi_w = torch.where(wrap_hi, zhi - nzf, zhi)
    base = bsz(torch.zeros_like(zlo))
    q_end = bsz(torch.full_like(zlo, nzf))
    a1 = bsz(lo_w)
    e1 = torch.where(wrapped, q_end, bsz(zhi + 1))
    a2 = torch.where(wrapped, base, e1)
    e2 = torch.where(wrapped, bsz(hi_w + 1), e1)
    a1 = torch.where(whole, base, a1)
    e1 = torch.where(whole, q_end, e1)
    a2 = torch.where(whole, e1, a2)
    e2 = torch.where(whole, e1, e2)
    empty = (zhi < zlo).expand_as(scol)
    a1, e1, a2, e2 = (torch.where(empty, base, t) for t in (a1, e1, a2, e2))
    return blocks, StencilWindows(a1, e1, a2, e2)


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm_safe, mask_rows, inv_perm):
        ctx.save_for_backward(inv_perm)
        shape = (-1,) + (1,) * (x.dim() - 1)
        return torch.where(mask_rows.view(shape), x[perm_safe], 0.0)

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        return g[inv_perm], None, None, None


def permute_rows(x, perm_safe, mask_rows, inv_perm):
    """Sorted-space rows ``out[r] = x[perm[r]]`` (0 on ghost rows) whose
    backward is the inverse gather ``g[inv_perm]``, not a scatter: exact
    because ``perm`` on the real rows is a bijection (``cell_blocks.py:
    205-223``)."""
    return _PermuteRows.apply(x, perm_safe, mask_rows, inv_perm)
