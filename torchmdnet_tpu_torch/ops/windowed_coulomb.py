"""Windowed direct-pair reaction-field Coulomb (kernels C and D of the port).

Counterpart of ``torchmdnet_tpu/ops/pallas_coulomb.py``: atoms are in the
cell-blocked sorted row space of ``ops/cell_blocks.py`` and each block of
``cap`` rows meets every partner row of its ±S stencil columns' exact
z-pieces directly, with no neighbor list:

    Φ_ic = Σ_{j ∈ window(i), 0 < d_ij < rc} G(d_ij) · b_jc
    E_i  = row_valid_i · Σ_c qw_c · b_ic · Φ_ic

with the reaction-field kernel ``G`` of ``ops/coulomb.py`` and
minimum-image deltas.  The backward stays row-local, as ``_wce_bwd``
(``:489-504``) folds it:

    S2_i   = Σ_j G(d_ij) · ct_j · b_j
    ∂pos_i = Σ_j G'(d_ij) · pd_ij · (ct_i + ct_j) / d_ij · Δ_ij,
             pd_ij = Σ_c qw_c b_ic b_jc
    ∂b_i   = qw ⊙ (ct_i · Φ_i + S2_i),   ∂qw_c = Σ_i ct_i · b_ic · Φ_ic

On CUDA tensors Φ and (∂pos, S2) are the hand-written kernels of
``csrc/windowed_coulomb.cu`` (their channel products on the tensor cores
in 3xTF32, float32-accurate) or raise; on CPU tensors they are the
per-block dense pair loops beside them.  Every channel count and stencil
radius the JAX op computes launches: channels go in chunks of at most 64
(:func:`wc_plan`), and the piece table is sized at launch
(:func:`wc_plan_error` names what still cannot).  Numerics: f32, what the
JAX package computes (its hi/lo bf16 split of every matmul is f32-grade).
"""

import ctypes
from typing import NamedTuple

import torch

from torchmdnet_tpu_torch.ops.cell_blocks import StencilWindows
from torchmdnet_tpu_torch.ops.coulomb import _rf_constants, g_and_grad
from torchmdnet_tpu_torch.ops.kernels import (
    F32, I32, I64, P, CudaSource, Kernel, first_order_only, ptr)
from torchmdnet_tpu_torch.ops.tc_tile import SMEM_LIMIT

SOURCE = CudaSource("windowed_coulomb.cu")
# n_blocks, cap, nsc, c, box, rc², rf constants
_TAIL = [I64, I32, I32, I32] + [F32] * 7
FORWARD = Kernel(SOURCE, "tmd_windowed_coulomb_fwd", [P] * 9 + _TAIL)
BACKWARD = Kernel(SOURCE, "tmd_windowed_coulomb_bwd", [P] * 12 + _TAIL)
NAMES = ("windowed_coulomb_fwd", "windowed_coulomb_bwd")
# window rows a stage, stages in the ring, warps a block, the most n8
# channel tiles a chunk, pairs of a warp step (csrc/windowed_coulomb.cu
# kP, kRing, kWarps, kMaxNt, kStepPairs)
_STAGE_ROWS, _RING, _WARPS, _MAX_NT, _STEP_PAIRS = 128, 3, 8, 8, 128
# Transient budget of one block chunk of the plain pair loops.
_PAIR_BUDGET_BYTES = 512 * 1024 * 1024


class WcPlan(NamedTuple):
    """How kernel C or D runs one cell block (one CUDA block each; the
    grid is the cell blocks).  Beside it the launch takes a scratch of the
    staged rows, :func:`rows_floats`."""

    mt: int      # 16-row tiles a pass over the block's rows (1 or 2)
    passes: int  # passes over the block's rows
    nt: int      # 8-channel tiles a chunk
    chunks: int  # channel chunks, each a walk of the whole window
    smem: int    # dynamic shared memory, bytes


def wc_plan(cap: int, c: int, nsc: int, bwd: bool = False) -> WcPlan:
    """Kernel C (or with ``bwd`` D) at ``cap`` rows a block, ``c``
    channels and ``nsc`` stencil columns, as ``windowed_coulomb.cu::
    wc_plan`` plans it: one or two 16-row tiles a pass, channels split
    into the fewest chunks of at most 64, each a multiple of 8; shared
    memory for the ring of three 128-row stages of (x, y, z, ct, the
    chunk's channels), in D the split (qw⊙b_i) rows (hi and lo, 8·nt + 4
    floats each), each of the eight warps' compacted pairs (128 floats,
    in D 256), the piece starts and offsets (2·nsc and 2·nsc + 1 ints)
    and eight warp sums."""
    mt = 2 if cap > 16 else 1
    passes = -(-cap // (16 * mt))
    chunks = -(-c // (8 * _MAX_NT))
    per_chunk = -(-c // chunks)
    nt = -(-per_chunk // 8)
    floats = _RING * _STAGE_ROWS * (4 + 8 * nt) \
        + (2 * 16 * mt * (8 * nt + 4) if bwd else 0) \
        + (2 if bwd else 1) * _STEP_PAIRS * _WARPS
    ints = 2 * (2 * nsc) + 1 + _WARPS
    return WcPlan(mt, passes, nt, chunks, 4 * floats + 4 * ints)


def wc_plan_error(cap: int, c: int, nsc: int):
    """Why kernels C and D cannot launch at ``cap`` rows a block, ``c``
    channels and ``nsc`` stencil columns, or None: at least one row and
    one channel, and the piece table of ``2·nsc`` pieces within a block's
    232,448 B of shared memory beside the ring and the pair scratch (up to
    ~6,400 stencil columns, S ≤ 39).  Any channel count and any ``cap``
    launch."""
    if cap < 1 or c < 1:
        return f"cap {cap} and channels {c} must be >= 1"
    smem = wc_plan(cap, c, nsc, bwd=True).smem
    if smem > SMEM_LIMIT:
        return (f"{nsc} stencil columns need {smem} B of shared memory "
                f"(> {SMEM_LIMIT})")
    return None


def kernel_attributes(cap: int, c: int, nsc: int, n_pad: int) -> dict:
    """What the launch plan and the compiler give kernels C and D at
    ``(cap, c, nsc)``: the plan's fields (:class:`WcPlan`), registers and
    local (spill) bytes a thread, static shared memory, resident blocks
    an SM, and the floats of the rows scratch at ``n_pad`` rows.  Builds
    the library; launches nothing."""
    lib = SOURCE.library()
    fn = lib.tmd_windowed_coulomb_attributes
    fn.argtypes = [I32] * 4 + [P]
    fn.restype = I32
    scratch = lib.tmd_windowed_coulomb_rows_floats
    scratch.argtypes = [I32, I64, I32, I32, I32]
    scratch.restype = I64
    attrs = {}
    for bwd, name in enumerate(NAMES):
        out = (ctypes.c_int * 9)()
        rc = fn(bwd, cap, c, nsc, ctypes.cast(out, P))
        if rc != 0:
            raise RuntimeError(
                f"tmd_windowed_coulomb_attributes: CUDA error {rc}")
        fields = WcPlan._fields + ("registers", "local_bytes",
                                   "static_smem", "blocks_per_sm")
        attrs[name] = dict(zip(fields, out))
        attrs[name]["rows_floats"] = scratch(bwd, n_pad, cap, c, nsc)
    return attrs


class CoulombWindows(NamedTuple):
    """Rebuild-time bundle the windowed head consumes (sorted space)."""

    a1: torch.Tensor         # [n_blocks, (2S+1)²] int64 exact piece bounds
    e1: torch.Tensor
    a2: torch.Tensor
    e2: torch.Tensor
    row_valid: torch.Tensor  # [n_pad] bool: real-atom rows
    box_diag: torch.Tensor   # [3] float32
    # the same three lengths on the host, read once per rebuild: kernels C
    # and D take them as arguments, so a launch waits for no device copy
    box_host: tuple

    @property
    def cap(self) -> int:
        return self.row_valid.shape[0] // self.a1.shape[0]


def make_coulomb_windows(win: StencilWindows, mask_rows,
                         box_diag) -> CoulombWindows:
    """Package a :func:`~torchmdnet_tpu_torch.ops.cell_blocks.
    plan_stencil_windows` plan and the real-row mask for
    :func:`windowed_coulomb_energy`."""
    box_diag = torch.as_tensor(box_diag, dtype=torch.float32,
                               device=mask_rows.device).reshape(3)
    return CoulombWindows(*(t.contiguous() for t in win),
                          mask_rows.contiguous(), box_diag.contiguous(),
                          tuple(float(v) for v in box_diag.tolist()))


def window_partners(cwin: CoulombWindows):
    """``(rows, live)``: every block's partner rows, its pieces in order
    and padded to the longest block, ``[n_blocks, W]``, and whether a slot
    holds a real atom."""
    a = torch.cat([cwin.a1, cwin.a2], dim=1)
    length = (torch.cat([cwin.e1, cwin.e2], dim=1) - a).clamp_min(0)
    end = torch.cumsum(length, dim=1)
    total = end[:, -1]
    w = int(total.max()) if total.numel() else 0
    slot = torch.arange(w, device=a.device).expand(a.shape[0], w).contiguous()
    piece = torch.searchsorted(end, slot, right=True).clamp(max=a.shape[1] - 1)
    rows = a.gather(1, piece) + slot - (end - length).gather(1, piece)
    live = slot < total[:, None]
    rows = torch.where(live, rows, 0)
    return rows, live & cwin.row_valid[rows]


def _pair_blocks(pos_s, cwin: CoulombWindows, rc: float, width: int):
    """Yield, per chunk of blocks, ``(rows_i, rows_j, delta, d, valid)``:
    block rows ``[cb·cap]``, partner rows ``[cb, W]``, minimum-image deltas
    ``[cb, cap, W, 3]``, safe distances and the pair mask ``[cb, cap, W]``."""
    rows, live = window_partners(cwin)
    nb, w = rows.shape
    cap = cwin.cap
    per_block = max(cap * w * (8 + width) + w * width, 1) * 4
    chunk = max(1, _PAIR_BUDGET_BYTES // per_block)
    bd = cwin.box_diag.to(pos_s.dtype)
    for s in range(0, nb, chunk):
        e = min(nb, s + chunk)
        rows_i = torch.arange(s * cap, e * cap, device=pos_s.device)
        rj = rows[s:e]
        delta = (pos_s[rows_i].view(e - s, cap, 1, 3)
                 - pos_s[rj].view(e - s, 1, w, 3))
        delta = delta - bd * torch.round(delta * (1.0 / bd))
        d2 = (delta * delta).sum(-1)
        valid = (live[s:e, None, :] & cwin.row_valid[rows_i].view(e - s, cap, 1)
                 & (d2 > 1e-12) & (d2 < rc * rc))
        yield rows_i, rj, delta, torch.sqrt(torch.where(valid, d2, 1.0)), valid


def wc_fwd_ref(pos_s, b_s, cwin: CoulombWindows, rc: float, eps: float,
               factor: float):
    """Plain kernel C: ``Φ [n_pad, C]`` (0 on ghost rows)."""
    c = b_s.shape[1]
    phi = b_s.new_zeros(b_s.shape)
    for rows_i, rj, _, d, valid in _pair_blocks(pos_s, cwin, rc, c):
        g = torch.where(valid, g_and_grad(d, rc, eps, factor)[0], 0.0)
        phi[rows_i] = torch.einsum("biw,bwc->bic", g, b_s[rj]).reshape(-1, c)
    return phi


def wc_bwd_ref(pos_s, b_s, ct, qw, cwin: CoulombWindows, rc: float,
               eps: float, factor: float):
    """Plain kernel D: ``(∂pos [n_pad, 3], S2 [n_pad, C])``."""
    c = b_s.shape[1]
    dpos = pos_s.new_zeros(pos_s.shape)
    s2 = b_s.new_zeros(b_s.shape)
    wb = qw[None, :] * b_s
    for rows_i, rj, delta, d, valid in _pair_blocks(pos_s, cwin, rc, c):
        nb = rj.shape[0]
        g, gp = g_and_grad(d, rc, eps, factor)
        g = torch.where(valid, g, 0.0)
        gp = torch.where(valid, gp, 0.0)
        bj, ctj = b_s[rj], ct[rj]
        s2[rows_i] = torch.einsum("biw,bwc->bic", g * ctj[:, None, :],
                                  bj).reshape(-1, c)
        pd = torch.einsum("bic,bwc->biw", wb[rows_i].view(nb, -1, c), bj)
        sc = gp * pd * (ct[rows_i].view(nb, -1, 1) + ctj[:, None, :]) / d
        dpos[rows_i] = (sc[..., None] * delta).sum(2).reshape(-1, 3)
    return dpos, s2


def check_operands(name, pos_s, b_s, cwin: CoulombWindows, extra: dict):
    """Raise unless the operands of a kernel C/D launch have the types,
    shapes and layout the kernels take and :func:`wc_plan_error` accepts
    their widths (on any device)."""
    dev = pos_s.device
    n_pad, c = b_s.shape
    nb, nsc = cwin.a1.shape
    tensors = dict(pos_s=pos_s, b_s=b_s, a1=cwin.a1, e1=cwin.e1, a2=cwin.a2,
                   e2=cwin.e2, row_valid=cwin.row_valid, **extra)
    shapes = dict(pos_s=(n_pad, 3), b_s=(n_pad, c), a1=(nb, nsc),
                  e1=(nb, nsc), a2=(nb, nsc), e2=(nb, nsc),
                  row_valid=(n_pad,), ct=(n_pad,), qw=(c,))
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        want = (torch.bool if key == "row_valid" else torch.int64
                if key in ("a1", "e1", "a2", "e2") else torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name}: {key} must be {want}, got {t.dtype}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")
    if nb * cwin.cap != n_pad:
        raise ValueError(f"{name}: {nb} blocks do not tile {n_pad} rows")
    why = wc_plan_error(cwin.cap, c, nsc)
    if why is not None:
        raise ValueError(f"{name}: {why}")


def rows_floats(n_pad: int, plan: WcPlan) -> int:
    """Floats of the rows scratch of a launch at ``n_pad`` rows
    (``windowed_coulomb.cu::rows_floats``): every row as a stage holds it,
    x, y, z, ct and one chunk's channels, for each chunk, and a stage of
    rows with no atom after each chunk's."""
    return plan.chunks * (n_pad + _STAGE_ROWS) * (4 + 8 * plan.nt)


def _launch_args(name, pos_s, b_s, cwin: CoulombWindows, extra: dict):
    """Check a kernel C/D launch; returns its rows scratch
    (:func:`rows_floats`), the pointers of the row mask and the piece
    bounds, and the scalar tail."""
    if pos_s.device.type != "cuda":
        raise ValueError(
            f"{name}: expects CUDA tensors, got {pos_s.device}")
    check_operands(name, pos_s, b_s, cwin, extra)
    nb, nsc = cwin.a1.shape
    n_pad, c = b_s.shape
    plan = wc_plan(cwin.cap, c, nsc, name == NAMES[1])
    rows = torch.empty(rows_floats(n_pad, plan), dtype=torch.float32,
                       device=pos_s.device)
    ptrs = [ptr(t) for t in (cwin.a1, cwin.e1, cwin.a2, cwin.e2)]
    return rows, ptr(cwin.row_valid), ptrs, [nb, cwin.cap, nsc, c,
                                             *cwin.box_host]


def wc_fwd_cuda(pos_s, b_s, cwin: CoulombWindows, rc: float, eps: float,
                factor: float):
    """Kernel C on CUDA tensors: ``Φ [n_pad, C]``."""
    rows, valid, ptrs, tail = _launch_args(NAMES[0], pos_s, b_s, cwin, {})
    k_rf, c_rf = _rf_constants(rc, eps)
    with torch.cuda.device(pos_s.device):
        phi = torch.empty_like(b_s)
        FORWARD(ptr(pos_s), valid, ptr(b_s), ptr(rows), *ptrs, ptr(phi),
                *tail, rc * rc, k_rf, c_rf, factor)
    return phi


def wc_bwd_cuda(pos_s, b_s, ct, qw, cwin: CoulombWindows, rc: float,
                eps: float, factor: float):
    """Kernel D on CUDA tensors: ``(∂pos [n_pad, 3], S2 [n_pad, C])``."""
    rows, valid, ptrs, tail = _launch_args(NAMES[1], pos_s, b_s, cwin,
                                           dict(ct=ct, qw=qw))
    k_rf, c_rf = _rf_constants(rc, eps)
    with torch.cuda.device(pos_s.device):
        dpos = torch.empty_like(pos_s)
        s2 = torch.empty_like(b_s)
        BACKWARD(ptr(pos_s), ptr(ct), valid, ptr(b_s), ptr(rows), *ptrs,
                 ptr(qw), ptr(s2), ptr(dpos), *tail, rc * rc, k_rf, c_rf,
                 factor)
    return dpos, s2


def wc_fwd(*args):
    """Kernel C on CUDA tensors, its plain version on CPU tensors."""
    return (wc_fwd_cuda if args[0].is_cuda else wc_fwd_ref)(*args)


def wc_bwd(*args):
    """Kernel D on CUDA tensors, its plain version on CPU tensors."""
    return (wc_bwd_cuda if args[0].is_cuda else wc_bwd_ref)(*args)


class _WindowedCoulomb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pos_s, qw, b_s, cwin, rc, eps, factor):
        phi = wc_fwd(pos_s.contiguous(), b_s.contiguous(), cwin, rc, eps,
                     factor)
        ctx.save_for_backward(pos_s, qw, b_s, phi)
        ctx.cwin, ctx.consts = cwin, (rc, eps, factor)
        rv = cwin.row_valid.to(phi.dtype)
        return (qw[None, :] * b_s * phi).sum(-1) * rv

    @staticmethod
    @first_order_only("the windowed Coulomb (kernels C and D)")
    def backward(ctx, ct):
        pos_s, qw, b_s, phi = ctx.saved_tensors
        rv = ctx.cwin.row_valid.to(phi.dtype)
        ct = (ct * rv).contiguous()
        dpos, s2 = wc_bwd(pos_s.contiguous(), b_s.contiguous(), ct,
                          qw.contiguous(), ctx.cwin, *ctx.consts)
        dpos = dpos * rv[:, None]
        db = (ct[:, None] * (qw[None, :] * phi) + qw[None, :] * s2) * rv[:, None]
        dqw = (ct[:, None] * b_s * phi).sum(0)
        return dpos, dqw, db, None, None, None, None


def windowed_coulomb_energy(pos_s, qw, b_s, cwin: CoulombWindows, rc: float,
                            eps: float, factor: float):
    """Per-row reaction-field Coulomb energy ``e [n_pad]`` over the stencil
    windows (see the module docstring); ghost rows get 0.  ``pos_s [n_pad,
    3]`` and ``b_s [n_pad, C]`` are in the sorted row space ``cwin`` was
    planned over.  Equals ``coulomb_cutoff_energy_w`` on a complete
    neighbor list."""
    return _WindowedCoulomb.apply(pos_s, qw, b_s, cwin, float(rc),
                                  float(eps), float(factor))
