"""TensorNet's cell-blocked message passing (Pallas rows 8-11 of the port).

Counterpart of the TensorNet ops of ``torchmdnet_tpu/ops/pallas_blocked_mp.py``
(``:302-1114``) over the sorted-space neighbor matrix of a cell-blocked
sort (``ops/cell_blocks.py``).  With ``feats9 = [I | A×3 | S×5]`` rows of
width ``9F`` and edge weights ``attr [N, K, 3F]`` whose block 0 weights
irrep I, block 1 the three A and block 2 the five S components:

    blocked_neighbor_sum(attr3f, feats9, idx, mask)       row 8
        msg[n] = Σ_k expand9(attr3f[n, k]) ⊙ feats9[idx[n, k]]
    blocked_dattr(g9, feats9, idx, mask)                  row 9
        dattr[n, k, w] = Σ_{d∈w} g9[n, d] ⊙ feats9[idx[n, k], d],
        exactly 0 on invalid slots
    blocked_neighbor_sum_cheb(coeffs, d, fm, feats9, idx, lo, hi)   row 10
        row 8 with attr = fm · Σ_t cos(t·θ)·coeffs[t], evaluated in the
        kernel: the [N, K, 3F] attr never reaches memory
    blocked_dd_cheb(dser, d, fm, g9, feats9, idx, lo, hi)           row 11
        dd[n, k] = fm · Σ_c dattr[n, k, c]·(Σ_t dser[t, c]·cos(t·θ)); the
        caller applies 2/(hi − lo)

with ``θ = arccos(clip(2(d − lo)/(hi − lo) − 1, −1, 1))``.  Only the slots
with ``mask`` (rows 8, 9) or ``fm ≠ 0`` (rows 10, 11) contribute, so the
same ops serve the ungrouped list and the grouped tier's column-
partitioned K′ list (``spec.col_slots``), whose empty group slots are
masked.  The JAX ops take ``rel``/``run_starts`` window offsets; the port
gathers by ``idx`` directly, and JAX's window runs, one-hot MXU gathers and
column-major grouped edge layout are TPU workarounds it does not need.

The differentiable wrappers mirror ``_make_blocked_ops`` (``:581-623``)
and ``_make_blocked_cheb_op`` (``:1063-1114``): the weights are
edge-symmetric, so the feature backward is the forward op applied to the
cotangent; ``dattr`` comes from row 9 and ``dd`` from row 11 times
``2/(hi − lo)``; ``coeffs`` gets a zero gradient (JAX's MD-only contract).
First order only, as in JAX.

Numerics: f32 throughout, what the JAX package computes with
``spec.precise=True``.  Its fast tier (the bench default) rounds the
window features and the basis dot to bf16 (~1e-3 relative,
``pallas_blocked_mp.py:24-34, 679-684``); the port does not reproduce
that rounding.

On CUDA tensors each op launches its kernel (``csrc/blocked_mp.cu``) or
raises; on CPU tensors it runs the plain version beside it, a row-chunked
gather chain.  Rows 8 and 9 give each warp one sorted row and 128-channel
group (row 9: and 32 of its slots) and read the neighbours' features
straight from memory (row 8 also attr; row 9 holds the row's g9 in
registers and writes every slot, zeros on the invalid ones); rows 10 and
11 give a block 4 sorted rows, compact their live slots, and form the
series product on the tensor cores in 3xTF32 (``csrc/tc_tile.cuh``,
float32-accurate; rows 8 and 9 are fp32 FMA), from a split copy of the
series in a scratch the wrapper allocates (:func:`tc_image_floats`).
:func:`launch_plan` holds the shared-memory sums the launches use.
"""

import ctypes

import torch

from torchmdnet_tpu_torch.ops.cheb import cheb_deriv_coeffs
from torchmdnet_tpu_torch.ops.cheb_filter import (
    cheb_filter_dot_ref, cheb_filter_ref)
from torchmdnet_tpu_torch.ops.kernels import (
    F32, I32, P, CudaSource, Kernel, first_order_only, lane_width,
    neighbour_sum_out, pad_runs, ptr, unpad_lanes)
from torchmdnet_tpu_torch.ops.message_passing import _pns_dattr, row_chunk
from torchmdnet_tpu_torch.ops.tc_tile import REGION, SMEM_LIMIT
from torchmdnet_tpu_torch.ops.tc_tile import image_floats as tc_image_floats

SOURCE = CudaSource("blocked_mp.cu")
SUM = Kernel(SOURCE, "tmd_blocked_sum", [P] * 5 + [I32] * 3)
DATTR = Kernel(SOURCE, "tmd_blocked_dattr", [P] * 5 + [I32] * 3)
SUM_CHEB = Kernel(SOURCE, "tmd_blocked_sum_cheb",
                  [P] * 7 + [I32] * 4 + [F32] * 2)
DD_CHEB = Kernel(SOURCE, "tmd_blocked_dd_cheb",
                 [P] * 8 + [I32] * 4 + [F32] * 2)
_ROWS = 4             # sorted rows a row 10 or 11 block owns (kTcRows)
_SUM_TASKS = 4        # warp tasks a row 8 or 9 block owns


def sum_cheb_smem(k: int, f: int) -> int:
    """Row 10: 1 KB to align the region, the region (the series ring,
    then the attr tile), the rows' accumulator, θ and fm, then neighbor
    rows, warp counts, row starts (padded to 8) and the compacted slots
    (the basis lives in registers)."""
    return 1024 + 4 * (REGION + _ROWS * 9 * f + 2 * 64) \
        + 4 * (64 + 16 + _ROWS * k)


def dd_cheb_smem(k: int, f: int) -> int:
    """Row 11: 1 KB to align the region, the region (the series ring,
    then the ct tile), the rows' g9, the [2, 64] warpgroup sums, θ and
    fm, then neighbor rows, slot rows, warp counts and the compacted
    slots."""
    return 1024 + 4 * (REGION + _ROWS * 9 * f + 4 * 64) \
        + 4 * (2 * 64 + 8 + _ROWS * k)


def sum_tasks(n: int, f: int) -> int:
    """Row 8's warp tasks at ``n`` sorted rows and ``F = f``: one per row
    and 128-channel group, task ``t`` = row · ⌈F/128⌉ + group."""
    return n * -(-f // 128)


def dattr_tasks(n: int, k: int, f: int) -> int:
    """Row 9's warp tasks at ``n`` sorted rows of ``k`` slots and ``F =
    f``: one per row, 128-channel group and 32-slot round, task ``t`` =
    (row · ⌈F/128⌉ + group) · ⌈K/32⌉ + round."""
    return sum_tasks(n, f) * -(-k // 32)


def launch_plan(n: int, k: int, f: int, t: int) -> dict:
    """Blocks and dynamic shared memory of rows 8-11 at ``n`` sorted rows
    of ``k`` slots, ``F = f``, ``T = t``.  A row 8 (row 9) block ``b`` owns
    the tasks ``[4b, 4b + 4)`` of :func:`sum_tasks` (:func:`dattr_tasks`)
    that exist (no shared memory); a row 10 or 11 block ``b`` the sorted
    rows ``[4b, 4b + 4)`` that exist."""
    blocks = -(-n // _ROWS)
    return {"blocked_mp_sum": (-(-sum_tasks(n, f) // _SUM_TASKS), 0),
            "blocked_mp_dattr": (-(-dattr_tasks(n, k, f) // _SUM_TASKS), 0),
            "blocked_mp_sum_cheb": (blocks, sum_cheb_smem(k, f)),
            "blocked_mp_dd_cheb": (blocks, dd_cheb_smem(k, f))}


def kernel_attributes(k: int, f: int, t: int) -> dict:
    """What the compiler and the launch give rows 8-11 at ``(k,
    f, t)``: registers and local (spill) bytes a thread, static and
    dynamic shared memory a block, resident blocks an SM, and for rows 10
    and 11 the floats of their split-series scratch.  Builds the library;
    launches nothing."""
    out = (ctypes.c_int * 5)()
    lib = SOURCE.library()
    fn = lib.tmd_blocked_mp_attributes
    fn.argtypes = [I32] * 4 + [P]
    fn.restype = I32
    lib.tmd_tc_image_floats.argtypes = [I32, I32]
    lib.tmd_tc_image_floats.restype = I32
    attrs = {}
    for row, name in ((8, "blocked_mp_sum"), (9, "blocked_mp_dattr"),
                      (10, "blocked_mp_sum_cheb"), (11, "blocked_mp_dd_cheb")):
        rc = fn(row, k, f, t, ctypes.cast(out, P))
        if rc != 0:
            raise RuntimeError(f"tmd_blocked_mp_attributes: CUDA error {rc}")
        attrs[name] = dict(zip(("registers", "local_bytes", "static_smem",
                                "dynamic_smem", "blocks_per_sm"), out))
        if row > 9:
            attrs[name]["image_floats"] = lib.tmd_tc_image_floats(t, 3 * f)
    return attrs


# ---------------------------------------------------------------- plain
def _sum9(w, xj, o):
    """``o[:, d] = Σ_k w[:, k, block(d)] · xj[:, k, d]`` on views
    ``w [c, K, 3, F]``, ``xj [c, K, 9, F]``, ``o [c, 9, F]``."""
    o[:, 0:1] = (w[:, :, 0:1] * xj[:, :, 0:1]).sum(1)
    o[:, 1:4] = (w[:, :, 1:2] * xj[:, :, 1:4]).sum(1)
    o[:, 4:9] = (w[:, :, 2:3] * xj[:, :, 4:9]).sum(1)


def _fold9(g9_rows, xj, f):
    """``Σ_{d∈w} g9[row, d] ⊙ xj[d]`` per weight block w → ``[c, K, 3F]``."""
    prod = g9_rows.view(-1, 1, 9, f) * xj
    return torch.cat([prod[:, :, 0], prod[:, :, 1:4].sum(2),
                      prod[:, :, 4:9].sum(2)], dim=-1)


def neighbor_sum_ref(attr3f, feats9, idx, mask):
    """Plain row 8: ``[N, 9F]``, the invalid slots left out."""
    n, k, c3 = attr3f.shape
    f = c3 // 3
    out = feats9.new_empty((n, 9 * f))
    chunk = row_chunk(n, k, 9 * f)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        xj = (feats9[idx[s:e]] * mask[s:e, :, None]).view(e - s, k, 9, f)
        _sum9(attr3f[s:e].view(e - s, k, 3, f), xj, out[s:e].view(e - s, 9, f))
    return out


def dattr_ref(g9, feats9, idx, mask):
    """Plain row 9: ``[N, K, 3F]``, 0 on invalid slots."""
    return _pns_dattr(g9, feats9, idx, mask)


def neighbor_sum_cheb_ref(coeffs, d, fm, feats9, idx, lo: float, hi: float):
    """Plain row 10: the filter of kernel 5's plain version per row chunk,
    then the row 8 sum over the slots with ``fm ≠ 0``."""
    n, k = d.shape
    T, c3 = coeffs.shape
    f = c3 // 3
    out = feats9.new_empty((n, 9 * f))
    chunk = row_chunk(n, k, 9 * f + c3 + T)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        attr = cheb_filter_ref(coeffs, d[s:e], fm[s:e], lo, hi)
        live = (fm[s:e] != 0)[..., None]
        xj = (feats9[idx[s:e]] * live).view(e - s, k, 9, f)
        _sum9(attr.view(e - s, k, 3, f), xj, out[s:e].view(e - s, 9, f))
    return out


def dd_cheb_ref(dser, d, fm, g9, feats9, idx, lo: float, hi: float):
    """Plain row 11: the row 9 fold per row chunk as the cotangent of
    kernel 7's plain version → ``[N, K]``."""
    n, k = d.shape
    T, c3 = dser.shape
    f = c3 // 3
    out = d.new_empty((n, k))
    chunk = row_chunk(n, k, 9 * f + 2 * c3 + T)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        live = (fm[s:e] != 0)[..., None]
        xj = (feats9[idx[s:e]] * live).view(e - s, k, 9, f)
        ct = _fold9(g9[s:e], xj, f)
        out[s:e] = cheb_filter_dot_ref(dser, d[s:e], fm[s:e], ct, lo, hi)
    return out


# ---------------------------------------------------------------- CUDA
def _check(name, tensors, smem):
    """Raise unless every tensor is on one CUDA device, contiguous, 16-byte
    aligned, of its type and shape, and the launch fits shared memory."""
    n, k = tensors["idx"].shape
    f = tensors["feats9"].shape[1] // 9
    series = tensors.get("coeffs", tensors.get("dser"))
    t = 0 if series is None else series.shape[0]
    shapes = dict(idx=(n, k), mask=(n, k), d=(n, k), fm=(n, k),
                  attr3f=(n, k, 3 * f), feats9=(n, 9 * f), g9=(n, 9 * f),
                  coeffs=(t, 3 * f), dser=(t, 3 * f))
    dev = tensors["idx"].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expects CUDA tensors, got {dev}")
    for key, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name}: {key} is on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        want = {"idx": torch.int64, "mask": torch.bool}.get(key, torch.float32)
        if x.dtype != want:
            raise TypeError(f"{name}: {key} must be {want}, got {x.dtype}")
        if tuple(x.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(x.shape)}, "
                             f"expected {shapes[key]}")
        if x.data_ptr() % 16:  # read as float4
            raise ValueError(f"{name}: {key} is not 16-byte aligned")
    if tensors["feats9"].shape[1] % 9:
        raise ValueError(f"{name}: feats9 width must be 9F, got "
                         f"{tensors['feats9'].shape[1]}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: K={k}, F={f}, T={t} needs {smem} bytes of "
                         f"shared memory (> {SMEM_LIMIT})")
    return dev, n, k, f, t


# the F-runs of each operand, ((dim, runs), …): an F that is not a
# multiple of 4 is padded with zero channels in each (exact: a zero channel
# of attr and of the features adds nothing to any real output)
RUNS = {"attr3f": ((-1, 3),), "feats9": ((-1, 9),), "g9": ((-1, 9),),
        "coeffs": ((-1, 3),), "dser": ((-1, 3),)}


def neighbor_sum_cuda(attr3f, feats9, idx, mask):
    """Row 8 on CUDA tensors: ``[N, 9F]``."""
    tensors = dict(idx=idx, mask=mask, attr3f=attr3f, feats9=feats9)
    dev, n, k, f, _ = _check("blocked_neighbor_sum", tensors, 0)
    if f % 4:
        return unpad_lanes(neighbor_sum_cuda(**pad_runs(
            tensors, RUNS, lane_width(f))), -1, 9, f)
    out = torch.empty((n, 9 * f), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        SUM(ptr(idx), ptr(mask), ptr(attr3f), ptr(feats9), ptr(out), n, k, f)
    return out


def dattr_cuda(g9, feats9, idx, mask):
    """Row 9 on CUDA tensors: ``[N, K, 3F]``."""
    tensors = dict(idx=idx, mask=mask, g9=g9, feats9=feats9)
    dev, n, k, f, _ = _check("blocked_dattr", tensors, 0)
    if f % 4:
        return unpad_lanes(dattr_cuda(**pad_runs(
            tensors, RUNS, lane_width(f))), -1, 3, f)
    out = torch.empty((n, k, 3 * f), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        DATTR(ptr(idx), ptr(mask), ptr(g9), ptr(feats9), ptr(out), n, k, f)
    return out


def neighbor_sum_cheb_cuda(coeffs, d, fm, feats9, idx, lo: float, hi: float):
    """Row 10 on CUDA tensors: ``[N, 9F]``."""
    tensors = dict(idx=idx, d=d, fm=fm, coeffs=coeffs, feats9=feats9)
    dev, n, k, f, t = _check("blocked_neighbor_sum_cheb", tensors,
                             sum_cheb_smem(idx.shape[1],
                                           feats9.shape[1] // 9))
    if f % 4:
        return unpad_lanes(neighbor_sum_cheb_cuda(**pad_runs(
            tensors, RUNS, lane_width(f)), lo=lo, hi=hi), -1, 9, f)
    out = torch.empty((n, 9 * f), dtype=torch.float32, device=dev)
    image = torch.empty(tc_image_floats(t, 3 * f), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        SUM_CHEB(ptr(idx), ptr(d), ptr(fm), ptr(coeffs), ptr(feats9),
                 ptr(out), ptr(image), n, k, f, t, float(lo), float(hi))
    return out


def dd_cheb_cuda(dser, d, fm, g9, feats9, idx, lo: float, hi: float):
    """Row 11 on CUDA tensors: ``[N, K]``."""
    tensors = dict(idx=idx, d=d, fm=fm, dser=dser, g9=g9, feats9=feats9)
    dev, n, k, f, t = _check("blocked_dd_cheb", tensors,
                             dd_cheb_smem(idx.shape[1],
                                          feats9.shape[1] // 9))
    if f % 4:
        return dd_cheb_cuda(**pad_runs(tensors, RUNS, lane_width(f)), lo=lo,
                            hi=hi)
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    image = torch.empty(tc_image_floats(t, 3 * f), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        DD_CHEB(ptr(idx), ptr(d), ptr(fm), ptr(dser), ptr(g9), ptr(feats9),
                ptr(out), ptr(image), n, k, f, t, float(lo), float(hi))
    return out


def neighbor_sum(attr3f, feats9, idx, mask):
    """Row 8: the kernel for CUDA tensors, its plain version for CPU ones."""
    return (neighbor_sum_cuda if idx.is_cuda else neighbor_sum_ref)(
        attr3f, feats9, idx, mask)


def dattr(g9, feats9, idx, mask):
    """Row 9: the kernel for CUDA tensors, its plain version for CPU ones."""
    return (dattr_cuda if idx.is_cuda else dattr_ref)(g9, feats9, idx, mask)


def neighbor_sum_cheb(coeffs, d, fm, feats9, idx, lo, hi):
    """Row 10: the kernel for CUDA tensors, its plain version for CPU ones."""
    return (neighbor_sum_cheb_cuda if idx.is_cuda else neighbor_sum_cheb_ref)(
        coeffs, d, fm, feats9, idx, lo, hi)


def dd_cheb(dser, d, fm, g9, feats9, idx, lo, hi):
    """Row 11: the kernel for CUDA tensors, its plain version for CPU ones."""
    return (dd_cheb_cuda if idx.is_cuda else dd_cheb_ref)(
        dser, d, fm, g9, feats9, idx, lo, hi)


# ---------------------------------------------------------------- autograd
class _BlockedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attr3f, attr_rev, feats9, idx, mask):
        ctx.save_for_backward(attr_rev, feats9, idx, mask)
        return neighbour_sum_out(
            lambda: neighbor_sum(attr3f, feats9, idx, mask), feats9)

    @staticmethod
    @first_order_only("the blocked neighbour sum (rows 8-9)")
    def backward(ctx, g):
        attr_rev, feats9, idx, mask = ctx.saved_tensors
        g = g.contiguous()
        da = dattr(g, feats9, idx, mask) if ctx.needs_input_grad[0] else None
        df = (neighbor_sum(attr_rev, g, idx, mask)
              if ctx.needs_input_grad[2] else None)
        return da, None, df, None, None


def blocked_neighbor_sum_sym(attr3f, feats9, idx, mask):
    """Edge-symmetric weights (``attr3f[i, s_ij] == attr3f[j, s_ji]``): the
    feature backward is the forward op on the cotangent, ``∂attr`` is row
    9 (JAX ``blocked_neighbor_sum_sym``, ``:626-634``)."""
    attr3f = attr3f.contiguous()
    return _BlockedSum.apply(attr3f, attr3f, feats9.contiguous(), idx, mask)


def blocked_neighbor_sum_asym(attr3f, attr_rev, feats9, idx, mask):
    """Direction-dependent weights with the caller-recomputed reverse-edge
    weights ``attr_rev``: the feature backward is the forward op on
    ``attr_rev``, which gets no gradient (JAX ``:607-623``)."""
    return _BlockedSum.apply(attr3f.contiguous(), attr_rev.contiguous(),
                             feats9.contiguous(), idx, mask)


class _BlockedSumCheb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coeffs, d, fm, feats9, idx, lo, hi):
        ctx.save_for_backward(coeffs, d, fm, feats9, idx)
        ctx.lo, ctx.hi = lo, hi
        return neighbour_sum_out(lambda: neighbor_sum_cheb(
            coeffs, d, fm, feats9, idx, lo, hi), feats9)

    @staticmethod
    @first_order_only("the blocked Chebyshev neighbour sum (rows 10-11)")
    def backward(ctx, g):
        coeffs, d, fm, feats9, idx = ctx.saved_tensors
        lo, hi = ctx.lo, ctx.hi
        g = g.contiguous()
        df = (neighbor_sum_cheb(coeffs, d, fm, g, idx, lo, hi)
              if ctx.needs_input_grad[3] else None)
        dd = None
        if ctx.needs_input_grad[1]:
            dser = cheb_deriv_coeffs(coeffs).contiguous()
            dd = dd_cheb(dser, d, fm, g, feats9, idx, lo, hi)
            dd = dd * (2.0 / (hi - lo))
        dc = torch.zeros_like(coeffs) if ctx.needs_input_grad[0] else None
        return dc, dd, None, df, None, None, None


def blocked_neighbor_sum_sym_cheb(coeffs, d, fm, feats9, idx, lo: float,
                                  hi: float):
    """``blocked_neighbor_sum_sym(fm·cheb_filter(coeffs, d), feats9, ...)``
    without the ``[N, K, 3F]`` filter (JAX ``:1104-1114``): gradients flow
    to ``d`` and ``feats9``; ``coeffs`` gets zeros (MD only); ``fm``
    none."""
    return _BlockedSumCheb.apply(coeffs.contiguous(), d.contiguous(),
                                 fm.contiguous(), feats9.contiguous(), idx,
                                 float(lo), float(hi))
