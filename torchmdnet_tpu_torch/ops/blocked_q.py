"""TensorNet2 fused charge-fold message passing (the blocked q-tier;
kernels A and B of the port), with the θ-tabulated base and the exact rbf
one.

Counterpart of ``blocked_neighbor_sum_asym_q_tab``,
``blocked_neighbor_sum_asym_q`` and their Pallas kernels
(``torchmdnet_tpu/ops/pallas_blocked_mp.py:1120-2211``, ungrouped and
grouped bodies, ``tab`` True and False): per slot ``(n, k)`` of the
sorted-space neighbor matrix, ``j = idx[n, k]``,

    pre1 = base[n, k] + u_i[n] + u_j[j]
    attr = silu(silu(silu(pre1)·W2 + b2)·W3 + b3) · cwfm[n, k]
    out[n] = Σ_k expand9(attr) ⊙ feats9[j]

with ``base = Σ_t cos(t·θ)·coeffs[t]``, ``θ = arccos(clip(2(d − lo)/(hi −
lo) − 1, −1, 1))`` (tabulated), or ``base = edge_attr[n, k]·W1a`` (exact,
``edge_attr [N, K, R]``): the edge MLP and the neighbor sum in one pass,
so neither ``attr`` nor its reverse ever reaches memory.  The grouped
tier's column-partitioned ``K′`` list goes through the same kernels: they
gather ``feats9[idx]`` directly, so a layout is only a set of valid slots.
The backward follows ``_make_blocked_q_op(_tab).bwd`` (``:2079-2104``,
``:2170-2190``): kernel A in its ``with_du`` form on the mirrored operands
(``u_i``↔``u_j``, window ``g``, fold rows ``feats9``) gives ``dfeats`` and
``du_j``; kernel B gives ``du_i``, ``dcw`` and the base's cotangent (``dd``
tabulated, the rbf cotangent ``[N, K, R]`` exact).  The series or W1a, W2,
b2, W3 and b3 get zero gradients (the MD-only contract of ``:2053-2055``).
It requires ``d`` (or ``edge_attr``) and ``cwfm`` to be equal on the two
slots of a pair, as the JAX op does.

Numerics: f32 throughout, what the JAX package computes with
``spec.precise=True``.  Its fast tier (the bench default) rounds the
window features and the basis dot to bf16 (~1e-3 relative,
``pallas_blocked_mp.py:24-34, 679-684``); the port does not reproduce
that rounding.

On CUDA tensors each function launches its kernel (``csrc/blocked_q.cu``)
or raises; on CPU tensors it runs the plain version beside it.  Kernels A
and B run their products on the tensor cores in 3xTF32
(``csrc/tc_tile.cuh``, float32-accurate) from split copies of their
weights (the base, W2 and W3; with du and in B W3ᵀ and W2ᵀ; in B the
base's cotangent) in a scratch the wrapper allocates
(:func:`q_image_floats`).  Above F = 128 a block's activation tiles do
not fit its shared memory: each resident block keeps them in its region
of a second scratch (:func:`q_tile_floats`), and the grid is one block
an SM.  :func:`launch_plan` holds the grid, shared memory and both
scratches; every width the JAX op computes launches (:func:`plan_error`):
the kernels read float4 rows, so for an F that is not a multiple of 4
:func:`_launch` pads every F-run of the operands (the base weight, u, the
window and fold rows, W2, W3 and the biases) with zero channels to the
next multiple and slices the outputs.  That is exact: a padded channel's
pre-activation is 0, silu(0) = 0 at every layer, and the zero weight rows
keep it out of every real output and cotangent.
"""

import ctypes

import torch
import torch.nn.functional as F_

from torchmdnet_tpu_torch.ops.cheb import cheb_deriv_coeffs, cheb_theta, cos_basis
from torchmdnet_tpu_torch.ops.kernels import (
    F32, I32, I64, P, CudaSource, Kernel, first_order_only, lane_width,
    neighbour_sum_out, null_or_ptr, pad_runs, ptr, unpad_lanes)
from torchmdnet_tpu_torch.ops.message_passing import row_chunk
from torchmdnet_tpu_torch.ops.tc_tile import H100_SMS, REGION
from torchmdnet_tpu_torch.ops.tc_tile import image_floats as tc_image_floats

SOURCE = CudaSource("blocked_q.cu")
_COMMON = [P] * 7  # d or rbf, cw, mask, idx, urow, ucol, xwin
# every form ends in image, tiles, then n, k, f, t (+ lo, span), grid
_TAIL = [P, P, I64, I32, I32, I32, F32, F32, I32]
_TAIL_RBF = [P, P, I64, I32, I32, I32, I32]
# kernel A: + coeffs, w2, b2, w3, b3, out; with du + grow, du
FORWARD = Kernel(SOURCE, "tmd_blocked_q_fwd", _COMMON + [P] * 6 + _TAIL)
FORWARD_DU = Kernel(SOURCE, "tmd_blocked_q_fwd_du",
                    _COMMON + [P] * 8 + _TAIL)
# kernel B: + grow, coeffs, dser, w2, b2, w3, b3, du, dd, dcw
DQ = Kernel(SOURCE, "tmd_blocked_q_dq", _COMMON + [P] * 10 + _TAIL)
# the exact-rbf forms (tab=False): rbf [N, K, R] for d, W1a for coeffs
FORWARD_RBF = Kernel(SOURCE, "tmd_blocked_q_fwd_rbf",
                     _COMMON + [P] * 6 + _TAIL_RBF)
FORWARD_DU_RBF = Kernel(SOURCE, "tmd_blocked_q_fwd_du_rbf",
                        _COMMON + [P] * 8 + _TAIL_RBF)
DQ_RBF = Kernel(SOURCE, "tmd_blocked_q_dq_rbf", _COMMON + [P] * 9 + _TAIL_RBF)
# q_chain: sorted rows a block owns, slots it compacts at a time, the
# widest F whose tiles sit in shared memory
_ROWS, _CHUNK, _NARROW_F = 16, 4096, 128
# the kernels of mode 0 (A), 1 (A with du) and 2 (B)
MODES = ("blocked_q_fwd", "blocked_q_fwd_du", "blocked_q_dq")


def q_tile_floats(f: int, mode: int = 2) -> int:
    """Floats of one block's activation tiles in the wide form (F > 128;
    0 at or below): sX ``[64, 3F + 4]``; with du (mode 1) and in B (mode
    2) also sZ ``[64, 2F + 4]`` and the dz3 plane ``[64, 3F + 4]``."""
    if f <= _NARROW_F:
        return 0
    return 64 * (3 * f + 4) + (64 * (5 * f + 8) if mode else 0)


def q_smem(f: int, k: int, mode: int = 2) -> int:
    """Dynamic shared memory of a launch of mode 0 (kernel A), 1 (A with
    du) or 2 (B), as ``q_chain`` lays it out: 1 KB to align the ring, the
    ring, for F ≤ 128 the [64, 3F + 4] tile (and, but for A, the [64, 2F +
    4] one), the [2, 64] warpgroup sums, dcw, cw and θ, the tile's rows,
    neighbours and slot offsets, the warp counts, and the 16-bit slot ids
    of a compaction pass."""
    tiles = 0
    if f <= _NARROW_F:
        tiles = 64 * (3 * f + 4) + (64 * (2 * f + 4) if mode else 0)
    floats = REGION + tiles + 5 * 64
    return 1024 + 4 * floats + 4 * (3 * 64 + 8) + 2 * min(_ROWS * k, _CHUNK)


def q_image_floats(f: int, t: int, rbf: bool = False, mode: int = 2) -> int:
    """Floats of the weight scratch at ``F = f`` with ``t`` series terms
    (or, ``rbf``, the rbf width): the split images of the base ``[t, F]``,
    W2 and W3; with du and in B W3ᵀ and W2ᵀ; in B the base's cotangent
    (``dser [t, F]``, or W1aᵀ ``[F, t]``)."""
    x = tc_image_floats(t, f) + tc_image_floats(f, 2 * f) \
        + tc_image_floats(2 * f, 3 * f)
    if mode:
        x += tc_image_floats(3 * f, 2 * f) + tc_image_floats(2 * f, f)
    if mode == 2:
        x += tc_image_floats(f, t) if rbf else tc_image_floats(t, f)
    return x


def launch_plan(n: int, k: int, f: int, t: int, rbf: bool = False,
                mode: int = 2, sms: int = H100_SMS) -> dict:
    """Mode 0 (kernel A), 1 (A with du) or 2 (B) at ``n`` sorted rows of
    ``k`` slots, ``F = f`` and ``t`` series terms (``rbf``: the exact
    form, ``t`` the rbf width) on a card of ``sms`` SMs: ``(blocks, rows a
    row block, slots a compaction pass, dynamic shared memory, image
    floats, tile floats)``.  Block ``b`` owns the row blocks ``b, b +
    blocks, …`` below ``⌈n/rows⌉``, each of the sorted rows ``[rb·rows,
    rb·rows + rows)``: one row block each for F ≤ 128, one block an SM
    above, each with its ``q_tile_floats`` of the tile scratch."""
    row_blocks = -(-n // _ROWS)
    blocks = row_blocks if f <= _NARROW_F else max(1, min(row_blocks, sms))
    name = MODES[mode] + ("_rbf" if rbf else "")
    return {name: (blocks, _ROWS, min(_ROWS * k, _CHUNK), q_smem(f, k, mode),
                   q_image_floats(f, t, rbf, mode),
                   blocks * q_tile_floats(f, mode))}


def plan_error(f: int, t: int, rbf: bool = False):
    """Why kernels A and B cannot launch at ``F = f`` with ``t`` series
    terms or rbf channels, or None: F and ``t`` at least 1.  Any K and
    every such width launches: F that is not a multiple of 4 is padded to
    one (:func:`_launch`), the plan's shared memory stays within a block's
    232,448 B (:func:`q_smem`; the tiles of F > 128 go to device memory),
    and a scratch larger than the card's free memory fails at its
    allocation."""
    if f < 1:
        return f"channels {f} must be >= 1"
    if t < 1:
        return f"{'rbf width' if rbf else 'series terms'} {t} must be >= 1"
    return None


def kernel_attributes(f: int, k: int, t: int, r: int) -> dict:
    """What the compiler and the launch give kernels A, A with du and B,
    both bases, at ``(F, K)``: registers and local (spill) bytes a thread,
    static and dynamic shared memory a block, resident blocks an SM, the
    floats of the image scratch at ``t`` series terms or ``r`` rbf
    channels and of one block's tiles in device memory (0 at F ≤ 128).
    Builds the library; launches nothing."""
    lib = SOURCE.library()
    fn = lib.tmd_blocked_q_attributes
    fn.argtypes = [I32, I32, I32, I32, P]
    fn.restype = I32
    images = lib.tmd_blocked_q_image_floats
    images.argtypes = [I32, I32, I32, I32]
    images.restype = I32
    tiles = lib.tmd_blocked_q_tile_floats
    tiles.argtypes = [I32, I32]
    tiles.restype = I64
    attrs = {}
    for mode, base in enumerate(MODES):
        for rbf, suffix, width in ((0, "", t), (1, "_rbf", r)):
            out = (ctypes.c_int * 5)()
            rc = fn(mode, rbf, f, k, ctypes.cast(out, P))
            if rc != 0:
                raise RuntimeError(
                    f"tmd_blocked_q_attributes: CUDA error {rc}")
            a = dict(zip(("registers", "local_bytes", "static_smem",
                          "dynamic_smem", "blocks_per_sm"), out))
            a["image_floats"] = images(mode, f, width, rbf)
            a["tile_floats"] = tiles(mode, f)
            attrs[base + suffix] = a
    return attrs


def _dsilu(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _chain(basis, urow_c, ucol_j, w1, w2, b2, w3, b3):
    pre1 = basis @ w1 + urow_c[:, None] + ucol_j
    z2 = F_.silu(pre1) @ w2 + b2
    z3 = F_.silu(z2) @ w3 + b3
    return pre1, z2, z3


def _fold9(g9_rows, xj, f):
    """``Σ_{d∈w} g9[row, d] ⊙ xj[d]`` per weight block w → [c, K, 3F]."""
    prod = g9_rows.view(-1, 1, 9, f) * xj
    return torch.cat([prod[:, :, 0], prod[:, :, 1:4].sum(2),
                      prod[:, :, 4:9].sum(2)], dim=-1)


def _backprop(da, pre1, z2, z3, w2, w3):
    dz3 = da * _dsilu(z3)
    dz2 = (dz3 @ w3.t()) * _dsilu(z2)
    return (dz2 @ w2.t()) * _dsilu(pre1)


def _fwd_plain(basis, cw, mask, idx, urow, ucol, xwin, w1, w2, b2, w3, b3,
               grow):
    """Kernel A's function; ``basis(s, e)`` is the ``[e − s, K, T]``
    operand of the base of rows ``s:e`` (row-chunked gather chain)."""
    n, k = idx.shape
    f = w1.shape[1]
    out = xwin.new_empty((n, 9 * f))
    du = xwin.new_empty((n, f)) if grow is not None else None
    chunk = row_chunk(n, k, 40 * f + w1.shape[0])
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        m = mask[s:e]
        pre1, z2, z3 = _chain(basis(s, e), urow[s:e], ucol[idx[s:e]], w1,
                              w2, b2, w3, b3)
        xj = (xwin[idx[s:e]] * m[..., None]).view(e - s, k, 9, f)
        a = (F_.silu(z3) * cw[s:e, :, None]).view(e - s, k, 3, f)
        o = out[s:e].view(e - s, 9, f)
        o[:, 0:1] = (a[:, :, 0:1] * xj[:, :, 0:1]).sum(1)
        o[:, 1:4] = (a[:, :, 1:2] * xj[:, :, 1:4]).sum(1)
        o[:, 4:9] = (a[:, :, 2:3] * xj[:, :, 4:9]).sum(1)
        if grow is not None:
            da = _fold9(grow[s:e], xj, f) * cw[s:e, :, None]
            du[s:e] = _backprop(da, pre1, z2, z3, w2, w3).sum(1)
    return out if grow is None else (out, du)


def _dq_plain(basis, base_grad, cw, mask, idx, urow, ucol, xwin, g9, w1, w2,
              b2, w3, b3, grad_shape):
    """Kernel B's function: ``(du, base cotangent, dcw)``; ``base_grad(dpre,
    s, e)`` maps ∂/∂pre1 of rows ``s:e`` to the base operand's cotangent
    (an array of ``grad_shape``)."""
    n, k = idx.shape
    f = w1.shape[1]
    du = xwin.new_empty((n, f))
    dbase = xwin.new_empty(grad_shape)
    dcw = xwin.new_empty((n, k))
    chunk = row_chunk(n, k, 40 * f + w1.shape[0])
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        m = mask[s:e]
        pre1, z2, z3 = _chain(basis(s, e), urow[s:e], ucol[idx[s:e]], w1,
                              w2, b2, w3, b3)
        xj = (xwin[idx[s:e]] * m[..., None]).view(e - s, k, 9, f)
        fold = _fold9(g9[s:e], xj, f)
        dcw[s:e] = (fold * F_.silu(z3)).sum(-1)
        dpre = _backprop(fold * cw[s:e, :, None], pre1, z2, z3, w2, w3)
        du[s:e] = dpre.sum(1)
        dbase[s:e] = base_grad(dpre, s, e)
    return du, dbase, dcw


def q_fwd_ref(d, cw, mask, idx, urow, ucol, xwin, coeffs, w2, b2, w3, b3,
              lo: float, hi: float, grow=None):
    """Plain kernel A, tabulated base: ``out [N, 9F]``; with ``grow [N, 9F]``
    also ``du [N, F]``, the ∂/∂pre1 row sums of ``Σ ⟨grow[n],
    expand9(attr) ⊙ x_j⟩``."""
    theta = cheb_theta(d, lo, hi)
    T = coeffs.shape[0]
    return _fwd_plain(lambda s, e: cos_basis(theta[s:e], T), cw, mask, idx,
                      urow, ucol, xwin, coeffs, w2, b2, w3, b3, grow)


def q_dq_ref(d, cw, mask, idx, urow, ucol, xwin, g9, coeffs, dser, w2, b2,
             w3, b3, lo: float, hi: float):
    """Plain kernel B, tabulated base: ``(du [N, F], dd [N, K], dcw [N,
    K])``; ``dd`` is the derivative in ``x`` (the caller applies ``2/(hi −
    lo)``)."""
    theta = cheb_theta(d, lo, hi)
    T = coeffs.shape[0]

    def dd(dpre, s, e):
        return (dpre * (cos_basis(theta[s:e], T) @ dser)).sum(-1)

    return _dq_plain(lambda s, e: cos_basis(theta[s:e], T), dd, cw, mask,
                     idx, urow, ucol, xwin, g9, coeffs, w2, b2, w3, b3,
                     tuple(d.shape))


def q_fwd_rbf_ref(rbf, cw, mask, idx, urow, ucol, xwin, w1a, w2, b2, w3, b3,
                  grow=None):
    """Plain kernel A, exact base ``rbf [N, K, R]·W1a [R, F]``."""
    return _fwd_plain(lambda s, e: rbf[s:e], cw, mask, idx, urow, ucol, xwin,
                      w1a, w2, b2, w3, b3, grow)


def q_dq_rbf_ref(rbf, cw, mask, idx, urow, ucol, xwin, g9, w1a, w2, b2, w3,
                 b3):
    """Plain kernel B, exact base: ``(du [N, F], drbf [N, K, R], dcw [N,
    K])``, ``drbf = ∂/∂pre1·W1aᵀ`` (zero on invalid slots)."""
    return _dq_plain(lambda s, e: rbf[s:e], lambda dpre, s, e: dpre @ w1a.t(),
                     cw, mask, idx, urow, ucol, xwin, g9, w1a, w2, b2, w3, b3,
                     tuple(rbf.shape))


def _check(name, tensors):
    """Raise unless every tensor is on one CUDA device, contiguous, of its
    type and shape, and the widths launch (:func:`plan_error`).
    ``coeffs`` is the [T, F] base weight: the series, or W1a with ``rbf``
    given."""
    n, k = tensors["idx"].shape
    T, f = tensors["coeffs"].shape
    error = plan_error(f, T, rbf="rbf" in tensors)
    if error:
        raise ValueError(f"{name}: {error}")
    shapes = dict(d=(n, k), rbf=(n, k, T), cw=(n, k), mask=(n, k),
                  idx=(n, k), urow=(n, f), ucol=(n, f), xwin=(n, 9 * f),
                  grow=(n, 9 * f), coeffs=(T, f), dser=(T, f),
                  w2=(f, 2 * f), b2=(2 * f,), w3=(2 * f, 3 * f), b3=(3 * f,))
    first = tensors["rbf" if "rbf" in tensors else "d"]
    dev = first.device
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
        if x.data_ptr() % 16:  # weights are read as float4
            raise ValueError(f"{name}: {key} is not 16-byte aligned")
    return dev, n, k, f, T


# the F-runs of each operand, as :func:`_check` names them: ((dim, runs),
# …), padded where F is not a multiple of 4
RUNS = {"urow": ((-1, 1),), "ucol": ((-1, 1),), "xwin": ((-1, 9),),
         "grow": ((-1, 9),), "coeffs": ((-1, 1),), "dser": ((-1, 1),),
         "w2": ((0, 1), (1, 2)), "b2": ((0, 2),), "w3": ((0, 2), (1, 3)),
         "b3": ((0, 3),)}


def _launch(kernel, mode, tensors, outs, scalars):
    """Checks ``tensors`` (their order is the entry point's), allocates
    the outputs ``outs(n, k, f, T)`` and the two scratches of
    :func:`launch_plan`, and launches ``kernel`` with ``scalars(n, k, f,
    T)`` before the grid.  Returns the outputs.  An F that is not a
    multiple of 4 runs padded (see the module docstring)."""
    rbf = "rbf" in tensors
    T, f = tensors["coeffs"].shape
    if f % 4 and not plan_error(f, T, rbf):
        fp = lane_width(f)
        got = _launch(kernel, mode, pad_runs(tensors, RUNS, fp), outs,
                      scalars)
        got = got if isinstance(got, tuple) else (got,)
        n, k = tensors["idx"].shape
        # an output whose shape depends on F is sliced back run by run
        got = tuple(
            unpad_lanes(t, -1, wide[-1] // fp, f) if wide != want else t
            for t, wide, want in zip(got, outs(n, k, fp, T),
                                     outs(n, k, f, T)))
        return got[0] if len(got) == 1 else got
    dev, n, k, f, T = _check(kernel.symbol, tensors)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    (grid, _, _, _, image_n, tiles_n), = launch_plan(
        n, k, f, T, rbf, mode, sms).values()
    with torch.cuda.device(dev):
        got = [torch.empty(shape, dtype=torch.float32, device=dev)
               for shape in outs(n, k, f, T)]
        image = torch.empty(image_n, dtype=torch.float32, device=dev)
        tiles = torch.empty(tiles_n, dtype=torch.float32, device=dev) \
            if tiles_n else None
        kernel(*[ptr(t) for t in tensors.values()], *[ptr(t) for t in got],
               ptr(image), null_or_ptr(tiles),
               *scalars(n, k, f, T), grid)
    return got[0] if len(got) == 1 else tuple(got)


def _fwd_cuda(kernels, base_key, base, cw, mask, idx, urow, ucol, xwin, w1,
              w2, b2, w3, b3, scalars, grow):
    """Kernel A (``grow`` given: its with-du form) on CUDA tensors;
    ``kernels`` = (plain form, with-du form), ``scalars(n, k, f, T)`` the
    trailing scalars before the grid."""
    tensors = {base_key: base, "cw": cw, "mask": mask, "idx": idx,
               "urow": urow, "ucol": ucol, "xwin": xwin}
    if grow is not None:
        tensors["grow"] = grow
    tensors.update(coeffs=w1, w2=w2, b2=b2, w3=w3, b3=b3)
    if grow is None:
        return _launch(kernels[0], 0, tensors,
                       lambda n, k, f, T: [(n, 9 * f)], scalars)
    return _launch(kernels[1], 1, tensors,
                   lambda n, k, f, T: [(n, 9 * f), (n, f)], scalars)


def q_fwd_cuda(d, cw, mask, idx, urow, ucol, xwin, coeffs, w2, b2, w3, b3,
               lo: float, hi: float, grow=None):
    """Kernel A, tabulated base (``grow`` given: its with-du form)."""
    return _fwd_cuda((FORWARD, FORWARD_DU), "d", d, cw, mask, idx, urow,
                     ucol, xwin, coeffs, w2, b2, w3, b3,
                     lambda n, k, f, T: (n, k, f, T, float(lo),
                                         float(hi - lo)), grow)


def q_fwd_rbf_cuda(rbf, cw, mask, idx, urow, ucol, xwin, w1a, w2, b2, w3, b3,
                   grow=None):
    """Kernel A, exact base (``grow`` given: its with-du form)."""
    return _fwd_cuda((FORWARD_RBF, FORWARD_DU_RBF), "rbf", rbf, cw, mask, idx,
                     urow, ucol, xwin, w1a, w2, b2, w3, b3,
                     lambda n, k, f, T: (n, k, f, T), grow)


def q_dq_cuda(d, cw, mask, idx, urow, ucol, xwin, g9, coeffs, dser, w2, b2,
              w3, b3, lo: float, hi: float):
    """Kernel B, tabulated base, on CUDA tensors: ``(du, dd, dcw)``."""
    tensors = dict(d=d, cw=cw, mask=mask, idx=idx, urow=urow, ucol=ucol,
                   xwin=xwin, grow=g9, coeffs=coeffs, dser=dser, w2=w2, b2=b2,
                   w3=w3, b3=b3)
    return _launch(DQ, 2, tensors,
                   lambda n, k, f, T: [(n, f), (n, k), (n, k)],
                   lambda n, k, f, T: (n, k, f, T, float(lo), float(hi - lo)))


def q_dq_rbf_cuda(rbf, cw, mask, idx, urow, ucol, xwin, g9, w1a, w2, b2, w3,
                  b3):
    """Kernel B, exact base, on CUDA tensors: ``(du, drbf, dcw)``."""
    tensors = dict(rbf=rbf, cw=cw, mask=mask, idx=idx, urow=urow, ucol=ucol,
                   xwin=xwin, grow=g9, coeffs=w1a, w2=w2, b2=b2, w3=w3, b3=b3)
    return _launch(DQ_RBF, 2, tensors,
                   lambda n, k, f, T: [(n, f), (n, k, T), (n, k)],
                   lambda n, k, f, T: (n, k, f, T))


def q_fwd(*args, **kwargs):
    """Kernel A on CUDA tensors, its plain version on CPU tensors."""
    return (q_fwd_cuda if args[0].is_cuda else q_fwd_ref)(*args, **kwargs)


def q_dq(*args, **kwargs):
    """Kernel B on CUDA tensors, its plain version on CPU tensors."""
    return (q_dq_cuda if args[0].is_cuda else q_dq_ref)(*args, **kwargs)


def q_fwd_rbf(*args, **kwargs):
    """Kernel A, exact base, on CUDA tensors; its plain version on CPU
    tensors."""
    return (q_fwd_rbf_cuda if args[0].is_cuda else q_fwd_rbf_ref)(
        *args, **kwargs)


def q_dq_rbf(*args, **kwargs):
    """Kernel B, exact base, on CUDA tensors; its plain version on CPU
    tensors."""
    return (q_dq_rbf_cuda if args[0].is_cuda else q_dq_rbf_ref)(
        *args, **kwargs)


def _zero_grads(ctx, weights, first):
    """Zero cotangents for the weights that asked for one (the MD-only
    contract)."""
    return [torch.zeros_like(t) if need else None
            for t, need in zip(weights,
                               ctx.needs_input_grad[first:first + 5])]


class _BlockedQTab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, cwfm, u_i, u_j, feats9, mask, idx, coeffs, w2, b2,
                w3, b3, lo, hi):
        ctx.save_for_backward(d, cwfm, u_i, u_j, feats9, mask, idx, coeffs,
                              w2, b2, w3, b3)
        ctx.lo, ctx.hi = lo, hi
        return neighbour_sum_out(lambda: q_fwd(
            d, cwfm, mask, idx, u_i, u_j, feats9, coeffs, w2, b2, w3, b3, lo,
            hi), feats9)

    @staticmethod
    @first_order_only("the blocked q-tier (kernels A and B)")
    def backward(ctx, g):
        d, cwfm, u_i, u_j, feats9, mask, idx, coeffs, w2, b2, w3, b3 = \
            ctx.saved_tensors
        lo, hi = ctx.lo, ctx.hi
        g = g.contiguous()
        # dfeats and du_j: the mirrored forward (u_i ↔ u_j, window g, fold
        # rows feats9) — pre1 of slot (m, k') equals pre1 of its reverse
        dfeats, du_j = q_fwd(d, cwfm, mask, idx, u_j, u_i, g, coeffs, w2, b2,
                             w3, b3, lo, hi, grow=feats9)
        du_i, dd, dcw = q_dq(d, cwfm, mask, idx, u_i, u_j, feats9, g, coeffs,
                             cheb_deriv_coeffs(coeffs).contiguous(), w2, b2,
                             w3, b3, lo, hi)
        dd = dd * (2.0 / (hi - lo))
        zeros = _zero_grads(ctx, (coeffs, w2, b2, w3, b3), 7)
        return (dd, dcw, du_i, du_j, dfeats, None, None, *zeros, None, None)


class _BlockedQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edge_attr, cwfm, u_i, u_j, feats9, mask, idx, w1a, w2,
                b2, w3, b3):
        ctx.save_for_backward(edge_attr, cwfm, u_i, u_j, feats9, mask, idx,
                              w1a, w2, b2, w3, b3)
        return neighbour_sum_out(lambda: q_fwd_rbf(
            edge_attr, cwfm, mask, idx, u_i, u_j, feats9, w1a, w2, b2, w3,
            b3), feats9)

    @staticmethod
    @first_order_only("the exact-base q-tier (kernels A and B)")
    def backward(ctx, g):
        (edge_attr, cwfm, u_i, u_j, feats9, mask, idx, w1a, w2, b2, w3,
         b3) = ctx.saved_tensors
        g = g.contiguous()
        # as _BlockedQTab.backward, with the rbf cotangent from kernel B
        dfeats, du_j = q_fwd_rbf(edge_attr, cwfm, mask, idx, u_j, u_i, g, w1a,
                                 w2, b2, w3, b3, grow=feats9)
        du_i, dattr, dcw = q_dq_rbf(edge_attr, cwfm, mask, idx, u_i, u_j,
                                    feats9, g, w1a, w2, b2, w3, b3)
        zeros = _zero_grads(ctx, (w1a, w2, b2, w3, b3), 7)
        return (dattr, dcw, du_i, du_j, dfeats, None, None, *zeros)


def blocked_neighbor_sum_asym_q_tab(d, cwfm, u_i, u_j, feats9, mask, idx,
                                    rev_slot, coeffs, w2, b2, w3, b3,
                                    lo: float, hi: float):
    """Fused charge-fold asymmetric neighbor sum with the θ-tabulated base
    → ``[N, 9F]`` (see the module docstring).  ``d``/``cwfm`` ``[N, K]``
    must be equal on both slots of every pair; ``rev_slot`` is accepted for
    the JAX signature (the kernels gather by ``idx`` in both directions).
    Weights in the JAX layout: ``coeffs [T, F]``, ``w2 [F, 2F]``, ``w3 [2F,
    3F]``."""
    del rev_slot
    return _BlockedQTab.apply(d, cwfm, u_i, u_j, feats9, mask, idx, coeffs,
                              w2, b2, w3, b3, float(lo), float(hi))


def blocked_neighbor_sum_asym_q(edge_attr, cwfm, u_i, u_j, feats9, mask, idx,
                                rev_slot, w1a, w2, b2, w3, b3):
    """Fused charge-fold asymmetric neighbor sum with the exact base
    ``edge_attr [N, K, R]·w1a [R, F]`` → ``[N, 9F]``; gradients to
    ``edge_attr``, ``cwfm``, ``u_i``, ``u_j`` and ``feats9``, zeros to the
    five weights.  ``edge_attr``/``cwfm`` must be equal on both slots of
    every pair; ``rev_slot`` as in :func:`blocked_neighbor_sum_asym_q_tab`."""
    del rev_slot
    return _BlockedQ.apply(edge_attr.contiguous(), cwfm, u_i, u_j, feats9,
                           mask, idx, w1a.contiguous(), w2, b2, w3, b3)
