"""The interaction edge MLPs of TensorNet and TensorNet2 (kernels 4 and 3
of the port).

Counterparts of ``torchmdnet_tpu/ops/pallas_kernels.py``:

- ``fused_edge_mlp`` (``:59-166``), TensorNet's whole three-layer chain on
  the rbf ``x [N, K, R]``:

      attr = silu(silu(silu(x·W1 + b1)·W2 + b2)·W3 + b3) · cw   → [N, K, 3F]

- ``edge_mlp_pre`` (``fused_edge_mlp_pre``, ``:182-279``), TensorNet2's
  tail given the precomputed first-layer preactivation ``pre1 [N, K, F]``:

      attr = silu(silu(silu(pre1)·W2 + b2)·W3 + b3) · cw        → [N, K, 3F]

with weights in the JAX kernel layout (``W1 [R, F]``, ``W2 [F, 2F]``,
``W3 [2F, 3F]``).  On a CUDA tensor each forward is a hand-written kernel
of ``csrc/edge_mlp.cu`` or raises; on a CPU tensor it is the plain chain
beside it.  Both kernels run the chain on the slots with ``cw ≠ 0`` only
and write exact zeros for the others.  Kernel 3 forms its two products on
the tensor cores in 3xTF32 (``csrc/tc_tile.cuh``, float32-accurate), from
split copies of ``W2`` and ``W3`` in a scratch the wrapper allocates
(:func:`image_floats`); :func:`launch_plan` holds its grid and shared
memory; above F = 256 its h2 and ``silu(pre1)`` tiles go to a second
device-memory scratch, one region for each resident block.  Kernel 4 is
fp32 FMA on tiles of 64 slots, or 32 or 16 where 64 rows do not fit a
block (:func:`fused_rows`).  Every width that is a positive multiple of 4
launches (:func:`pre_plan_error`, :func:`fused_plan_error`).  The backward
recomputes through the plain chain over row chunks, as the JAX
``_bwd``/``_bwd_pre`` (``:118``, ``:237``) do (the JAX package has no
backward kernel for these ops); it is first-order only.
"""

import ctypes

import torch
import torch.nn.functional as F_
from torch.autograd.function import once_differentiable

from torchmdnet_tpu_torch.ops.kernels import (
    I32, I64, P, CudaSource, Kernel, check_cuda_args, null_or_ptr, ptr)
from torchmdnet_tpu_torch.ops.message_passing import row_chunk
from torchmdnet_tpu_torch.ops.tc_tile import H100_SMS, REGION, SMEM_LIMIT
from torchmdnet_tpu_torch.ops.tc_tile import image_floats as tc_image_floats

SOURCE = CudaSource("edge_mlp.cu")
FORWARD = Kernel(SOURCE, "tmd_edge_mlp_pre", [P] * 9 + [I64, I32, I32])
FUSED = Kernel(SOURCE, "tmd_edge_mlp", [P] * 9 + [I64, I32, I32])
_PRE_SPAN = 1024  # slots a kernel 3 block owns (kPreSpan)
_PRE_NARROW_F = 256  # the widest F whose kernel 3 tiles sit in shared memory


def image_floats(f: int) -> int:
    """Floats of kernel 3's scratch at ``F = f``: W2's split image, then
    W3's."""
    return tc_image_floats(f, 2 * f) + tc_image_floats(2 * f, 3 * f)


def _pre_ldh(f: int) -> int:
    """Row stride of kernel 3's h2 tile in the narrow form (F ≤ 256): 2F
    columns, and ``silu(pre1)`` [64, F] from column ``128·(⌈2F/128⌉ −
    ⌈F/128⌉)`` of the same rows."""
    a0 = 128 * (-(-2 * f // 128) - -(-f // 128))
    return max(2 * f, a0 + f) + 4


def pre_tile_floats(f: int) -> int:
    """Floats of one block's tiles in kernel 3's wide form (F > 256; 0 at
    or below): h2 ``[64, 2F + 4]`` and ``silu(pre1)`` ``[64, F + 4]``."""
    return 64 * (3 * f + 8) if f > _PRE_NARROW_F else 0


def pre_smem(f: int) -> int:
    """Dynamic shared memory of a kernel 3 launch: 1 KB to align the
    region, the region (the ring of ``tc_product_from``), in the narrow
    form the h2 tile that also holds ``silu(pre1)``, the tile's cw, then
    the span's live and dead offsets and the warp counts."""
    tiles = 64 * _pre_ldh(f) if f <= _PRE_NARROW_F else 0
    return 1024 + 4 * (REGION + tiles + 64) + 4 * (2 * _PRE_SPAN + 16)


def fused_smem(r: int, f: int, rows: int = 64) -> int:
    """Dynamic shared memory of a kernel 4 launch on tiles of ``rows``
    slots: the x, h1 and h2 tiles (each padded by 4), a 32 x 128 weight
    tile, cw, then the span's live and dead offsets and the warp
    counts."""
    return 4 * (rows * (r + f + 2 * f + 12) + 32 * 128 + rows) \
        + 4 * (512 + 16)


def fused_rows(r: int, f: int) -> int:
    """Slots of a kernel 4 tile: 64, or the largest of 32 and 16 whose
    plan fits a block's 232,448 B (the sums' order is the same)."""
    rows = 64
    while rows > 16 and fused_smem(r, f, rows) > SMEM_LIMIT:
        rows //= 2
    return rows


def pre_plan_error(f: int):
    """Why kernel 3 cannot launch at ``F = f``, or None: F a positive
    multiple of 4.  Every such width launches (the tiles of F > 256 go to
    device memory); a scratch larger than the card's free memory fails at
    its allocation."""
    if f % 4 or f < 4:
        return f"F = {f} must be a positive multiple of 4"
    return None


def fused_plan_error(r: int, f: int):
    """Why kernel 4 cannot launch at ``R = r``, ``F = f``, or None: both
    positive multiples of 4, and the plan of 16-slot tiles within a
    block's shared memory (up to F ≈ 1,000)."""
    if r % 4 or f % 4 or r < 4 or f < 4:
        return f"widths R = {r}, F = {f} must be positive multiples of 4"
    smem = fused_smem(r, f, fused_rows(r, f))
    if smem > SMEM_LIMIT:
        return f"R = {r}, F = {f} needs {smem} bytes of shared memory " \
               f"at 16-slot tiles (> {SMEM_LIMIT})"
    return None


def launch_plan(e: int, f: int, sms: int = H100_SMS) -> dict:
    """``(blocks, span, dynamic shared memory, image floats, tile floats)``
    of kernel 3 at ``e`` slots and ``F = f`` on a card of ``sms`` SMs;
    block ``b`` owns the spans ``b, b + blocks, …`` of ``span`` slots below
    ``e``: one span each for F ≤ 256, one block an SM above, each with
    its ``pre_tile_floats`` of the tile scratch."""
    spans = -(-e // _PRE_SPAN)
    blocks = spans if f <= _PRE_NARROW_F else max(1, min(spans, sms))
    return {"edge_mlp_pre": (blocks, _PRE_SPAN, pre_smem(f), image_floats(f),
                             blocks * pre_tile_floats(f))}


def kernel_attributes(f: int) -> dict:
    """What the compiler and the launch give kernel 3 at ``F = f``:
    registers and local (spill) bytes a thread, static and dynamic shared
    memory a block, resident blocks an SM, and the floats of its image
    scratch.  Builds the library; launches nothing."""
    out = (ctypes.c_int * 5)()
    lib = SOURCE.library()
    fn = lib.tmd_edge_mlp_attributes
    fn.argtypes = [I32, P]
    fn.restype = I32
    lib.tmd_edge_mlp_image_floats.argtypes = [I32]
    lib.tmd_edge_mlp_image_floats.restype = I32
    rc = fn(f, ctypes.cast(out, P))
    if rc != 0:
        raise RuntimeError(f"tmd_edge_mlp_attributes: CUDA error {rc}")
    lib.tmd_edge_mlp_tile_floats.argtypes = [I32]
    lib.tmd_edge_mlp_tile_floats.restype = I64
    attrs = dict(zip(("registers", "local_bytes", "static_smem",
                      "dynamic_smem", "blocks_per_sm"), out))
    attrs["image_floats"] = lib.tmd_edge_mlp_image_floats(f)
    attrs["tile_floats"] = lib.tmd_edge_mlp_tile_floats(f)
    return {"edge_mlp_pre": attrs}


def edge_mlp_ref(x, cw, w1, b1, w2, b2, w3, b3):
    """Plain PyTorch chain of kernel 4 (port of ``edge_mlp_jnp``, ``:70``)."""
    h = F_.silu(torch.matmul(x, w1) + b1)
    h = F_.silu(torch.matmul(h, w2) + b2)
    h = F_.silu(torch.matmul(h, w3) + b3)
    return h * cw[..., None]


def edge_mlp_pre_ref(pre1, cw, w2, b2, w3, b3):
    """Plain PyTorch chain of kernel 3 (port of ``edge_mlp_pre_jnp``,
    ``:191``)."""
    h = F_.silu(pre1)
    h = F_.silu(torch.matmul(h, w2) + b2)
    h = F_.silu(torch.matmul(h, w3) + b3)
    return h * cw[..., None]


def _check(name, tensors: dict, shapes: dict, error):
    """Raise unless the plan fits (``error`` is its plan error) and the
    tensors are aligned float32 CUDA tensors of the given shapes."""
    if error:
        raise ValueError(f"{name}: {error}")
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expects CUDA tensors, got {dev}")
    check_cuda_args(name, tensors, dev)
    for key, t in tensors.items():
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")
    return dev


def edge_mlp_cuda(x, cw, w1, b1, w2, b2, w3, b3):
    """Kernel 4 on CUDA tensors: returns [N, K, 3F]."""
    n, k, r = x.shape
    f = w1.shape[-1]
    tensors = dict(x=x, cw=cw, w1=w1, b1=b1, w2=w2, b2=b2, w3=w3, b3=b3)
    shapes = dict(x=(n, k, r), cw=(n, k), w1=(r, f), b1=(f,), w2=(f, 2 * f),
                  b2=(2 * f,), w3=(2 * f, 3 * f), b3=(3 * f,))
    dev = _check("edge_mlp", tensors, shapes, fused_plan_error(r, f))
    out = torch.empty((n, k, 3 * f), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        FUSED(*(ptr(t) for t in tensors.values()), ptr(out), n * k, r, f)
    return out


def edge_mlp_pre_cuda(pre1, cw, w2, b2, w3, b3):
    """Kernel 3 on CUDA tensors: returns [N, K, 3F]."""
    n, k, f = pre1.shape
    tensors = dict(pre1=pre1, cw=cw, w2=w2, b2=b2, w3=w3, b3=b3)
    shapes = dict(pre1=(n, k, f), cw=(n, k), w2=(f, 2 * f), b2=(2 * f,),
                  w3=(2 * f, 3 * f), b3=(3 * f,))
    dev = _check("edge_mlp_pre", tensors, shapes, pre_plan_error(f))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    (grid, _, _, image_n, tiles_n), = launch_plan(n * k, f, sms).values()
    out = torch.empty((n, k, 3 * f), dtype=torch.float32, device=dev)
    image = torch.empty(image_n, dtype=torch.float32, device=dev)
    tiles = torch.empty(tiles_n, dtype=torch.float32, device=dev) \
        if tiles_n else None
    with torch.cuda.device(dev):
        FORWARD(ptr(pre1), ptr(cw), ptr(w2), ptr(b2), ptr(w3), ptr(b3),
                ptr(out), ptr(image), null_or_ptr(tiles), n * k, f, grid)
    return out


def _recompute_vjp(ref, inputs, needs, g, width):
    """Cotangents of ``ref(*inputs)`` (two row inputs ``[N, K, …]``, ``[N,
    K]``, then weights) by autograd over row chunks; ``width`` bounds the
    live ``[rows, K, ·]`` floats of the recompute per slot."""
    n, k = inputs[1].shape
    rows, weights = inputs[:2], inputs[2:]
    grads = [torch.empty_like(x) if w else None for x, w in zip(rows, needs)]
    grads += [torch.zeros_like(w) if wt else None
              for w, wt in zip(weights, needs[2:])]
    chunk = row_chunk(n, k, width, budget_bytes=2 * 1024 ** 3)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        with torch.enable_grad():
            args = [x[s:e].detach().requires_grad_(w)
                    for x, w in zip(rows, needs)]
            args += [w.detach().requires_grad_(wt)
                     for w, wt in zip(weights, needs[2:])]
            leaves = [a for a, w in zip(args, needs) if w]
            got = iter(torch.autograd.grad(ref(*args), leaves, g[s:e]))
        for i, w in enumerate(needs):
            if not w:
                continue
            if i < 2:
                grads[i][s:e] = next(got)
            else:
                grads[i] += next(got)
    return tuple(grads)


class _EdgeMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        if inputs[0].is_cuda:
            return edge_mlp_cuda(*inputs)
        return edge_mlp_ref(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        f = inputs[2].shape[-1]
        # live [rows, K, ·] tensors of the recompute: ~ R + F·3 + 2F·3 + 3F·4
        width = inputs[0].shape[-1] + 21 * f
        return _recompute_vjp(edge_mlp_ref, inputs,
                              list(ctx.needs_input_grad), g, width)


def fused_edge_mlp(x, cw, w1, b1, w2, b2, w3, b3):
    """``silu(silu(silu(x·W1+b1)·W2+b2)·W3+b3)·cw`` → [N, K, 3F] (see the
    module docstring)."""
    return _EdgeMlp.apply(x, cw, w1, b1, w2, b2, w3, b3)


class _EdgeMlpPre(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre1, cw, w2, b2, w3, b3):
        ctx.save_for_backward(pre1, cw, w2, b2, w3, b3)
        if pre1.is_cuda:
            return edge_mlp_pre_cuda(pre1, cw, w2, b2, w3, b3)
        return edge_mlp_pre_ref(pre1, cw, w2, b2, w3, b3)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        # live [rows, K, ·] tensors of the recompute: ~ F + 2F·3 + 3F·4 wide
        width = 19 * inputs[0].shape[-1]
        return _recompute_vjp(edge_mlp_pre_ref, inputs,
                              list(ctx.needs_input_grad), g, width)


def edge_mlp_pre(pre1, cw, w2, b2, w3, b3):
    """``silu(silu(silu(pre1)·W2+b2)·W3+b3)·cw`` → [N, K, 3F] (see the
    module docstring)."""
    return _EdgeMlpPre.apply(pre1, cw, w2, b2, w3, b3)
