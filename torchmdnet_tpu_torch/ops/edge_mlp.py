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
beside it.  Both kernels are one chain on the tensor cores in 3xTF32
(``csrc/tc_tile.cuh``, float32-accurate): they run it on the slots with
``cw ≠ 0`` only, in tiles of 64, and write exact zeros for the others;
kernel 4 forms its first layer ``silu(x·W1 + b1)`` in front of kernel 3's
two products.  The weights are split once per launch into a scratch the
wrapper allocates (:func:`image_floats`, :func:`fused_image_floats`);
:func:`launch_plan` holds each kernel's grid, scratch and shared memory:
one block an SM, each on a run of slots of equal cost (:func:`chain_ranges`,
from a first pass's live count of each 256-slot chunk), in whole tiles.
Where the tiles do not fit a block (kernel 3 above F = 256, kernel 4 also
where its x tile would pass the block's shared memory, :func:`chain_wide`)
they go to a second device-memory scratch, one region for each resident
block.  Every width launches (:func:`pre_plan_error`,
:func:`fused_plan_error`): the kernels read float4 rows, so for an F or R
that is not a multiple of 4 the wrappers pad the operands with zero lanes
to the next multiple (:func:`padded`: pre1's or x's columns, W1's rows
and columns, each F-run of the other weights and biases) and slice the
output.  That is exact: silu(0) = 0, so a padded lane's activation is
zero at every layer, and the zero weight rows keep it out of every real
lane.

The backward recomputes through the plain chain, as the JAX
``_bwd``/``_bwd_pre`` (``:118``, ``:237``) do (the JAX package has no
backward kernel for these ops).  A first-order call (MD, a force pass
without ``create_graph``) runs it over detached row chunks.  Under
``create_graph`` (grad mode on inside the backward: force training) it
builds a graph instead, the plain chain on the saved inputs and
``torch.autograd.grad(..., create_graph=True)``, as JAX differentiates
``jax.vjp(edge_mlp_jnp, ...)`` again, so the second order reaches the
weights.  That graph is unchunked: it holds ~24F floats a slot (the
chain's activations and those of its vjp), ~12 KB at F = 128.  At the
AceFF training batch (16 molecules, ~860 atoms, K = 64) that is ~0.7 GB a
call, four calls a TensorNet2 evaluation (two layers, each edge and
reverse-edge weights); at the north star's 25,088 atoms and K = 96 it
would be ~30 GB a call.
"""

import bisect
import ctypes

import torch
import torch.nn.functional as F_

from torchmdnet_tpu_torch.ops.kernels import (
    I32, I64, P, CudaSource, Kernel, check_cuda_args, lane_width,
    null_or_ptr, pad_runs, ptr, unpad_lanes)
from torchmdnet_tpu_torch.ops.message_passing import row_chunk
from torchmdnet_tpu_torch.ops.tc_tile import H100_SMS, REGION, SMEM_LIMIT
from torchmdnet_tpu_torch.ops.tc_tile import image_floats as tc_image_floats

SOURCE = CudaSource("edge_mlp.cu")
FORWARD = Kernel(SOURCE, "tmd_edge_mlp_pre", [P] * 10 + [I64, I32, I32])
FUSED = Kernel(SOURCE, "tmd_edge_mlp", [P] * 12 + [I64] + [I32] * 3)
CHUNK = 256  # slots of one live count (kChunk)
WINDOW = 1024  # slots a block compacts at a time (kWin)
LIVE_WEIGHT = 16  # a live slot's cost in slots with cw = 0 (kLiveWeight)
_PRE_NARROW_F = 256  # the widest F whose tiles may sit in shared memory


def image_floats(f: int) -> int:
    """Floats of kernel 3's scratch at ``F = f``: W2's split image, then
    W3's."""
    return tc_image_floats(f, 2 * f) + tc_image_floats(2 * f, 3 * f)


def fused_image_floats(r: int, f: int) -> int:
    """Floats of kernel 4's scratch at ``R = r``, ``F = f``: W1's split
    image, then W2's and W3's."""
    return tc_image_floats(r, f) + image_floats(f)


def _pre_ldh(f: int) -> int:
    """Row stride of the h2 tile in the narrow form: 2F columns, and the
    W2 product's A ``[64, F]`` from column ``128·(⌈2F/128⌉ − ⌈F/128⌉)`` of
    the same rows."""
    a0 = 128 * (-(-2 * f // 128) - -(-f // 128))
    return max(2 * f, a0 + f) + 4


def x_ld(r: int) -> int:
    """Row stride of kernel 4's x tile: ``R`` rounded up to 32, plus 4."""
    return -(-r // 32) * 32 + 4


def chain_smem(f: int, r: int, wide: bool) -> int:
    """Dynamic shared memory of a launch at ``F = f`` (``r = 0``: kernel
    3; else kernel 4 at ``R = r``): 1 KB to align the region, the region
    (the ring of ``tc_product_from``), in the narrow form the h2 tile that
    also holds the W2 product's A and kernel 4's x tile, the tile's cw,
    then the lists (``kListInts``: a window's live slots and the 64 held
    over, its dead slots, the warp counts)."""
    tiles = 0 if wide else 64 * (_pre_ldh(f) + (x_ld(r) if r else 0))
    lists = (WINDOW + 64) + WINDOW + 2 * 8
    return 1024 + 4 * (REGION + tiles + 64) + 4 * lists


def chain_wide(f: int, r: int = 0) -> bool:
    """Whether the tiles go to device memory: above F = 256, and for
    kernel 4 (``r > 0``) where its narrow tiles pass a block."""
    return f > _PRE_NARROW_F or (
        r > 0 and chain_smem(f, r, False) > SMEM_LIMIT)


def pre_tile_floats(f: int) -> int:
    """Floats of one block's tiles in kernel 3's wide form (F > 256; 0 at
    or below): h2 ``[64, 2F + 4]`` and ``silu(pre1)`` ``[64, F + 4]``."""
    return 64 * (3 * f + 8) if chain_wide(f) else 0


def fused_tile_floats(r: int, f: int) -> int:
    """Floats of one block's tiles in kernel 4's wide form (0 in the
    narrow one): h2 ``[64, 2F + 4]``, its first layer ``[64, F + 4]`` and
    x ``[64, x_ld(R)]``."""
    return 64 * (3 * f + 8 + x_ld(r)) if chain_wide(f, r) else 0


def pre_smem(f: int) -> int:
    """Dynamic shared memory of a kernel 3 launch."""
    return chain_smem(f, 0, chain_wide(f))


def fused_smem(r: int, f: int) -> int:
    """Dynamic shared memory of a kernel 4 launch."""
    return chain_smem(f, r, chain_wide(f, r))


def pre_plan_error(f: int):
    """Why kernel 3 cannot launch at ``F = f``, or None: F ≥ 1.  Every
    such width launches (one not a multiple of 4 padded to one,
    :func:`padded`; the tiles of F > 256 go to device memory); a scratch
    larger than the card's free memory fails at its allocation."""
    if f < 1:
        return f"F = {f} must be >= 1"
    return None


def fused_plan_error(r: int, f: int):
    """Why kernel 4 cannot launch at ``R = r``, ``F = f``, or None: both ≥
    1.  Every such pair launches (widths padded to multiples of 4,
    :func:`padded`; the tiles go to device memory where they do not fit
    a block)."""
    if r < 1 or f < 1:
        return f"widths R = {r}, F = {f} must be >= 1"
    return None


# the F-runs and R-runs of each operand, ((dim, runs), …): a width that is
# not a multiple of 4 is padded with zero lanes in each (see the module
# docstring)
F_RUNS = {"pre1": ((-1, 1),), "w1": ((1, 1),), "b1": ((0, 1),),
          "w2": ((0, 1), (1, 2)), "b2": ((0, 2),), "w3": ((0, 2), (1, 3)),
          "b3": ((0, 3),)}
R_RUNS = {"x": ((-1, 1),), "w1": ((0, 1),)}


def padded(tensors: dict, f: int, r: int = 4) -> list:
    """``tensors`` (kernel 3's or 4's operands by name) with F and R
    widened to multiples of 4 (:data:`F_RUNS`, :data:`R_RUNS`)."""
    tensors = pad_runs(tensors, R_RUNS, lane_width(r))
    return list(pad_runs(tensors, F_RUNS, lane_width(f)).values())


def chain_ranges(counts, e: int, grid: int) -> list:
    """The chunks ``[lo, hi)`` each of ``grid`` blocks owns, as the
    kernels' ``range_kernel`` finds them from the live count of each
    256-slot chunk of ``e`` slots: with ``cost(c) = LIVE_WEIGHT·counts[c]
    + the chunk's slots`` and ``P(c)`` the cost before chunk ``c``, block
    ``b`` owns the chunks with ``b·T ≤ P(c)·grid < (b + 1)·T``."""
    scaled, total = [], 0  # P(c)·grid, increasing
    for c, n in enumerate(counts):
        scaled.append(total * grid)
        total += LIVE_WEIGHT * n + min(CHUNK, e - c * CHUNK)
    bounds = [bisect.bisect_left(scaled, b * total) for b in range(grid + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def launch_plan(e: int, f: int, sms: int = H100_SMS, r=None) -> dict:
    """``(blocks, chunks, dynamic shared memory, image floats, tile
    floats)`` of kernel 3 at ``e`` slots and ``F = f`` on a card of
    ``sms`` SMs, and with ``r`` of kernel 4 at ``R = r`` too: one block
    an SM (at most one a 256-slot chunk), each owning the run of chunks
    :func:`chain_ranges` gives it; ``chunks`` live counts and ``blocks +
    1`` run starts make the int scratch.  In a wide form each block has
    its tile floats of the tile scratch."""
    chunks = -(-e // CHUNK)
    blocks = max(1, min(sms, chunks))
    plan = {"edge_mlp_pre": (blocks, chunks, pre_smem(f), image_floats(f),
                             blocks * pre_tile_floats(f))}
    if r is not None:
        plan["edge_mlp"] = (blocks, chunks, fused_smem(r, f),
                            fused_image_floats(r, f),
                            blocks * fused_tile_floats(r, f))
    return plan


def kernel_attributes(f: int, r=None) -> dict:
    """What the compiler and the launch give kernel 3 at ``F = f`` (and
    with ``r`` kernel 4 at ``R = r``): registers and local (spill) bytes
    a thread, static and dynamic shared memory a block, resident blocks
    an SM, and the floats of its image scratch and of one block's tiles.
    Builds the library; launches nothing."""
    out = (ctypes.c_int * 5)()
    lib = SOURCE.library()
    fn = lib.tmd_edge_mlp_attributes
    fn.argtypes = [I32, I32, P]
    fn.restype = I32
    lib.tmd_edge_mlp_image_floats.argtypes = [I32]
    lib.tmd_edge_mlp_image_floats.restype = I32
    lib.tmd_edge_mlp_fused_image_floats.argtypes = [I32, I32]
    lib.tmd_edge_mlp_fused_image_floats.restype = I32
    lib.tmd_edge_mlp_tile_floats.argtypes = [I32, I32]
    lib.tmd_edge_mlp_tile_floats.restype = I64
    attrs = {}
    for name, rr in (("edge_mlp_pre", 0), ("edge_mlp", r)):
        if rr is None:
            continue
        rc = fn(f, rr, ctypes.cast(out, P))
        if rc != 0:
            raise RuntimeError(f"tmd_edge_mlp_attributes: CUDA error {rc}")
        attrs[name] = dict(zip(("registers", "local_bytes", "static_smem",
                                "dynamic_smem", "blocks_per_sm"), out))
        attrs[name]["image_floats"] = (
            lib.tmd_edge_mlp_fused_image_floats(rr, f) if rr
            else lib.tmd_edge_mlp_image_floats(f))
        attrs[name]["tile_floats"] = lib.tmd_edge_mlp_tile_floats(f, rr)
    return attrs


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
    if r % 4 or f % 4:
        return unpad_lanes(edge_mlp_cuda(*padded(tensors, f, r)), -1, 3, f)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid, chunks, _, image_n, tiles_n = launch_plan(n * k, f, sms,
                                                    r)["edge_mlp"]
    out = torch.empty((n, k, 3 * f), dtype=torch.float32, device=dev)
    image, tiles, counts = _scratch(image_n, tiles_n, chunks + grid + 1, dev)
    with torch.cuda.device(dev):
        FUSED(*(ptr(t) for t in tensors.values()), ptr(out), ptr(image),
              null_or_ptr(tiles), ptr(counts), n * k, r, f, grid)
    return out


def _scratch(image_n, tiles_n, ints, dev):
    """The split weights' image, the wide form's tiles (None in the
    narrow form) and the chunks' live counts and the blocks' run starts
    of a launch."""
    image = torch.empty(image_n, dtype=torch.float32, device=dev)
    tiles = torch.empty(tiles_n, dtype=torch.float32, device=dev) \
        if tiles_n else None
    return image, tiles, torch.empty(ints, dtype=torch.int32, device=dev)


def edge_mlp_pre_cuda(pre1, cw, w2, b2, w3, b3):
    """Kernel 3 on CUDA tensors: returns [N, K, 3F]."""
    n, k, f = pre1.shape
    tensors = dict(pre1=pre1, cw=cw, w2=w2, b2=b2, w3=w3, b3=b3)
    shapes = dict(pre1=(n, k, f), cw=(n, k), w2=(f, 2 * f), b2=(2 * f,),
                  w3=(2 * f, 3 * f), b3=(3 * f,))
    dev = _check("edge_mlp_pre", tensors, shapes, pre_plan_error(f))
    if f % 4:
        return unpad_lanes(edge_mlp_pre_cuda(*padded(tensors, f)), -1, 3, f)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid, chunks, _, image_n, tiles_n = launch_plan(n * k, f,
                                                    sms)["edge_mlp_pre"]
    out = torch.empty((n, k, 3 * f), dtype=torch.float32, device=dev)
    image, tiles, counts = _scratch(image_n, tiles_n, chunks + grid + 1, dev)
    with torch.cuda.device(dev):
        FORWARD(ptr(pre1), ptr(cw), ptr(w2), ptr(b2), ptr(w3), ptr(b3),
                ptr(out), ptr(image), null_or_ptr(tiles), ptr(counts), n * k,
                f, grid)
    return out


def _recompute_vjp(ref, inputs, needs, g, width):
    """Cotangents of ``ref(*inputs)`` (two row inputs ``[N, K, …]``, ``[N,
    K]``, then weights).  With grad mode on (under ``create_graph``) by
    autograd through the plain chain on the saved inputs, keeping the
    graph; otherwise by autograd over detached row chunks, where ``width``
    bounds the live ``[rows, K, ·]`` floats of the recompute per slot."""
    if torch.is_grad_enabled():
        leaves = [x for x, w in zip(inputs, needs) if w]
        got = iter(torch.autograd.grad(ref(*inputs), leaves, g,
                                       create_graph=True))
        return tuple(next(got) if w else None for w in needs)
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
