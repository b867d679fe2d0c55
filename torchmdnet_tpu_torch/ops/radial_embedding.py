"""TensorNet's radial tensor embedding (kernels 1 and 2 of the port).

Counterpart of ``torchmdnet_tpu/ops/pallas_embedding.py``: the distance
projections ``dp = ea @ kall + ball``, the cutoff/pair product
``cz = C·(zw1_i + zw2g)·mask`` and the nine radial reductions
``I = Σ_k w0``, ``A_d = Σ_k w1·v̂_d``, ``S_c = Σ_k w2·s5_c(v̂)`` in one op
whose output is ``[N, 9F] = (I, A×3, S×5)``.

On a CUDA tensor the forward and the backward are the hand-written kernels
of ``csrc/radial_embedding.cu`` or raise; on a CPU tensor they are the
plain PyTorch chain :func:`radial_embedding_ref` and its autograd.  The
backward gives the mask a zero cotangent, as the TPU kernel does
(``pallas_embedding.py:301``).  The backward is an op of its own,
``_RadialEmbeddingBwd`` (JAX ``_bwd_op``, ``:304-332``): its forward is
kernel 2 (or :func:`radial_embedding_bwd_ref` on the CPU) and its backward
the double vjp of the plain chain (:func:`radial_embedding_double_vjp`),
so a force loss's gradient in the weights (training) runs kernel 2 in the
force pass and plain PyTorch in the second order, as JAX runs jnp there.
A third derivative raises.

Both kernels run their products (``ea·kall``, and in the backward the
cotangent ``dd·kallᵀ`` and, for ``dkall``, ``eaᵀ·dd``) on the tensor
cores in 3xTF32 (``csrc/tc_tile.cuh``, float32-accurate), on the valid
slots only (a masked slot's outputs are exact zeros).  Where a block's
tiles do not fit its shared memory (the forward above F = 512, the
backward above F = 128) each resident block keeps them in its region of a
scratch the wrapper allocates (:func:`emb_tile_floats`) and the grid is
one block an SM (the wide form; a kernel takes it where it is given a tile
scratch).  :func:`launch_plan` holds the grid, shared memory and scratches;
every rbf width and every F launches (:func:`emb_plan_error`): the kernels
read float4 rows, so for an F that is not a multiple of 4 the wrappers pad
the channel operands (zw1, zw2g, each F-run of kall, ball and g) with zero
lanes to the next multiple (:data:`RUNS`) and slice the outputs.  That
is exact: a zero lane of zw1 and zw2g zeroes the pair factor cz there and
a zero lane of kall and ball the projection dp, so no padded lane reaches
a real output or cotangent, and the padded lanes' outputs are dropped.
"""

import ctypes

import torch

from torchmdnet_tpu_torch.ops.kernels import (
    I32, I64, P, CudaSource, Kernel, check_cuda_args, first_order_only,
    lane_width, null_or_ptr, pad_runs, ptr, unpad_lanes, unpad_runs)
from torchmdnet_tpu_torch.ops.message_passing import row_chunk
from torchmdnet_tpu_torch.ops.tc_tile import H100_SMS, SMEM_LIMIT

SOURCE = CudaSource("radial_embedding.cu")
# the ten inputs (backward: then g, kall, ball, the nine outputs and
# part), out (forward), tiles, then n, k, r, f, grid
FORWARD = Kernel(SOURCE, "tmd_radial_embedding_fwd",
                 [P] * 12 + [I64] + [I32] * 4)
BACKWARD = Kernel(SOURCE, "tmd_radial_embedding_bwd",
                  [P] * 22 + [I64] + [I32] * 4)
# atom rows a block owns, slots it compacts at a time, floats of the B
# planes (four k stages of a hi and a lo 64 x 16 plane) and of kernel 1's
# wᵀ tile ([128, 64 + 4])
_ROWS, _CHUNK, _PLANES, _WT = 16, 4096, 4 * 2 * 64 * 16, 128 * 68
# the kernels of mode 0 (kernel 1), 1 (kernel 2) and 2 (kernel 2 with
# dkall and dball), and the widest F whose tiles sit in shared memory
MODES = ("radial_embedding_fwd", "radial_embedding_bwd",
         "radial_embedding_bwd_dk")
_NARROW_F = (512, 128, 128)


def emb_wide(f: int, mode: int) -> bool:
    """Whether mode's tiles go to device memory at ``F = f`` (the wide
    form): past the widest F whose tiles sit in shared memory."""
    return f > _NARROW_F[mode]


def emb_tile_floats(f: int, mode: int = 1) -> int:
    """Floats of one block's tiles at ``F = f``, wherever they live: the
    channel tile ``[64, F + 4]`` (kernel 1's cz, kernel 2's dzw2g) and in
    kernel 2 (modes 1, 2) the D tile ``[64, 3F + 4]``."""
    return 64 * (f + 4) + (64 * (3 * f + 4) if mode else 0)


def emb_smem(f: int, k: int, mode: int = 1, r: int = 0,
             kall_smem: bool = False, wide: bool | None = None) -> int:
    """Dynamic shared memory of a launch of mode 0 (kernel 1), 1 (kernel
    2) or 2 (kernel 2 with dk), as ``radial_embedding.cu::emb_smem`` lays
    it out: 1 KB to align the planes, the B planes of the products (in
    kernel 1 only the ⌈r/16⌉ stages of its ea operand, up to four), with
    ``kall_smem`` kall ``[r, 3F + 4]``, kernel 1's wᵀ tile, the tiles
    where they sit in shared memory, the per-slot floats (kernel 1: C·em
    and nine irrep factors; kernel 2: C·em, em and v̂), the tile's rows and
    slot offsets, kernel 1's row segments (64 + 2) and their two ballot
    masks, the warp counts and the 16-bit slot ids of a compaction pass.
    ``wide``: the form (None: :func:`emb_wide`)."""
    if wide is None:
        wide = emb_wide(f, mode)
    tiles = 0 if wide else emb_tile_floats(f, mode)
    planes = _PLANES if mode else _PLANES // 4 * min(4, -(-r // 16))
    floats = planes + (r * (3 * f + 4) if kall_smem else 0) \
        + (_WT if mode == 0 else 0) + tiles + (10 if mode == 0 else 5) * 64
    ints = 2 * 64 + (64 + 4 if mode == 0 else 0) + 8
    return 1024 + 4 * floats + 4 * ints + 2 * min(_ROWS * k, _CHUNK)


def emb_kall_smem(f: int, k: int, r: int, mode: int,
                  wide: bool | None = None) -> bool:
    """Whether kall, which the products read at every k stage, is staged
    in shared memory (``radial_embedding.cu::emb_kall_smem``): in kernel
    2 where the block's plan leaves it room; kernel 1 reads it from device
    memory, as staged its ~158 KB (F = 128, R = 32) would leave one block
    an SM, not two."""
    return mode > 0 and emb_smem(f, k, mode, r, True, wide) <= SMEM_LIMIT


def launch_plan(n: int, k: int, r: int, f: int, mode: int = 1,
                sms: int = H100_SMS, wide: bool | None = None) -> dict:
    """Mode 0 (kernel 1), 1 (kernel 2) or 2 (kernel 2 with dk) at ``n``
    atom rows of ``k`` slots, ``R = r`` and ``F = f`` on a card of ``sms``
    SMs: ``(blocks, rows a row block, slots a compaction pass, dynamic
    shared memory, tile floats, partial floats, kall staged in shared
    memory (:func:`emb_kall_smem`))``.  Block ``b`` owns the row blocks
    ``b, b + blocks, …`` below ``⌈n/rows⌉``: one each where the tiles sit
    in shared memory, one block an SM in the wide form (each with its
    ``emb_tile_floats`` of the tile scratch) and in the dk form (each with
    its partial row of ``(R + 1)·3F`` floats).  ``wide`` forces the form
    (None: :func:`emb_wide`)."""
    row_blocks = -(-n // _ROWS)
    if wide is None:
        wide = emb_wide(f, mode)
    blocks = row_blocks if not wide and mode < 2 \
        else max(1, min(row_blocks, sms))
    kall_smem = emb_kall_smem(f, k, r, mode, wide)
    return {MODES[mode]: (
        blocks, _ROWS, min(_ROWS * k, _CHUNK),
        emb_smem(f, k, mode, r, kall_smem, wide),
        blocks * emb_tile_floats(f, mode) if wide else 0,
        blocks * (r + 1) * 3 * f if mode == 2 else 0, kall_smem)}


def emb_plan_error(k: int, r: int, f: int):
    """Why kernels 1 and 2 cannot launch at ``K = k`` slots, ``R = r``,
    ``F = f``, or None: at least one channel and one rbf channel.  Every
    such width and any K launch: an F that is not a multiple of 4 is
    padded to one (:data:`RUNS`), the plan's shared memory stays within
    a block's 232,448 B (:func:`emb_smem`; the tiles of wide F go to
    device memory), and a scratch larger than the card's free memory fails
    at its allocation."""
    if f < 1:
        return f"channels {f} must be >= 1"
    if r < 1:
        return f"rbf width {r} must be >= 1"
    return None


def kernel_attributes(f: int, k: int, r: int,
                      wide: bool | None = None) -> dict:
    """What the compiler and the launch give kernel 1, kernel 2 and
    kernel 2 with dk at ``(F, K, R)`` as :func:`launch_plan` plans them
    (in the form ``wide``; None: :func:`emb_wide`):
    registers and local (spill) bytes a thread, static and dynamic shared
    memory a block, resident blocks an SM, whether kall is staged in
    shared memory and the floats of one block's tiles in device memory (0
    where they sit in shared memory).  Builds the library; launches
    nothing."""
    lib = SOURCE.library()
    fn = lib.tmd_radial_embedding_attributes
    fn.argtypes = [I32] * 5 + [P]
    fn.restype = I32
    tiles = lib.tmd_radial_embedding_tile_floats
    tiles.argtypes = [I32, I32]
    tiles.restype = I64
    attrs = {}
    for mode, name in enumerate(MODES):
        form = emb_wide(f, mode) if wide is None else wide
        out = (ctypes.c_int * 6)()
        rc = fn(mode, int(form), f, k, r, ctypes.cast(out, P))
        if rc != 0:
            raise RuntimeError(
                f"tmd_radial_embedding_attributes: CUDA error {rc}")
        attrs[name] = dict(zip(("registers", "local_bytes", "static_smem",
                                "dynamic_smem", "blocks_per_sm"), out))
        attrs[name]["kall_smem"] = bool(out[5])
        attrs[name]["tile_floats"] = tiles(mode, f) if form else 0
    return attrs


def radial_embedding_ref(edge_attr, C, vx, vy, vz, zw1, zw2g, emask_f, kall,
                         ball):
    """Plain PyTorch chain (port of ``radial_embedding_jnp``, ``:40``).

    edge_attr [N,K,R]; C/vx/vy/vz/emask_f [N,K]; zw1 [N,F]; zw2g [N,K,F]
    (masked gather of the pair-linear half); kall [R,3F]; ball [3F].
    Returns [N, 9F]."""
    f = zw1.shape[-1]
    dp = torch.matmul(edge_attr, kall) + ball
    cz = C[..., None] * (zw1[:, None, :] + zw2g) * emask_f[..., None]
    w0 = cz * dp[..., :f]
    w1 = cz * dp[..., f:2 * f]
    w2 = cz * dp[..., 2 * f:]
    tr3 = (vx * vx + vy * vy + vz * vz) / 3.0
    blocks = [
        w0.sum(1),
        (w1 * vx[..., None]).sum(1),
        (w1 * vy[..., None]).sum(1),
        (w1 * vz[..., None]).sum(1),
        (w2 * (vx * vx - tr3)[..., None]).sum(1),
        (w2 * (vx * vy)[..., None]).sum(1),
        (w2 * (vx * vz)[..., None]).sum(1),
        (w2 * (vy * vy - tr3)[..., None]).sum(1),
        (w2 * (vy * vz)[..., None]).sum(1),
    ]
    return torch.cat(blocks, dim=-1)


def radial_embedding_bwd_ref(inputs, g, needs):
    """Cotangents of :func:`radial_embedding_ref` by autograd over row
    chunks (the full-width recompute would hold several [N, K, 3F]
    temporaries).  ``needs``: which of the ten inputs want a gradient.
    Returns (dea, dC, dvx, dvy, dvz, dzw1, dzw2g, dkall, dball), None where
    not wanted; the mask gets none."""
    ea, C, vx, vy, vz, zw1, zw2g, em, kall, ball = inputs
    n, k, _ = ea.shape
    f = zw1.shape[-1]
    rows = (ea, C, vx, vy, vz, zw1, zw2g)
    want = [bool(x) for x in needs[:7]] + [bool(needs[8]), bool(needs[9])]
    grads = [torch.empty_like(x) if w else None for x, w in zip(rows, want)]
    grads += [torch.zeros_like(kall) if want[7] else None,
              torch.zeros_like(ball) if want[8] else None]
    chunk = row_chunk(n, k, 12 * f)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        with torch.enable_grad():
            args = [x[s:e].detach().requires_grad_(w)
                    for x, w in zip(rows, want)]
            args += [kall.detach().requires_grad_(want[7]),
                     ball.detach().requires_grad_(want[8])]
            out = radial_embedding_ref(*args[:7], em[s:e], *args[7:])
            leaves = [a for a, w in zip(args, want) if w]
            got = iter(torch.autograd.grad(out, leaves, g[s:e]))
        for i, w in enumerate(want):
            if not w:
                continue
            if i < 7:
                grads[i][s:e] = next(got)
            else:
                grads[i] += next(got)
    return tuple(grads)


_NAMES = ("edge_attr", "C", "vx", "vy", "vz", "zw1", "zw2g", "emask_f",
          "kall", "ball")


def _check_cuda(name, tensors, n, k, r, f):
    """Raise unless the widths launch (:func:`emb_plan_error`, before the
    device is looked at) and every tensor is an aligned float32 CUDA
    tensor of its shape."""
    error = emb_plan_error(k, r, f)
    if error:
        raise ValueError(f"{name}: {error}")
    dev = tensors["edge_attr"].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expects CUDA tensors, got {dev}")
    check_cuda_args(name, tensors, dev)
    shapes = {"edge_attr": (n, k, r), "C": (n, k), "vx": (n, k), "vy": (n, k),
              "vz": (n, k), "zw1": (n, f), "zw2g": (n, k, f),
              "emask_f": (n, k), "kall": (r, 3 * f), "ball": (3 * f,),
              "g": (n, 9 * f)}
    for key, t in tensors.items():
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")
    return dev


# the F-runs of each operand and cotangent, ((dim, runs), …): an F that is
# not a multiple of 4 is padded with zero lanes in each (see the module
# docstring); kernel 2's cotangents carry their operands' runs
RUNS = {"zw1": ((-1, 1),), "zw2g": ((-1, 1),), "kall": ((-1, 3),),
        "ball": ((-1, 3),), "g": ((-1, 9),)}
_GRADS = ("edge_attr", "C", "vx", "vy", "vz", "zw1", "zw2g", "kall", "ball")


def _scratch(dev, n, k, r, f, mode, wide):
    """The plan's grid and its tile and partial scratch on dev."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    (grid, _, _, _, tiles_n, part_n, _), = launch_plan(
        n, k, r, f, mode, sms, wide).values()

    def new(count):
        return torch.empty(count, dtype=torch.float32, device=dev) \
            if count else None
    return grid, new(tiles_n), new(part_n)


def radial_embedding_fwd_cuda(edge_attr, C, vx, vy, vz, zw1, zw2g, emask_f,
                              kall, ball, wide=None):
    """Kernel 1 on CUDA tensors: returns [N, 9F].  ``wide``: the form
    (None: the plan's, :func:`emb_wide`)."""
    n, k, r = edge_attr.shape
    f = zw1.shape[-1]
    inputs = (edge_attr, C, vx, vy, vz, zw1, zw2g, emask_f, kall, ball)
    dev = _check_cuda("radial_embedding_fwd", dict(zip(_NAMES, inputs)),
                      n, k, r, f)
    if f % 4:
        padded = pad_runs(dict(zip(_NAMES, inputs)), RUNS, lane_width(f))
        return unpad_lanes(radial_embedding_fwd_cuda(*padded.values(),
                                                     wide=wide), -1, 9, f)
    out = torch.empty((n, 9 * f), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        grid, tiles, _ = _scratch(dev, n, k, r, f, 0, wide)
        FORWARD(*(ptr(t) for t in inputs), ptr(out), null_or_ptr(tiles),
                n, k, r, f, grid)
    return out


def radial_embedding_bwd_cuda(inputs, g, want_dz: bool, want_dk: bool,
                              wide=None):
    """Kernel 2 on CUDA tensors: returns (dea, dC, dvx, dvy, dvz, dzw1,
    dzw2g, dkall, dball); dzw1/dzw2g are None unless ``want_dz``,
    dkall/dball None unless ``want_dk``.  ``wide``: the form (None: the
    plan's, :func:`emb_wide`)."""
    edge_attr, C, vx, vy, vz, zw1, zw2g, emask_f, kall, ball = inputs
    n, k, r = edge_attr.shape
    f = zw1.shape[-1]
    tensors = dict(zip(_NAMES, inputs), g=g)
    dev = _check_cuda("radial_embedding_bwd", tensors, n, k, r, f)
    if f % 4:
        padded = pad_runs(tensors, RUNS, lane_width(f))
        g = padded.pop("g")
        grads = radial_embedding_bwd_cuda(tuple(padded.values()), g, want_dz,
                                          want_dk, wide=wide)
        return tuple(unpad_runs(dict(zip(_GRADS, grads)), RUNS, f).values())

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dea, dC, dvx, dvy, dvz = new(n, k, r), new(n, k), new(n, k), new(n, k), new(n, k)
    dzw1 = new(n, f) if want_dz else None
    dzw2g = new(n, k, f) if want_dz else None
    if n == 0:
        zeros = [torch.zeros((r, 3 * f), device=dev),
                 torch.zeros(3 * f, device=dev)] if want_dk else [None] * 2
        return (dea, dC, dvx, dvy, dvz, dzw1, dzw2g, *zeros)
    dkall = new(r, 3 * f) if want_dk else None
    dball = new(3 * f) if want_dk else None
    with torch.cuda.device(dev):
        grid, tiles, part = _scratch(dev, n, k, r, f, 2 if want_dk else 1,
                                     wide)
        BACKWARD(*(ptr(t) for t in inputs[:8]), ptr(g), ptr(kall), ptr(ball),
                 ptr(dea), ptr(dC), ptr(dvx), ptr(dvy), ptr(dvz),
                 null_or_ptr(dzw1), null_or_ptr(dzw2g), null_or_ptr(dkall),
                 null_or_ptr(dball), null_or_ptr(part), null_or_ptr(tiles),
                 n, k, r, f, grid)
    return dea, dC, dvx, dvy, dvz, dzw1, dzw2g, dkall, dball


def radial_embedding_double_vjp(inputs, g, first, cts, needs):
    """The second order of the embedding: the cotangents of the inputs and
    of ``g`` given the cotangents ``cts`` of the first-order outputs
    ``first`` (their input indices, 7 (the mask) left out), by autograd
    through autograd of :func:`radial_embedding_ref` over row chunks (JAX
    ``_bwd_op_bwd``'s ``jax.vjp`` of the jnp first order, ``:320-328``).
    ``needs``: which of the ten inputs and ``g`` want one.  Returns eleven
    items, None where not wanted."""
    n, k, _ = inputs[0].shape
    f = inputs[5].shape[-1]
    rows, weights = list(inputs[:8]) + [g], inputs[8:]
    want = list(needs[:8]) + [needs[10]] + list(needs[8:10])
    grads = [torch.zeros_like(x) if w else None
             for x, w in zip(rows + list(weights), want)]
    used = [(i, ct) for i, ct in zip(first, cts) if ct is not None]
    chunk = row_chunk(n, k, 24 * f)
    for s in range(0, n if used else 0, chunk):
        e = min(n, s + chunk)
        with torch.enable_grad():
            args = [x[s:e].detach().requires_grad_() for x in rows]
            args += [x.detach().requires_grad_() for x in weights]
            out = radial_embedding_ref(*args[:8], *args[9:])
            outs = torch.autograd.grad(out, [args[i + (i > 7)]
                                             for i, _ in used],
                                       args[8], create_graph=True)
            outs_ct = [ct[s:e] if i < 8 else ct for i, ct in used]
            leaves = [a for a, w in zip(args, want) if w]
            got = iter(torch.autograd.grad(outs, leaves, outs_ct,
                                           allow_unused=True)
                       if leaves else [])
        for i, w in enumerate(want):
            if not w:
                continue
            x = next(got)
            if x is None:
                continue
            if i < 9:
                grads[i][s:e] = x
            else:
                grads[i] += x
    grads = grads[:8] + grads[9:] + [grads[8]]
    return tuple(grads)


# kernels 1 and 2 as operators of the dispatcher (``tmdnet::``), which is
# how the autograd functions below launch them on CUDA tensors: a traced
# program (``utils/export.py``) records the operator and its shape
# function, and runs the kernel when it is run on the card.  Kernel 1's
# operator takes CPU tensors too (the plain chain), so that
# ``torch.library.opcheck`` can hold it without a card; kernel 2's plain
# backward needs autograd, which an operator's body has not, so it is a
# CUDA operator only.
@torch.library.custom_op("tmdnet::radial_embedding_fwd", mutates_args=())
def radial_embedding_fwd_op(edge_attr: torch.Tensor, C: torch.Tensor,
                            vx: torch.Tensor, vy: torch.Tensor,
                            vz: torch.Tensor, zw1: torch.Tensor,
                            zw2g: torch.Tensor, emask_f: torch.Tensor,
                            kall: torch.Tensor,
                            ball: torch.Tensor) -> torch.Tensor:
    """Kernel 1 on CUDA tensors, the plain chain on CPU ones."""
    inputs = (edge_attr, C, vx, vy, vz, zw1, zw2g, emask_f, kall, ball)
    if edge_attr.is_cuda:
        return radial_embedding_fwd_cuda(*inputs)
    return radial_embedding_ref(*inputs)


@radial_embedding_fwd_op.register_fake
def _(edge_attr, C, vx, vy, vz, zw1, zw2g, emask_f, kall, ball):
    return edge_attr.new_empty((edge_attr.shape[0], 9 * zw1.shape[-1]))


@torch.library.custom_op("tmdnet::radial_embedding_bwd", mutates_args=(),
                         device_types="cuda")
def radial_embedding_bwd_op(
        edge_attr: torch.Tensor, C: torch.Tensor, vx: torch.Tensor,
        vy: torch.Tensor, vz: torch.Tensor, zw1: torch.Tensor,
        zw2g: torch.Tensor, emask_f: torch.Tensor, kall: torch.Tensor,
        ball: torch.Tensor, g: torch.Tensor, want_dz: bool,
        want_dk: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 2: :func:`radial_embedding_bwd_cuda`'s nine cotangents,
    an empty tensor for each one not asked for."""
    inputs = (edge_attr, C, vx, vy, vz, zw1, zw2g, emask_f, kall, ball)
    out = radial_embedding_bwd_cuda(inputs, g, want_dz, want_dk)
    return tuple(g.new_empty(0) if t is None else t for t in out)


@radial_embedding_bwd_op.register_fake
def _(edge_attr, C, vx, vy, vz, zw1, zw2g, emask_f, kall, ball, g, want_dz,
      want_dk):
    n, k, r = edge_attr.shape
    f = zw1.shape[-1]

    def new(*shape):
        return edge_attr.new_empty(shape)

    return (new(n, k, r), new(n, k), new(n, k), new(n, k), new(n, k),
            new(n, f) if want_dz else new(0),
            new(n, k, f) if want_dz else new(0),
            new(r, 3 * f) if want_dk else new(0),
            new(3 * f) if want_dk else new(0))


class _RadialEmbeddingBwd(torch.autograd.Function):
    """The embedding's first-order cotangents ``first`` (input indices)
    of ``g`` as an op: kernel 2 on CUDA tensors (its dz form where zw1 or
    zw2g is among them, its dk form where kall or ball is), the plain
    backward on the CPU; differentiable once more."""

    @staticmethod
    def forward(ctx, first, g, *inputs):
        ctx.save_for_backward(*inputs, g)
        ctx.first = first
        # an output no loss reads gets None, not zeros to differentiate
        ctx.set_materialize_grads(False)
        if g.is_cuda:
            want_dz = 5 in first or 6 in first
            want_dk = 8 in first or 9 in first
            keep = (True,) * 5 + (want_dz,) * 2 + (want_dk,) * 2
            out = tuple(t if k else None for t, k in zip(
                radial_embedding_bwd_op(*inputs, g, want_dz, want_dk), keep))
        else:
            out = radial_embedding_bwd_ref(
                inputs, g, [i in first for i in range(10)])
        out = list(out[:7]) + [None] + list(out[7:])
        return tuple(out[i] for i in first)

    @staticmethod
    @first_order_only("the radial embedding", "a third derivative through "
                      "{} is not ported (its second order is the plain "
                      "double vjp)")
    def backward(ctx, *cts):
        *inputs, g = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:] + ctx.needs_input_grad[1:2]
        grads = radial_embedding_double_vjp(inputs, g, ctx.first, cts,
                                            needs)
        return (None, grads[10]) + grads[:10]


class _RadialEmbedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        if inputs[0].is_cuda:
            return radial_embedding_fwd_op(*inputs)
        return radial_embedding_ref(*inputs)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad
        first = tuple(i for i in range(10) if needs[i] and i != 7)
        out = iter(_RadialEmbeddingBwd.apply(first, g.contiguous(), *inputs)
                   if first else ())
        grads = [next(out) if i in first else None for i in range(10)]
        if needs[7]:
            # zero mask cotangent (the TPU kernel's contract, :301)
            grads[7] = torch.zeros_like(inputs[7])
        return tuple(grads)


def radial_embedding(edge_attr, C, vx, vy, vz, zw1, zw2g, emask_f, kall, ball):
    """[N, 9F] radial embedding (see the module docstring)."""
    return _RadialEmbedding.apply(edge_attr, C, vx, vy, vz, zw1, zw2g,
                                  emask_f, kall, ball)
