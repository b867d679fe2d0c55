"""TensorNet's radial tensor embedding (kernels 1 and 2 of the port).

Counterpart of ``torchmdnet_tpu/ops/pallas_embedding.py``: the distance
projections ``dp = ea @ kall + ball``, the cutoff/pair product
``cz = C·(zw1_i + zw2g)·mask`` and the nine radial reductions
``I = Σ_k w0``, ``A_d = Σ_k w1·v̂_d``, ``S_c = Σ_k w2·s5_c(v̂)`` in one op
whose output is ``[N, 9F] = (I, A×3, S×5)``.

On a CUDA tensor the forward and the backward are the hand-written kernels
of ``csrc/radial_embedding.cu``; on a CPU tensor they are the plain
PyTorch chain :func:`radial_embedding_ref` and its autograd.  The backward
gives the mask a zero cotangent, as the TPU kernel does
(``pallas_embedding.py:301``).  It is first-order only: a second
derivative through it raises.
"""

import torch
from torch.autograd.function import once_differentiable

from torchmdnet_tpu_torch.ops.kernels import (
    I32, P, CudaSource, Kernel, check_cuda_args, null_or_ptr, ptr)
from torchmdnet_tpu_torch.ops.message_passing import row_chunk
from torchmdnet_tpu_torch.ops.tc_tile import SMEM_LIMIT

SOURCE = CudaSource("radial_embedding.cu")
FORWARD = Kernel(SOURCE, "tmd_radial_embedding_fwd", [P] * 11 + [I32] * 4)
BACKWARD = Kernel(SOURCE, "tmd_radial_embedding_bwd", [P] * 21 + [I32] * 5)
KERNEL_R = (8, 16, 32)  # rbf widths the kernels are compiled for


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


def _check_cuda(name, tensors, n, k, r, f):
    dev = tensors["edge_attr"].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expects CUDA tensors, got {dev}")
    check_cuda_args(name, tensors, dev)
    if r not in KERNEL_R:
        raise ValueError(f"{name}: rbf width {r} not in {KERNEL_R}")
    if f % 32 or f > 256:
        raise ValueError(f"{name}: channels {f} must be a multiple of 32, <= 256")
    # shared memory of emb_fwd_kernel / emb_bwd_kernel: the row's K slots of
    # rbf, cutoff, mask and unit vector, and (backward) 32-slot partials
    smem = 4 * (k * r + 5 * k + (32 * (f // 32) * (r + 16) if "g" in tensors
                                 else 0))
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: K={k}, R={r}, F={f} needs {smem} bytes of "
                         f"shared memory (> {SMEM_LIMIT})")
    shapes = {"edge_attr": (n, k, r), "C": (n, k), "vx": (n, k), "vy": (n, k),
              "vz": (n, k), "zw1": (n, f), "zw2g": (n, k, f),
              "emask_f": (n, k), "kall": (r, 3 * f), "ball": (3 * f,),
              "g": (n, 9 * f)}
    for key, t in tensors.items():
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")
    return dev


_NAMES = ("edge_attr", "C", "vx", "vy", "vz", "zw1", "zw2g", "emask_f",
          "kall", "ball")


def radial_embedding_fwd_cuda(edge_attr, C, vx, vy, vz, zw1, zw2g, emask_f,
                              kall, ball):
    """Kernel 1 on CUDA tensors: returns [N, 9F]."""
    n, k, r = edge_attr.shape
    f = zw1.shape[-1]
    inputs = (edge_attr, C, vx, vy, vz, zw1, zw2g, emask_f, kall, ball)
    dev = _check_cuda("radial_embedding_fwd", dict(zip(_NAMES, inputs)),
                      n, k, r, f)
    out = torch.empty((n, 9 * f), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        FORWARD(*(ptr(t) for t in inputs), ptr(out), n, k, r, f)
    return out


def radial_embedding_bwd_cuda(inputs, g, want_dz: bool, want_dk: bool):
    """Kernel 2 on CUDA tensors: returns (dea, dC, dvx, dvy, dvz, dzw1,
    dzw2g, dkall, dball); dzw1/dzw2g are None unless ``want_dz``,
    dkall/dball None unless ``want_dk``."""
    edge_attr, C, vx, vy, vz, zw1, zw2g, emask_f, kall, ball = inputs
    n, k, r = edge_attr.shape
    f = zw1.shape[-1]
    tensors = dict(zip(_NAMES, inputs), g=g)
    dev = _check_cuda("radial_embedding_bwd", tensors, n, k, r, f)

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dea, dC, dvx, dvy, dvz = new(n, k, r), new(n, k), new(n, k), new(n, k), new(n, k)
    dzw1 = new(n, f) if want_dz else None
    dzw2g = new(n, k, f) if want_dz else None
    dkall = new(r, 3 * f) if want_dk else None
    dball = new(3 * f) if want_dk else None
    nblocks = n
    part = None
    if want_dk:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nblocks = max(1, min(n, 2 * sms))
        part = new(nblocks, (r + 1) * 3 * f)
    if n == 0:
        return dea, dC, dvx, dvy, dvz, dzw1, dzw2g, dkall, dball
    with torch.cuda.device(dev):
        BACKWARD(*(ptr(t) for t in inputs[:8]), ptr(g), ptr(kall), ptr(ball),
                 ptr(dea), ptr(dC),
                 ptr(dvx), ptr(dvy), ptr(dvz), null_or_ptr(dzw1),
                 null_or_ptr(dzw2g), null_or_ptr(dkall), null_or_ptr(dball),
                 null_or_ptr(part), n, k, r, f, nblocks)
    return dea, dC, dvx, dvy, dvz, dzw1, dzw2g, dkall, dball


class _RadialEmbedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        if inputs[0].is_cuda:
            return radial_embedding_fwd_cuda(*inputs)
        return radial_embedding_ref(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad
        g = g.contiguous()
        if g.is_cuda:
            out = radial_embedding_bwd_cuda(
                inputs, g, want_dz=needs[5] or needs[6],
                want_dk=needs[8] or needs[9])
        else:
            out = radial_embedding_bwd_ref(inputs, g, needs)
        # zero mask cotangent (the TPU kernel's contract, :301)
        dem = torch.zeros_like(inputs[7]) if needs[7] else None
        grads = list(out[:7]) + [dem] + list(out[7:])
        return tuple(x if w else None for x, w in zip(grads, needs))


def radial_embedding(edge_attr, C, vx, vy, vz, zw1, zw2g, emask_f, kall, ball):
    """[N, 9F] radial embedding (see the module docstring)."""
    return _RadialEmbedding.apply(edge_attr, C, vx, vy, vz, zw1, zw2g,
                                  emask_f, kall, ball)
