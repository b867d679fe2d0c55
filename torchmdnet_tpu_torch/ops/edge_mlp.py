"""TensorNet2 charge-fold edge MLP tail (kernel 3 of the port).

Counterpart of the ``fused_edge_mlp_pre`` half of
``torchmdnet_tpu/ops/pallas_kernels.py`` (``:182-279``): given the
precomputed first-layer preactivation ``pre1 [N, K, F]``,

    attr = silu(silu(silu(pre1)·W2 + b2)·W3 + b3) · cw      → [N, K, 3F]

with weights in the JAX kernel layout (``W2 [F, 2F]``, ``W3 [2F, 3F]``).
On a CUDA tensor the forward is the hand-written kernel of
``csrc/edge_mlp.cu``; on a CPU tensor it is :func:`edge_mlp_pre_ref`.  The
backward recomputes through the plain chain over row chunks, as the JAX
``_bwd_pre`` (``:237``) does (the JAX package has no backward kernel for
this op); it is first-order only.
"""

import torch
import torch.nn.functional as F_
from torch.autograd.function import once_differentiable

from torchmdnet_tpu_torch.ops.kernels import (
    I32, I64, P, CudaSource, Kernel, check_cuda_args, ptr)
from torchmdnet_tpu_torch.ops.message_passing import row_chunk

SOURCE = CudaSource("edge_mlp.cu")
FORWARD = Kernel(SOURCE, "tmd_edge_mlp_pre", [P] * 7 + [I64, I32])
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def edge_mlp_pre_ref(pre1, cw, w2, b2, w3, b3):
    """Plain PyTorch chain (port of ``edge_mlp_pre_jnp``, ``:191``)."""
    h = F_.silu(pre1)
    h = F_.silu(torch.matmul(h, w2) + b2)
    h = F_.silu(torch.matmul(h, w3) + b3)
    return h * cw[..., None]


def edge_mlp_pre_cuda(pre1, cw, w2, b2, w3, b3):
    """Kernel 3 on CUDA tensors: returns [N, K, 3F]."""
    n, k, f = pre1.shape
    tensors = dict(pre1=pre1, cw=cw, w2=w2, b2=b2, w3=w3, b3=b3)
    dev = pre1.device
    if dev.type != "cuda":
        raise ValueError(f"edge_mlp_pre: expects CUDA tensors, got {dev}")
    check_cuda_args("edge_mlp_pre", tensors, dev)
    shapes = dict(pre1=(n, k, f), cw=(n, k), w2=(f, 2 * f), b2=(2 * f,),
                  w3=(2 * f, 3 * f), b3=(3 * f,))
    for key, t in tensors.items():
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"edge_mlp_pre: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")
        if t.data_ptr() % 16:
            raise ValueError(f"edge_mlp_pre: {key} is not 16-byte aligned")
    smem = 4 * (64 * (f + 4) + 64 * (2 * f + 4) + 32 * 128)
    if f % 4 or smem > _SMEM_LIMIT:
        raise ValueError(f"edge_mlp_pre: channels {f} must be a multiple of 4 "
                         f"and fit shared memory")
    out = torch.empty((n, k, 3 * f), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        FORWARD(ptr(pre1), ptr(cw), ptr(w2), ptr(b2), ptr(w3), ptr(b3),
                ptr(out), n * k, f)
    return out


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
        pre1, cw, *weights = ctx.saved_tensors
        want = list(ctx.needs_input_grad)
        n, k, f = pre1.shape
        dpre = torch.empty_like(pre1) if want[0] else None
        dcw = torch.empty_like(cw) if want[1] else None
        dws = [torch.zeros_like(w) if wt else None
               for w, wt in zip(weights, want[2:])]
        # live [rows, K, ·] tensors of the recompute: ~ F + 2F·3 + 3F·4 wide
        chunk = row_chunk(n, k, 19 * f, budget_bytes=2 * 1024 ** 3)
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            with torch.enable_grad():
                args = [pre1[s:e].detach().requires_grad_(want[0]),
                        cw[s:e].detach().requires_grad_(want[1])]
                args += [w.detach().requires_grad_(wt)
                         for w, wt in zip(weights, want[2:])]
                out = edge_mlp_pre_ref(*args)
                leaves = [a for a, wt in zip(args, want) if wt]
                got = iter(torch.autograd.grad(out, leaves, g[s:e]))
            if want[0]:
                dpre[s:e] = next(got)
            if want[1]:
                dcw[s:e] = next(got)
            for i, wt in enumerate(want[2:]):
                if wt:
                    dws[i] += next(got)
        return (dpre, dcw, *dws)


def edge_mlp_pre(pre1, cw, w2, b2, w3, b3):
    """``silu(silu(silu(pre1)·W2+b2)·W3+b3)·cw`` → [N, K, 3F] (see the
    module docstring)."""
    return _EdgeMlpPre.apply(pre1, cw, w2, b2, w3, b3)
