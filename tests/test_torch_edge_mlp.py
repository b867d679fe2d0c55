"""Kernel 3 of the port: the TensorNet2 charge-fold edge MLP tail's plain
PyTorch version against the JAX Pallas kernel (interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.ops.pallas_kernels import fused_edge_mlp_pre
from torchmdnet_tpu_torch.ops.edge_mlp import (
    edge_mlp_pre, edge_mlp_pre_cuda, edge_mlp_pre_ref)

RTOL = ATOL = 1e-4


def _inputs(n=16, k=8, f=16, seed=0):
    rng = np.random.RandomState(seed)
    return [
        rng.randn(n, k, f).astype(np.float32),
        rng.rand(n, k).astype(np.float32),
        (rng.randn(f, 2 * f) * 0.3).astype(np.float32),
        (rng.randn(2 * f) * 0.1).astype(np.float32),
        (rng.randn(2 * f, 3 * f) * 0.3).astype(np.float32),
        (rng.randn(3 * f) * 0.1).astype(np.float32),
    ]


def _jax_fused(*a):
    return fused_edge_mlp_pre(*a, True)


def test_forward_matches_pallas_kernel():
    x = _inputs()
    want = np.asarray(_jax_fused(*map(jnp.asarray, x)))
    got = edge_mlp_pre_ref(*map(torch.from_numpy, x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    got_op = edge_mlp_pre(*map(torch.from_numpy, x)).numpy()
    np.testing.assert_array_equal(got_op, got)


def test_backward_matches_pallas_kernel():
    x = _inputs(seed=1)
    g = np.random.RandomState(3).randn(16, 8, 48).astype(np.float32)
    _, vjp = jax.vjp(_jax_fused, *map(jnp.asarray, x))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in x]
    edge_mlp_pre(*leaves).backward(torch.from_numpy(g))
    for name, leaf, w in zip(("pre1", "cw", "w2", "b2", "w3", "b3"), leaves,
                             want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_backward_only_for_requested_inputs():
    x = [torch.from_numpy(a) for a in _inputs(seed=4)]
    x[0].requires_grad_(True)
    (gp,) = torch.autograd.grad(edge_mlp_pre(*x).sum(), x[0])
    with torch.enable_grad():
        ref = x[0].detach().requires_grad_(True)
        (gr,) = torch.autograd.grad(edge_mlp_pre_ref(ref, *x[1:]).sum(), ref)
    np.testing.assert_allclose(gp.numpy(), gr.numpy(), rtol=1e-6, atol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        edge_mlp_pre_cuda(*map(torch.from_numpy, _inputs()))
