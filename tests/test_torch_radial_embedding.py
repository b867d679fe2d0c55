"""Kernels 1-2 of the port: the radial embedding's plain PyTorch version
against the JAX Pallas kernel (interpret mode), forward and backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.ops.pallas_embedding import fused_radial_embedding
from torchmdnet_tpu_torch.ops.radial_embedding import (
    radial_embedding, radial_embedding_bwd_ref, radial_embedding_fwd_cuda,
    radial_embedding_ref)

RTOL = ATOL = 1e-4
NAMES = ("edge_attr", "C", "vx", "vy", "vz", "zw1", "zw2g", "emask_f",
         "kall", "ball")


def _inputs(n=32, k=8, r=8, f=16, seed=0):
    rng = np.random.RandomState(seed)
    v = rng.randn(n, k, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    mask = (rng.rand(n, k) < 0.8).astype(np.float32)
    return [
        rng.rand(n, k, r).astype(np.float32),
        rng.rand(n, k).astype(np.float32),
        v[..., 0].copy(), v[..., 1].copy(), v[..., 2].copy(),
        rng.randn(n, f).astype(np.float32),
        (rng.randn(n, k, f) * mask[..., None]).astype(np.float32),
        mask,
        (rng.randn(r, 3 * f) * 0.3).astype(np.float32),
        (rng.randn(3 * f) * 0.1).astype(np.float32),
    ]


def _jax_fused(*a):
    return fused_radial_embedding(*a, True)


def test_forward_matches_pallas_kernel():
    x = _inputs()
    want = np.asarray(_jax_fused(*map(jnp.asarray, x)))
    got = radial_embedding_ref(*map(torch.from_numpy, x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the op itself takes the plain version on CPU tensors
    got_op = radial_embedding(*map(torch.from_numpy, x)).numpy()
    np.testing.assert_array_equal(got_op, got)


def test_backward_matches_pallas_kernel():
    x = _inputs(seed=1)
    g = np.random.RandomState(2).randn(32, 9 * 16).astype(np.float32)
    _, vjp = jax.vjp(_jax_fused, *map(jnp.asarray, x))
    want = vjp(jnp.asarray(g))
    # the op's backward, through autograd
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in x]
    radial_embedding(*leaves).backward(torch.from_numpy(g))
    # the chunked plain backward, called directly
    direct = radial_embedding_bwd_ref([torch.from_numpy(a) for a in x],
                                      torch.from_numpy(g), [True] * 10)
    direct = list(direct[:7]) + [None] + list(direct[7:])
    for i, name in enumerate(NAMES):
        w = np.asarray(want[i])
        if name == "emask_f":
            # the TPU kernel's contract (pallas_embedding.py:301): zero
            assert not np.any(w)
            assert not leaves[i].grad.any()
            continue
        np.testing.assert_allclose(leaves[i].grad.numpy(), w, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(direct[i].numpy(), w, rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_backward_is_first_order_only():
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in _inputs()]
    out = radial_embedding(*leaves)
    (g,) = torch.autograd.grad(out.sum(), leaves[0], create_graph=True)
    with pytest.raises(RuntimeError):
        g.sum().backward()


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        radial_embedding_fwd_cuda(*map(torch.from_numpy, _inputs()))
