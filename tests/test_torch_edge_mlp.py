"""Kernels 3 and 4 of the port: the TensorNet2 charge-fold edge MLP tail's
and TensorNet's fused edge MLP's plain PyTorch versions against the JAX
Pallas kernels (interpret mode), forward and backward."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.ops import pallas_kernels
from torchmdnet_tpu.ops.pallas_kernels import fused_edge_mlp_pre
from torchmdnet_tpu_torch.ops.edge_mlp import (
    edge_mlp_cuda, edge_mlp_pre, edge_mlp_pre_cuda, edge_mlp_pre_ref,
    edge_mlp_ref, fused_edge_mlp, launch_plan)

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


def test_plain_version_is_zero_on_dead_slots():
    x = _inputs(seed=5)
    x[1][x[1] < 0.4] = 0.0
    x[1][3] = 0.0  # a row with no live slot
    got = edge_mlp_pre_ref(*map(torch.from_numpy, x)).numpy()
    assert (x[1] == 0).any() and (x[1] != 0).any()
    assert not got[x[1] == 0].any()
    assert np.abs(got[x[1] != 0]).max() > 0


def _image_floats(kdim, ncols):
    """A split weight's floats: hi and lo planes of 128 x 16 per
    128-column pass and 16 rows."""
    return -(-ncols // 128) * -(-kdim // 16) * 2 * 128 * 16


@pytest.mark.parametrize("n, k, f", [(25088, 96, 128), (37, 13, 36),
                                     (50, 20, 36), (7, 96, 256),
                                     (300, 40, 264), (11, 96, 512)])
def test_kernel3_launch_plan(n, k, f):
    """Kernel 3's blocks walk the 1,024-slot spans (one span each at F ≤
    256, one block an SM above), every slot once; its shared memory fits a
    Hopper block, its image scratch holds W2's and W3's split images and
    its tile scratch, above F = 256, each block's h2 [64, 2F + 4] and
    silu(pre1) [64, F + 4] tiles."""
    blocks, span, smem, image, tiles = launch_plan(n * k, f)["edge_mlp_pre"]
    spans = -(-n * k // span)
    assert (spans - 1) * span < n * k <= spans * span
    assert blocks == (spans if f <= 256 else min(spans, 132))
    assert smem <= 232448
    assert image == _image_floats(f, 2 * f) + _image_floats(2 * f, 3 * f)
    assert tiles == (0 if f <= 256 else blocks * 64 * (3 * f + 8))


def _inputs4(n=16, k=8, r=12, f=16, seed=0):
    """Kernel 4's operands: rbf-like x, cw with zeros (padding, beyond the
    cutoff), W1 [R, F], W2 [F, 2F], W3 [2F, 3F]."""
    rng = np.random.RandomState(seed)
    cw = rng.rand(n, k) * (rng.rand(n, k) > 0.3)
    return [
        rng.rand(n, k, r).astype(np.float32),
        cw.astype(np.float32),
        (rng.randn(r, f) * 0.3).astype(np.float32),
        (rng.randn(f) * 0.1).astype(np.float32),
        (rng.randn(f, 2 * f) * 0.3).astype(np.float32),
        (rng.randn(2 * f) * 0.1).astype(np.float32),
        (rng.randn(2 * f, 3 * f) * 0.3).astype(np.float32),
        (rng.randn(3 * f) * 0.1).astype(np.float32),
    ]


def _jax_fused4(*a):
    return pallas_kernels.fused_edge_mlp(*a, True)


def test_fused_edge_mlp_forward_matches_pallas_kernel():
    x = _inputs4()
    want = np.asarray(_jax_fused4(*map(jnp.asarray, x)))
    got = edge_mlp_ref(*map(torch.from_numpy, x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not got[x[1] == 0].any()
    got_op = fused_edge_mlp(*map(torch.from_numpy, x)).numpy()
    np.testing.assert_array_equal(got_op, got)


def test_fused_edge_mlp_backward_matches_pallas_kernel():
    x = _inputs4(seed=1)
    g = np.random.RandomState(3).randn(16, 8, 48).astype(np.float32)
    _, vjp = jax.vjp(_jax_fused4, *map(jnp.asarray, x))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in x]
    fused_edge_mlp(*leaves).backward(torch.from_numpy(g))
    for name, leaf, w in zip(("x", "cw", "w1", "b1", "w2", "b2", "w3", "b3"),
                             leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_fused_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        edge_mlp_cuda(*map(torch.from_numpy, _inputs4()))


# (model, F, R, the kernel's shared memory at that width or None,
# refused): kernel 3 at TensorNet2's widths, kernel 4 at TensorNet's; the
# bytes are the kernels' layouts (edge_mlp.cu::pre_smem and fused_smem:
# kernel 3's tiles leave shared memory above F = 256, kernel 4 takes
# 32-slot tiles at (R, F) = (64, 256) and (32, 512)); what still refuses
# is a width that is not a multiple of 4
PLAN_CASES = [("tensornet2", 128, 32, 125248, False),
              ("tensornet2", 512, 32, 58688, False),
              ("tensornet2", 130, 32, None, True),
              ("tensornet", 128, 32, 128320, False),
              ("tensornet", 256, 64, 126656, False),
              ("tensornet", 512, 32, 220864, False),
              ("tensornet", 256, 30, None, True)]


@pytest.mark.parametrize("model, f, r, smem, refused", PLAN_CASES)
def test_models_keep_the_kernel_where_its_plan_cannot_launch(
        model, f, r, smem, refused):
    """With ``pallas_edge_mlp`` a model takes kernel 3 (TensorNet2) or 4
    (TensorNet, ``r`` rbf) at every width: the JAX op leaves its kernel
    only for a row count its tile does not divide or a dtype other than
    float32, never for a width, so no model switches to the plain chain.
    Every width that is a multiple of 4 has a plan within a block's
    shared memory; at any other the wrapper raises, before it looks at
    the device."""
    from torchmdnet_tpu_torch.models.tensornet import Interaction
    from torchmdnet_tpu_torch.models.tensornet2 import Interaction2
    from torchmdnet_tpu_torch.ops.edge_mlp import (
        fused_plan_error, fused_rows, fused_smem, pre_plan_error, pre_smem)

    if model == "tensornet2":
        layer = Interaction2(f, r, 16, pallas_edge_mlp=True)
        error = pre_plan_error(f)
        if smem:
            assert pre_smem(f) == smem
        args = _inputs(n=2, k=3, f=f, seed=6)
        wrapper = edge_mlp_pre_cuda
    else:
        layer = Interaction(f, r, pallas_edge_mlp=True)
        error = fused_plan_error(r, f)
        if smem:
            assert fused_smem(r, f, fused_rows(r, f)) == smem
        args = _inputs4(n=2, k=3, r=r, f=f, seed=6)
        wrapper = edge_mlp_cuda
    assert layer.fused
    assert (error is not None) == refused
    assert (smem is None) == refused
    assert smem is None or smem <= 232448
    with pytest.raises(ValueError, match=re.escape(error or "CUDA")) as raised:
        wrapper(*map(torch.from_numpy, args))
    assert ("CUDA" in str(raised.value)) != refused


def test_wide_tail_matches_the_jax_chain():
    """On the CPU TensorNet2's edge-MLP tail at F = 512, a width whose
    kernel 3 tiles go to device memory, is the JAX op's chain
    (``edge_mlp_pre_jnp``) on the same inputs."""
    from torchmdnet_tpu_torch.models.tensornet2 import Interaction2

    f = 512
    torch.manual_seed(0)
    layer = Interaction2(f, 32, 16, pallas_edge_mlp=True)
    pre1, cw = _inputs(n=3, k=4, f=f, seed=7)[:2]
    l2, l3 = layer.linears_scalar[1], layer.linears_scalar[2]
    weights = [w.detach().numpy() for w in (l2.weight.t(), l2.bias,
                                             l3.weight.t(), l3.bias)]
    want = np.asarray(pallas_kernels.edge_mlp_pre_jnp(
        *map(jnp.asarray, [pre1, cw, *weights])))
    with torch.no_grad():
        got = layer._mlp_tail(torch.from_numpy(pre1),
                              torch.from_numpy(cw)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
