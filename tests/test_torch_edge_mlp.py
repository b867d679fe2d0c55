"""Kernels 3 and 4 of the port: the TensorNet2 charge-fold edge MLP tail's
and TensorNet's fused edge MLP's plain PyTorch versions against the JAX
Pallas kernels (interpret mode), forward and backward."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from torchmdnet_tpu.ops import pallas_kernels
from torchmdnet_tpu.ops.pallas_kernels import fused_edge_mlp_pre
from torchmdnet_tpu_torch.ops.edge_mlp import (
    edge_mlp_cuda, edge_mlp_pre, edge_mlp_pre_cuda, edge_mlp_pre_ref,
    edge_mlp_ref, fused_edge_mlp, launch_plan)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

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


def _check_ranges(e, blocks, chunks, seed):
    """The blocks' runs of 256-slot chunks (``chain_ranges``, as the
    kernels' ``block_range`` finds them) for live counts drawn from
    ``seed``, some chunks dead and some wholly live: contiguous, every
    slot below ``e`` once, and each run's cost (16 a live slot, 1 a slot)
    within one chunk of the mean."""
    from torchmdnet_tpu_torch.ops.edge_mlp import chain_ranges

    assert chunks == -(-e // 256)
    rng = np.random.RandomState(seed)
    sizes = [min(256, e - 256 * c) for c in range(chunks)]
    counts = [int(rng.choice([0, rng.randint(0, n + 1), n]))
              for n in sizes]
    ranges = chain_ranges(counts, e, blocks)
    assert len(ranges) == blocks
    # contiguous runs from chunk 0 to the last: slots [256·lo, 256·hi) ∩
    # [0, e) cover every slot once
    assert ranges[0][0] == 0 and ranges[-1][1] == chunks
    assert all(a[1] == b[0] and a[0] <= a[1]
               for a, b in zip(ranges, ranges[1:]))
    costs = [16 * n + m for n, m in zip(counts, sizes)]
    mean = sum(costs) / blocks
    assert all(sum(costs[lo:hi]) <= mean + max(costs) for lo, hi in ranges)


def _range_pass(counts, e, grid):
    """The run starts as ``edge_mlp.cu::range_kernel`` finds them: 256
    threads, each a portion of ``⌈chunks/256⌉`` chunks, an exclusive scan
    of their costs, and each chunk opening the runs of the blocks between
    its predecessor's block and its own, ``b(c) = ⌊P(c)·grid / T⌋``."""
    n = len(counts)
    per = -(-n // 256)

    def cost(c):
        return 16 * counts[c] + min(256, e - 256 * c) if c < n else 0

    sums = [sum(cost(t * per + i) for i in range(per)) for t in range(256)]
    total = sum(sums)
    ranges = [None] * (grid + 1)
    for t in range(256):
        c0, p = t * per, sum(sums[:t])
        prev = -1 if c0 == 0 else (p - cost(c0 - 1)) * grid // total
        for c in range(c0, min(n, c0 + per)):
            bc = p * grid // total
            for b in range(prev + 1, bc + 1):
                assert ranges[b] is None
                ranges[b] = c
            prev, p = bc, p + cost(c)
            if c == n - 1:
                for b in range(bc + 1, grid + 1):
                    assert ranges[b] is None
                    ranges[b] = n
    return list(zip(ranges[:-1], ranges[1:]))


@pytest.mark.parametrize("e, grid", [(2560 * 64, 132), (3136 * 224, 132),
                                     (300, 2), (9 * 61, 3), (70000, 132),
                                     (25088 * 96, 132)])
def test_range_pass_matches_the_plan(e, grid):
    """The kernels' one-block pass that cuts the chunks into runs writes
    every run start once and gives :func:`chain_ranges`' runs, for live
    counts with dead and wholly live chunks."""
    from torchmdnet_tpu_torch.ops.edge_mlp import chain_ranges

    rng = np.random.RandomState(e % 1000)
    sizes = [min(256, e - 256 * c) for c in range(-(-e // 256))]
    counts = [int(rng.choice([0, rng.randint(0, n + 1), n])) for n in sizes]
    assert _range_pass(counts, e, grid) == chain_ranges(counts, e, grid)


@pytest.mark.parametrize("n, k, f", [(25088, 96, 128), (37, 13, 36),
                                     (50, 20, 36), (7, 96, 256),
                                     (300, 40, 264), (11, 96, 512)])
def test_kernel3_launch_plan(n, k, f):
    """Kernel 3's grid is one block an SM (at most one a 256-slot chunk),
    each on a run of chunks of equal cost that covers every slot once; its
    shared memory fits a Hopper block, its image scratch holds W2's and
    W3's split images and its tile scratch, above F = 256, each block's h2
    [64, 2F + 4] and silu(pre1) [64, F + 4] tiles."""
    blocks, chunks, smem, image, tiles = launch_plan(n * k, f)["edge_mlp_pre"]
    assert blocks == min(132, chunks)
    _check_ranges(n * k, blocks, chunks, n + f)
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


@pytest.mark.parametrize("n, k, r, f", [(2560, 64, 32, 128),
                                        (3136, 224, 32, 128),
                                        (25088, 96, 32, 128), (9, 61, 64, 256),
                                        (7, 45, 32, 512), (5, 7, 4, 1024),
                                        (13, 17, 36, 132), (1, 1, 8, 16)])
def test_kernel4_launch_plan(n, k, r, f):
    """Kernel 4's grid is kernel 3's, one block an SM on runs of chunks of
    equal cost, every slot once; its shared memory fits a Hopper block,
    its image scratch holds W1's, W2's and W3's split images and its tile
    scratch, in the wide form (here F > 256), each block's h2, first-layer
    and x tiles."""
    e = n * k
    plan = launch_plan(e, f, r=r)
    blocks, chunks, smem, image, tiles = plan["edge_mlp"]
    assert plan["edge_mlp_pre"] == launch_plan(e, f)["edge_mlp_pre"]
    assert (blocks, chunks) == plan["edge_mlp_pre"][:2]
    _check_ranges(e, blocks, chunks, e + r)
    assert smem <= 232448
    assert image == (_image_floats(r, f) + _image_floats(f, 2 * f)
                     + _image_floats(2 * f, 3 * f))
    assert tiles == (blocks * 64 * (3 * f + 8 + -(-r // 32) * 32 + 4)
                     if f > 256 else 0)


@pytest.mark.parametrize("r, f", [(32, 128), (64, 256), (32, 512),
                                  (4, 1024), (36, 132), (160, 256)])
def test_kernel4_shared_memory_fits(r, f):
    """At TensorNet's and the ragged widths kernel 4's plan fits a block's
    232,448 B: the narrow form (its x tile, the h2 tile holding the first
    layer, the ring and the lists) where it fits and F ≤ 256, the wide
    form's ring and lists (tiles in device memory) elsewhere."""
    from torchmdnet_tpu_torch.ops.edge_mlp import (
        chain_smem, chain_wide, fused_smem, fused_tile_floats)

    wide = chain_wide(f, r)
    assert wide == (f > 256 or chain_smem(f, r, False) > 232448)
    assert fused_smem(r, f) == chain_smem(f, r, wide) <= 232448
    assert (fused_tile_floats(r, f) > 0) == wide


# (model, F, R, the kernel's shared memory at that width or None,
# refused): kernel 3 at TensorNet2's widths, kernel 4 at TensorNet's; the
# bytes are the kernels' layouts (edge_mlp.cu::chain_smem: kernel 3's
# tiles leave shared memory above F = 256, kernel 4's too and also where
# its x tile would pass the block; both hold a 1,024-slot window's lists
# and 64 slots carried to the next); a width that is not a multiple of 4
# is padded to the next one (F = 130 runs as 132, R = 30 as 32), so no
# width is refused
PLAN_CASES = [("tensornet2", 128, 32, 125504, False),
              ("tensornet2", 512, 32, 58944, False),
              ("tensornet2", 130, 32, 127552, False),
              ("tensornet", 128, 32, 134720, False),
              ("tensornet", 256, 64, 208448, False),
              ("tensornet", 512, 32, 58944, False),
              ("tensornet", 1024, 4, 58944, False),
              ("tensornet", 256, 30, 200256, False)]


@pytest.mark.parametrize("model, f, r, smem, refused", PLAN_CASES)
def test_models_keep_the_kernel_where_its_plan_cannot_launch(
        model, f, r, smem, refused):
    """With ``pallas_edge_mlp`` a model takes kernel 3 (TensorNet2) or 4
    (TensorNet, ``r`` rbf) at every width: the JAX op leaves its kernel
    only for a row count its tile does not divide or a dtype other than
    float32, never for a width, so no model switches to the plain chain.
    Every width has a plan within a block's shared memory (one that is
    not a multiple of 4 at the padded width, ``padded``); the wrapper
    raises a plan's error before it looks at the device, and on these CPU
    tensors it raises for the device alone."""
    from torchmdnet_tpu_torch.models.tensornet import Interaction
    from torchmdnet_tpu_torch.models.tensornet2 import Interaction2
    from torchmdnet_tpu_torch.ops.edge_mlp import (
        fused_plan_error, fused_smem, pre_plan_error, pre_smem)

    from torchmdnet_tpu_torch.ops.kernels import lane_width

    if model == "tensornet2":
        layer = Interaction2(f, r, 16, pallas_edge_mlp=True)
        error = pre_plan_error(f)
        if smem:
            assert pre_smem(lane_width(f)) == smem
        args = _inputs(n=2, k=3, f=f, seed=6)
        wrapper = edge_mlp_pre_cuda
    else:
        layer = Interaction(f, r, pallas_edge_mlp=True)
        error = fused_plan_error(r, f)
        if smem:
            assert fused_smem(lane_width(r), lane_width(f)) == smem
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
