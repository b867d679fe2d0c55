"""Kernels 1-2 of the port: the radial embedding's plain PyTorch version
against the JAX Pallas kernel (interpret mode), forward and backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from torchmdnet_tpu.ops.pallas_embedding import fused_radial_embedding
from torchmdnet_tpu_torch.ops.radial_embedding import (
    radial_embedding, radial_embedding_bwd_ref, radial_embedding_fwd_cuda,
    radial_embedding_ref)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

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
    """The embedding's second order (the name is the old contract's: the
    backward was first-order only, and a force loss's gradient in the
    weights silently lost its terms).  The op's backward is now kernel 2
    as an op of its own whose backward is the plain double vjp, as JAX's
    ``_bwd_op`` (``pallas_embedding.py:304-332``): its cotangents of the
    ten inputs and of ``g``, for random cotangents of the nine first-order
    outputs, match ``jax.vjp`` of the jnp first order at 1e-4; and the
    mask's first-order cotangent stays zero."""
    x = _inputs(seed=3)
    rng = np.random.RandomState(4)
    g = rng.randn(32, 9 * 16).astype(np.float32)
    firsts = [i for i in range(10) if i != 7]
    cts = [rng.randn(*x[i].shape).astype(np.float32) for i in firsts]

    def first_order(*a):
        _, vjp = jax.vjp(_jax_fused, *a[:10])
        return [vjp(a[10])[i] for i in firsts]

    _, vjp2 = jax.vjp(first_order, *map(jnp.asarray, x), jnp.asarray(g))
    want = vjp2([jnp.asarray(c) for c in cts])

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in x]
    gt = torch.from_numpy(g).requires_grad_(True)
    out = radial_embedding(*leaves)
    got1 = torch.autograd.grad(out, leaves, gt, create_graph=True)
    assert not got1[7].any()
    got = torch.autograd.grad([got1[i] for i in firsts], leaves + [gt],
                              [torch.from_numpy(c) for c in cts],
                              allow_unused=True)
    for i, name in enumerate(NAMES + ("g",)):
        w = np.asarray(want[i])
        t = np.zeros_like(w) if got[i] is None else got[i].numpy()
        np.testing.assert_allclose(t, w, rtol=RTOL, atol=ATOL *
                                   max(1.0, float(np.abs(w).max())),
                                   err_msg=name)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        radial_embedding_fwd_cuda(*map(torch.from_numpy, _inputs()))


def test_wide_widths_match_pallas_kernel():
    """At R = 64 (the JAX CLI default) and F = 48, widths the kernels must
    take, the plain chain is the JAX op's, forward and backward."""
    n, f = 32, 48
    x = _inputs(n=n, k=8, r=64, f=f, seed=3)
    want = np.asarray(_jax_fused(*map(jnp.asarray, x)))
    got = radial_embedding(*map(torch.from_numpy, x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    g = np.random.RandomState(4).randn(n, 9 * f).astype(np.float32)
    _, vjp = jax.vjp(_jax_fused, *map(jnp.asarray, x))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in x]
    radial_embedding(*leaves).backward(torch.from_numpy(g))
    for i, name in enumerate(NAMES):
        if name != "emask_f":
            np.testing.assert_allclose(leaves[i].grad.numpy(),
                                       np.asarray(want[i]), rtol=RTOL,
                                       atol=ATOL, err_msg=name)


# channel widths the kernels take with every rbf width and slot count the
# JAX op computes (the parent's kernels took R ∈ {8, 16, 32} and F a
# multiple of 32 up to 256 only)
PLAN_F = [4, 36, 48, 128, 256, 512]


@pytest.mark.parametrize("f", PLAN_F)
def test_every_width_has_a_plan(f):
    """Kernels 1 and 2 launch at F = f with R ∈ {8, 32, 50, 64, 128} and
    K up to 520: the plan's shared memory stays within a Hopper block's
    232,448 B, the tiles of a wide F go to a device-memory scratch of one
    region a block, and the dk form's partial rows are one a block (the
    bytes themselves are pinned by ``test_plan_bytes``)."""
    from torchmdnet_tpu_torch.ops.radial_embedding import (
        MODES, emb_plan_error, launch_plan)

    n = 25088
    for r in (8, 32, 50, 64, 128):
        for k in (13, 96, 360, 520):
            assert emb_plan_error(k, r, f) is None
            for mode, name in enumerate(MODES):
                (blocks, rows, chunk, smem, tiles, part, _), = \
                    launch_plan(n, k, r, f, mode).values()
                wide = f > (512 if mode == 0 else 128)
                assert rows == 16 and chunk == min(16 * k, 4096)
                assert smem <= 232448
                assert blocks == (min(-(-n // 16), 132) if wide or mode == 2
                                  else -(-n // 16))
                assert (tiles > 0) == wide and tiles % blocks == 0
                assert part == (blocks * (r + 1) * 3 * f if mode == 2 else 0)


# (mode, F, wide, dynamic shared memory B, tile floats a block, kall
# staged) at K = 96, R = 32 on 25,088 rows: the main width (kernel 1
# 92,464 B, two blocks an SM; kernel 2 221,472 B with kall staged, as the
# compiled kernels report on an H100), its wide form, and F = 640, where
# both kernels keep their tiles in device memory
PLAN_BYTES = [(0, 128, None, 92464, 0, False),
              (1, 128, None, 221472, 0, True),
              (2, 128, None, 221472, 0, True),
              (0, 128, True, 58672, 64 * 132, False),
              (1, 128, True, 88352, 64 * 132 + 64 * 388, True),
              (0, 640, None, 58672, 64 * 644, False),
              (1, 640, None, 38688, 64 * 644 + 64 * 1924, False),
              (2, 640, None, 38688, 64 * 644 + 64 * 1924, False)]


@pytest.mark.parametrize("mode, f, wide, smem, tile, kall_smem", PLAN_BYTES)
def test_plan_bytes(mode, f, wide, smem, tile, kall_smem):
    from torchmdnet_tpu_torch.ops.radial_embedding import launch_plan

    (blocks, _, _, got_smem, tiles, _, got_kall), = launch_plan(
        25088, 96, 32, f, mode, 132, wide).values()
    assert (got_smem, got_kall) == (smem, kall_smem)
    assert tiles == blocks * tile


@pytest.mark.parametrize("f", [30, 0])
def test_plan_names_a_width_it_refuses(f):
    """Only a width below 1 is refused; F = 30 runs padded to 32."""
    from torchmdnet_tpu_torch.ops.radial_embedding import emb_plan_error

    if f >= 1:
        assert emb_plan_error(96, 32, f) is None
    else:
        assert f"channels {f}" in emb_plan_error(96, 32, f)


# (R, F, refused): the JAX CLI's 64 rbf, F = 48 and F = 30 (padded to 32)
MODEL_CASES = [(64, 128, False), (32, 48, False), (32, 30, False)]


@pytest.mark.parametrize("r, f, refused", MODEL_CASES)
def test_models_keep_the_kernel_at_every_width(r, f, refused):
    """With ``pallas_embedding`` a TensorNet takes kernels 1 and 2 at every
    width: the JAX op leaves its kernel only for a row count its tile does
    not divide or a dtype other than float32 (``pallas_embedding.py:121-
    124``), never for a width.  The wrappers consult the plan before they
    look at the device, so on CPU tensors they raise the plan's error
    where it refuses and only "CUDA" elsewhere."""
    from torchmdnet_tpu_torch.models.tensornet import TensorNet
    from torchmdnet_tpu_torch.ops.radial_embedding import (
        emb_plan_error, radial_embedding_bwd_cuda)

    if not refused:
        model = TensorNet(hidden_channels=f, num_layers=1, num_rbf=r,
                          pallas_embedding=True)
        assert model.tensor_embedding.fused
    error = emb_plan_error(8, r, f)
    assert (error is not None) == refused
    x = [torch.from_numpy(a) for a in _inputs(n=2, k=8, r=r, f=f, seed=5)]
    g = torch.zeros(2, 9 * f)
    for call in (lambda: radial_embedding_fwd_cuda(*x),
                 lambda: radial_embedding_bwd_cuda(x, g, False, False)):
        with pytest.raises(ValueError, match=error or "CUDA") as raised:
            call()
        assert ("CUDA" in str(raised.value)) != refused
