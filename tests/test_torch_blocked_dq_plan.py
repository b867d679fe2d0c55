"""Kernel B's launch plan (``ops/blocked_q.py``): pure Python, what the
wrapper hands ``csrc/blocked_q.cu::dq_tc_kernel`` — its row blocks, its
shared memory against a Hopper block's 232,448 B, its image scratch, and
the widths it refuses."""

import pytest
import torch

from torchmdnet_tpu_torch.ops import blocked_q as bq

SMEM_LIMIT = 232448


def _image_floats(kdim, ncols):
    """A split weight's floats: hi and lo planes of 128 x 16 per
    128-column pass and 16 rows."""
    return -(-ncols // 128) * -(-kdim // 16) * 2 * 128 * 16


# (n, K, F, T, R): the north star's blocked geometry (27,024 sorted rows,
# K = 96, the grouped K′ = 320) and the widest K′ of chip_smoke.py's
# ragged q-tier shapes, then each of those shapes (q_shape_errors)
PLAN_SHAPES = [(27024, 96, 128, 64, 32), (27024, 320, 128, 64, 32),
               (27024, 520, 128, 64, 32), (37, 13, 12, 8, 5),
               (50, 330, 32, 16, 7), (23, 40, 68, 16, 12),
               (21, 512, 128, 64, 32),
               (19, 520, 128, 64, 32)]


@pytest.mark.parametrize("rbf", [False, True])
@pytest.mark.parametrize("n,k,f,t,r", PLAN_SHAPES)
def test_dq_launch_plan(n, k, f, t, r, rbf):
    """Block ``b`` owns the sorted rows ``[16b, 16b + 16)`` below ``n``,
    each row once and no block empty; a compaction pass holds a block's
    slots or 4,096 of them; the shared memory fits a block; the image
    scratch is the sum of the six split images."""
    width = r if rbf else t
    (name, plan), = bq.launch_plan(n, k, f, width, rbf).items()
    assert name == ("blocked_q_dq_rbf" if rbf else "blocked_q_dq")
    blocks, rows, chunk, smem, image = plan
    owned = [range(b * rows, min(n, b * rows + rows)) for b in range(blocks)]
    assert [x for o in owned for x in o] == list(range(n))
    assert all(len(o) > 0 for o in owned)
    assert chunk == min(rows * k, 4096)
    assert smem <= SMEM_LIMIT
    assert bq.dq_plan_error(f, width, k, rbf) is None
    cot = (f, width) if rbf else (width, f)
    assert image == (_image_floats(width, f) + _image_floats(f, 2 * f)
                     + _image_floats(2 * f, 3 * f)
                     + _image_floats(3 * f, 2 * f) + _image_floats(2 * f, f)
                     + _image_floats(*cot))


@pytest.mark.parametrize("k, smem", [(96, 221216), (320, 226336),
                                     (520, 226336)])
def test_dq_shared_memory_at_the_main_width(k, smem):
    """At F = 128 the plan is dq_tc_kernel's layout: 1 KB of alignment,
    the three-stage ring (49,152 B), the [64, 388] and [64, 260]
    activation tiles (99,328 and 66,560 B), 2,080 B of tile metadata and
    the 16-bit slot ids of a block's 16 rows or 4,096 of them; one block
    an SM."""
    assert bq.dq_smem(128, k) == smem
    assert 2 * (smem + 1024) > 233472


@pytest.mark.parametrize("rbf, floats", [(False, 557056), (True, 565248)])
def test_dq_image_at_the_main_width(rbf, floats):
    """At F = 128 with T = 64 series terms (or R = 32 rbf channels) the
    scratch holds the six split images: the base 16,384 floats (8,192),
    W2 65,536, W3 and W3ᵀ 196,608 each, W2ᵀ 65,536 and the cotangent
    16,384 (W1aᵀ 32,768)."""
    assert bq.dq_image_floats(128, 32 if rbf else 64, rbf) == floats


@pytest.mark.parametrize("f", [132, 256])
def test_dq_plan_refuses_wide_channels(f):
    """Above F = 128 the W3 passes below 2F would hold two passes in
    registers; at F = 256 the plan's shared memory alone passes a
    block's."""
    assert bq.dq_plan_error(f, 64, 96) is not None
    assert bq.dq_plan_error(f, 32, 96, rbf=True) is not None
    if f == 256:
        assert bq.dq_smem(f, 96) > SMEM_LIMIT


def test_dq_plan_refuses_ragged_widths():
    """F must be a multiple of 4; the rbf width at most 128 (one pass of
    W1aᵀ)."""
    assert bq.dq_plan_error(126, 64, 96) is not None
    assert bq.dq_plan_error(128, 129, 96, rbf=True) is not None
    assert bq.dq_plan_error(128, 129, 96) is None


@pytest.mark.parametrize("exact", [False, True])
def test_dq_wrappers_refuse_cpu_tensors(exact):
    n, k, f, t = 5, 7, 8, 4
    common = [torch.rand(n, k), torch.ones(n, k, dtype=torch.bool),
              torch.zeros(n, k, dtype=torch.int64), torch.rand(n, f),
              torch.rand(n, f), torch.rand(n, 9 * f), torch.rand(n, 9 * f)]
    weights = [torch.rand(f, 2 * f), torch.rand(2 * f),
               torch.rand(2 * f, 3 * f), torch.rand(3 * f)]
    with pytest.raises(ValueError, match="CUDA"):
        if exact:
            bq.q_dq_rbf_cuda(torch.rand(n, k, t), *common, torch.rand(t, f),
                             *weights)
        else:
            bq.q_dq_cuda(torch.rand(n, k), *common, torch.rand(t, f),
                         torch.rand(t, f), *weights, 0.0, 4.5)
