"""The q-tier kernels' launch plans (``ops/blocked_q.py``): pure Python,
what the wrappers hand ``csrc/blocked_q.cu``'s kernels A, A with du
(``q_tc_kernel``) and B (``dq_tc_kernel``) — their row blocks, their
shared memory against a Hopper block's 232,448 B, their image and tile
scratch, and the widths they refuse; and that kernels 3 and 4
(``ops/edge_mlp.py``) take the same widths."""

import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from torchmdnet_tpu_torch.ops import blocked_q as bq

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMEM_LIMIT = 232448


def _image_floats(kdim, ncols):
    """A split weight's floats: hi and lo planes of 128 x 16 per
    128-column pass and 16 rows."""
    return -(-ncols // 128) * -(-kdim // 16) * 2 * 128 * 16


# (n, K, F, T, R): the north star's blocked geometry (27,024 sorted rows,
# K = 96, the grouped K′ = 320) and the widest K′ of chip_smoke.py's
# ragged q-tier shapes, then each of those shapes (q_shape_errors), the
# wide ones last
PLAN_SHAPES = [(27024, 96, 128, 64, 32), (27024, 320, 128, 64, 32),
               (27024, 520, 128, 64, 32), (37, 13, 12, 8, 5),
               (50, 330, 32, 16, 7), (23, 40, 68, 16, 12),
               (21, 512, 128, 64, 32),
               (19, 520, 128, 64, 32), (23, 140, 132, 16, 12),
               (19, 120, 140, 64, 160), (17, 140, 256, 64, 32)]


def _tiles(f, mode):
    """One block's tiles in device memory: sX [64, 3F + 4]; with du and
    in B sZ [64, 2F + 4] and the dz3 plane [64, 3F + 4]; none at F ≤
    128."""
    if f <= 128:
        return 0
    return 64 * (3 * f + 4) + (64 * (2 * f + 4) + 64 * (3 * f + 4)
                               if mode else 0)


def _owned_rows(n, blocks, rows):
    """The sorted rows block after block, each walking the row blocks b,
    b + blocks, …; every block owns at least one."""
    row_blocks = -(-n // rows)
    owned = [[x for rb in range(b, row_blocks, blocks)
              for x in range(rb * rows, min(n, rb * rows + rows))]
             for b in range(blocks)]
    assert all(len(o) > 0 for o in owned)
    return sorted(x for o in owned for x in o)


@pytest.mark.parametrize("rbf", [False, True])
@pytest.mark.parametrize("n,k,f,t,r", PLAN_SHAPES)
def test_dq_launch_plan(n, k, f, t, r, rbf):
    """Kernel B's blocks own the 16-row blocks of the sorted rows, each row
    once and no block empty (one row block each at F ≤ 128, one block an
    SM above); a compaction pass holds a block's slots or 4,096 of them;
    the shared memory fits a block; the image scratch is the sum of the
    six split images and the tile scratch a block's tiles for each
    block."""
    width = r if rbf else t
    (name, plan), = bq.launch_plan(n, k, f, width, rbf).items()
    assert name == ("blocked_q_dq_rbf" if rbf else "blocked_q_dq")
    blocks, rows, chunk, smem, image, tiles = plan
    assert rows == 16
    assert blocks == (-(-n // rows) if f <= 128 else min(-(-n // rows), 132))
    assert _owned_rows(n, blocks, rows) == list(range(n))
    assert chunk == min(rows * k, 4096)
    assert smem <= SMEM_LIMIT
    assert tiles == blocks * _tiles(f, 2)
    assert bq.plan_error(f, width, rbf) is None
    cot = (f, width) if rbf else (width, f)
    assert image == (_image_floats(width, f) + _image_floats(f, 2 * f)
                     + _image_floats(2 * f, 3 * f)
                     + _image_floats(3 * f, 2 * f) + _image_floats(2 * f, f)
                     + _image_floats(*cot))


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("rbf", [False, True])
@pytest.mark.parametrize("n,k,f,t,r", PLAN_SHAPES)
def test_a_launch_plan(n, k, f, t, r, rbf, mode):
    """Kernel A (mode 0) and A with du (mode 1): the same row blocks and
    compaction passes as B, shared memory within a block, the image
    scratch the base's, W2's and W3's split images (with du also W3ᵀ's
    and W2ᵀ's), the tile scratch a block's tiles for each block."""
    width = r if rbf else t
    (name, plan), = bq.launch_plan(n, k, f, width, rbf, mode).items()
    assert name == ("blocked_q_fwd", "blocked_q_fwd_du")[mode] + (
        "_rbf" if rbf else "")
    blocks, rows, chunk, smem, image, tiles = plan
    assert _owned_rows(n, blocks, rows) == list(range(n))
    assert chunk == min(rows * k, 4096)
    assert smem <= SMEM_LIMIT
    want = (_image_floats(width, f) + _image_floats(f, 2 * f)
            + _image_floats(2 * f, 3 * f))
    if mode:
        want += _image_floats(3 * f, 2 * f) + _image_floats(2 * f, f)
    assert image == want
    assert tiles == blocks * _tiles(f, mode)


@pytest.mark.parametrize("k, smem", [(96, 221216), (320, 226336),
                                     (520, 226336)])
def test_dq_shared_memory_at_the_main_width(k, smem):
    """At F = 128 the plan is dq_tc_kernel's layout: 1 KB of alignment,
    the three-stage ring (49,152 B), the [64, 388] and [64, 260]
    activation tiles (99,328 and 66,560 B), 2,080 B of tile metadata and
    the 16-bit slot ids of a block's 16 rows or 4,096 of them; one block
    an SM.  Kernel A with du has the same plan, A the same without the
    [64, 260] tile."""
    assert bq.q_smem(128, k) == smem
    assert bq.q_smem(128, k, mode=1) == smem
    assert bq.q_smem(128, k, mode=0) == smem - 66560
    assert 2 * (smem + 1024) > 233472


@pytest.mark.parametrize("rbf, floats", [(False, 557056), (True, 565248)])
def test_dq_image_at_the_main_width(rbf, floats):
    """At F = 128 with T = 64 series terms (or R = 32 rbf channels) the
    scratch holds the six split images: the base 16,384 floats (8,192),
    W2 65,536, W3 and W3ᵀ 196,608 each, W2ᵀ 65,536 and the cotangent
    16,384 (W1aᵀ 32,768)."""
    assert bq.q_image_floats(128, 32 if rbf else 64, rbf) == floats


@pytest.mark.parametrize("f", [132, 256])
def test_dq_plan_refuses_wide_channels(f):
    """Above F = 128 kernel B no longer refuses: its tiles leave shared
    memory (the plan keeps the ring, the tile metadata and the slot ids:
    55,328 B at K = 96) for a device-memory scratch of 64 × (8F + 12)
    floats a block, one block an SM."""
    assert bq.plan_error(f, 64) is None
    assert bq.plan_error(f, 32, rbf=True) is None
    assert bq.q_smem(f, 96) == 55328
    (_, plan), = bq.launch_plan(27024, 96, f, 64, sms=132).items()
    assert plan[0] == 132 and plan[-1] == 132 * 64 * (8 * f + 12)


def test_dq_plan_refuses_ragged_widths():
    """F and t must be at least 1: an F that is not a multiple of 4 runs
    padded to one (126 as 128); any rbf width launches (W1aᵀ's cotangent
    product runs in 128-column passes)."""
    assert bq.plan_error(126, 64) is None
    assert bq.plan_error(0, 64) is not None
    assert bq.plan_error(128, 0) is not None
    assert bq.plan_error(128, 129, rbf=True) is None
    assert bq.plan_error(128, 129) is None


@pytest.mark.parametrize("r", [64, 160])
@pytest.mark.parametrize("f", [132, 140, 200, 256, 512])
def test_plans_take_every_width(f, r):
    """At widths past the shared-memory tiles of kernels A, B and 3 and
    past 64-slot tiles of kernel 4, no plan refuses: every mode and base
    of the q-tier at K up to 520, kernel 3 at F and kernel 4 at (R, F),
    each within a block's 232,448 B."""
    from torchmdnet_tpu_torch.ops import edge_mlp as em

    for k in (96, 320, 520):
        for mode in (0, 1, 2):
            for rbf, width in ((False, 64), (True, r)):
                assert bq.plan_error(f, width, rbf) is None
                (_, plan), = bq.launch_plan(27024, k, f, width, rbf,
                                            mode).items()
                assert plan[3] <= SMEM_LIMIT
                assert plan[5] == plan[0] * _tiles(f, mode)
    assert em.pre_plan_error(f) is None
    assert em.launch_plan(25088 * 96, f)["edge_mlp_pre"][2] <= SMEM_LIMIT
    assert em.fused_plan_error(r, f) is None
    assert em.fused_smem(r, f) <= SMEM_LIMIT
    assert em.launch_plan(2560 * 64, f, r=r)["edge_mlp"][2] <= SMEM_LIMIT


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


@pytest.mark.parametrize("du", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_a_wrappers_refuse_cpu_tensors(exact, du):
    n, k, f, t = 5, 7, 8, 4
    common = [torch.rand(n, k), torch.ones(n, k, dtype=torch.bool),
              torch.zeros(n, k, dtype=torch.int64), torch.rand(n, f),
              torch.rand(n, f), torch.rand(n, 9 * f)]
    weights = [torch.rand(f, 2 * f), torch.rand(2 * f),
               torch.rand(2 * f, 3 * f), torch.rand(3 * f)]
    grow = torch.rand(n, 9 * f) if du else None
    with pytest.raises(ValueError, match="CUDA"):
        if exact:
            bq.q_fwd_rbf_cuda(torch.rand(n, k, t), *common, torch.rand(t, f),
                              *weights, grow=grow)
        else:
            bq.q_fwd_cuda(torch.rand(n, k), *common, torch.rand(t, f),
                          *weights, 0.0, 4.5, grow=grow)
