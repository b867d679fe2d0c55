"""Rows 8-11 of the port (``ops/blocked_mp.py``, plain versions on the CPU)
against the JAX package's blocked TensorNet ops with a precise spec, their
Pallas kernels in interpret mode: the four ops and both differentiable
wrappers (feature, attr and distance cotangents) on the ungrouped list of
one small system (``test_torch_blocked_mp_grouped.py`` holds the grouped
one); the grouped tier's column-partitioned neighbor list against JAX's
on the same positions; the CUDA wrappers' refusal of CPU tensors; and the
kernels' launch plan (blocks of sorted rows, shared memory) at the shapes
the card runs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (ATOL, BLOCKED_QUANTITIES, BMP_CUTOFF, BMP_F,
                          BMP_N, BMP_RC, BMP_T, RTOL, blocked_mp_case,
                          blocked_system, grouped_list_kwargs,
                          one_torch_thread)
from torchmdnet_tpu.ops.neighbors import (
    build_neighbor_matrix as jax_build_neighbors)
from torchmdnet_tpu_torch.models.tensornet import (
    edge_message_passing, split9)
from torchmdnet_tpu_torch.ops import blocked_mp as bm
from torchmdnet_tpu_torch.ops import cell_blocks as tcb
from torchmdnet_tpu_torch.ops.neighbors import (
    NeighborMatrix, build_neighbor_matrix)

F = BMP_F


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def case():
    return blocked_mp_case("ungrouped")


@pytest.mark.parametrize("quantity", BLOCKED_QUANTITIES)
def test_blocked_op_matches_jax(case, quantity):
    """rtol = atol = 1e-4 (JAX's precise tier is ~2^-16 relative)."""
    want, got, _ = case
    assert np.abs(want[quantity]).max() > 1e-2  # non-vacuous
    np.testing.assert_allclose(got[quantity], want[quantity], rtol=RTOL,
                               atol=ATOL)


def test_blocked_contracts(case):
    """Invalid slots of row 9 are exactly 0, and the series coefficients
    get a zero gradient in both packages (the MD-only contract)."""
    want, got, mask = case
    assert not got["row9"][~mask].any() and not want["row9"][~mask].any()
    assert not got["cheb_dcoeffs"].any() and not want["cheb_dcoeffs"].any()


def test_asym_backward_uses_the_reverse_weights():
    """The asymmetric wrapper's feature gradient is the forward op on the
    reverse weights, which get no gradient of their own."""
    rng = np.random.RandomState(1)
    n, k = 12, 5
    idx = torch.from_numpy(rng.randint(0, n, (n, k)))
    mask = torch.from_numpy(rng.rand(n, k) < 0.7)
    attr, rev = (torch.randn(n, k, 3 * F, requires_grad=True) for _ in "ab")
    feats = torch.randn(n, 9 * F, requires_grad=True)
    g = torch.randn(n, 9 * F)
    out = bm.blocked_neighbor_sum_asym(attr, rev, feats, idx, mask)
    da, dr, df = torch.autograd.grad(out, [attr, rev, feats], g,
                                     allow_unused=True)
    torch.testing.assert_close(out,
                               bm.neighbor_sum_ref(attr, feats, idx, mask))
    torch.testing.assert_close(df, bm.neighbor_sum_ref(rev, g, idx, mask))
    torch.testing.assert_close(da, bm.dattr_ref(g, feats, idx, mask))
    assert dr is None
    # TensorNet's message pass takes it under blocked, as the gather path
    # takes packed_neighbor_sum_asym (on weights masked as the models'
    # are: the blocked ops skip invalid slots)
    nbr = NeighborMatrix(idx, mask)
    irr = split9(feats.detach(), n, F)
    attr = attr.detach() * mask[..., None]
    for got, want in zip(
            edge_message_passing(attr, irr, nbr, rev, blocked=True),
            edge_message_passing(attr, irr, nbr, rev)):
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("budgets", ["tuned", "too_small"])
def test_column_partition_matches_jax(budgets):
    """The same neighbor set per row in each of the 9 groups and the same
    overflow flag, on the tuned budgets and on budgets forced too small."""
    pos, bd = blocked_system(seed=5)
    spec = tcb.tune_cell_block_spec(pos, bd, BMP_RC, cap=8,
                                    column_slots=True)
    if budgets == "too_small":
        spec = spec._replace(col_slots=(4,) * 9)
    pt = torch.from_numpy(pos)
    blocks = tcb.plan_cell_blocks(pt, bd, spec)
    am = blocks.mask_rows
    pos_s = torch.where(am[:, None],
                        pt[torch.clamp(blocks.perm, max=BMP_N - 1)], 0.0)
    kw = grouped_list_kwargs(spec, bd, BMP_RC, BMP_N)
    box = torch.diag(torch.from_numpy(bd))
    got = build_neighbor_matrix(pos_s, (~am).long(), cutoff_upper=BMP_RC,
                                loop=True, box=box, atom_mask=am, **kw)
    want = jax_build_neighbors(
        jnp.asarray(pos_s.numpy()),
        jnp.asarray((~am).numpy().astype(np.int32)), cutoff_upper=BMP_RC,
        loop=True, box=jnp.diag(jnp.asarray(bd)),
        atom_mask=jnp.asarray(am.numpy()), **kw)
    assert bool(got.overflow) == bool(want.overflow) == (budgets != "tuned")

    def group_sets(idx, mask, a, b):
        return np.sort(np.where(mask[:, a:b], idx[:, a:b], -1), axis=1)

    bounds = np.cumsum((0,) + spec.col_slots)
    for a, b in zip(bounds[:-1], bounds[1:]):
        np.testing.assert_array_equal(
            group_sets(got.idx.numpy(), got.mask.numpy(), a, b),
            group_sets(np.asarray(want.idx), np.asarray(want.mask), a, b))
    np.testing.assert_array_equal(got.num_neighbors.numpy(),
                                  np.asarray(want.num_neighbors))
    if budgets == "tuned":  # every group's slot budget is met somewhere
        assert got.mask.sum() > 5 * BMP_N


def test_grouped_tuner_and_list_refuse_what_jax_refuses():
    pos, bd = blocked_system(n=60, seed=2)  # a 2x2 xy grid at 4.5 Å
    with pytest.raises(ValueError, match="3x3"):
        tcb.tune_cell_block_spec(pos, bd, 4.5, column_slots=True)
    pt = torch.from_numpy(pos)
    box = torch.diag(torch.from_numpy(bd * 2))
    with pytest.raises(ValueError, match="sum"):
        build_neighbor_matrix(pt, strategy="cell", k_max=10, cutoff_upper=3.0,
                              box=box, column_partition=(2,) * 9)
    # the brute strategy drops the option, as JAX's does
    nbr = build_neighbor_matrix(pt, strategy="brute", k_max=24,
                                cutoff_upper=3.0, box=box,
                                column_partition=(2,) * 9)
    assert nbr.idx.shape == (60, 24)


@pytest.mark.parametrize("op", ["neighbor_sum_cuda", "dattr_cuda",
                                "neighbor_sum_cheb_cuda", "dd_cheb_cuda"])
def test_cuda_wrappers_refuse_cpu_tensors(op):
    n, k = 8, 4
    idx = torch.zeros((n, k), dtype=torch.long)
    mask = torch.ones((n, k), dtype=torch.bool)
    d = torch.rand(n, k)
    x = torch.randn(n, 9 * F)
    args = {"neighbor_sum_cuda": (torch.randn(n, k, 3 * F), x, idx, mask),
            "dattr_cuda": (x, x, idx, mask),
            "neighbor_sum_cheb_cuda": (torch.randn(BMP_T, 3 * F), d, d, x,
                                       idx, 0.0, BMP_CUTOFF),
            "dd_cheb_cuda": (torch.randn(BMP_T, 3 * F), d, d, x, x, idx, 0.0,
                             BMP_CUTOFF)}[op]
    with pytest.raises(ValueError, match="expects CUDA tensors"):
        getattr(bm, op)(*args)


# (n, K, F, T) of chip_smoke.py: the dhfr cell-blocked sort with the grouped
# K′ = 224, the MD spec's K′ = 360 and the brute K = 64 lists, and the
# ragged shapes of blocked_shape_errors
PLAN_SHAPES = [(3136, 224, 128, 128), (3136, 360, 128, 128),
               (3136, 64, 128, 128), (37, 8, 8, 16), (50, 33, 32, 64),
               (29, 96, 128, 128), (41, 64, 64, 100)]


@pytest.mark.parametrize("n,k,f,t", PLAN_SHAPES)
def test_launch_plan_fits_shared_memory(n, k, f, t):
    """Every launch of rows 8, 10 and 11 fits a Hopper block's 232,448 B:
    row 8 takes no shared memory (a warp a row and 128-channel group, 4 a
    block); rows 10 and 11 leave room for two blocks on an SM (228 KB, 1
    KB of it reserved per block) everywhere and for three at F = 128 with
    K up to the grouped K′ = 224 (their launch bounds ask for three)."""
    plan = bm.launch_plan(n, k, f, t)
    assert set(plan) == {"blocked_mp_sum", "blocked_mp_sum_cheb",
                         "blocked_mp_dd_cheb"}
    assert plan["blocked_mp_sum"] == (-(-n * -(-f // 128) // 4), 0)
    for name in ("blocked_mp_sum_cheb", "blocked_mp_dd_cheb"):
        blocks, smem = plan[name]
        assert blocks == -(-n // 4)
        assert 0 < smem <= 232448, name
    for name in ("blocked_mp_sum_cheb", "blocked_mp_dd_cheb"):
        per_sm = 233472 // (plan[name][1] + 1024)
        assert per_sm >= (3 if f <= 128 and k <= 224 else 2), name
    # the split series: a hi and a lo copy of every entry, whole stages
    assert bm.tc_image_floats(t, 3 * f) >= 2 * t * 3 * f
    assert bm.tc_image_floats(t, 3 * f) % (2 * 128 * 16) == 0


@pytest.mark.parametrize("n", [1, 3, 4, 37, 41, 3136])
@pytest.mark.parametrize("f", [128, 132, 8])
def test_row_blocks_cover_every_row_once(n, f):
    """Block ``b`` of rows 10 and 11 owns the sorted rows ``[4b, 4b + 4)``
    below ``n``; block ``b`` of row 8 the warp tasks ``[4b, 4b + 4)``,
    task ``t`` the row ``t // G`` and the 128 channels from ``128·(t % G)``
    (G = ⌈F/128⌉): the plan's blocks give each row one block (row 8: each
    row's every channel group one warp) and leave no block empty."""
    plan = bm.launch_plan(n, 64, f, 128)
    groups = -(-f // 128)
    assert bm.sum_tasks(n, f) == n * groups
    for name, (blocks, _) in plan.items():
        per, count = (4, bm.sum_tasks(n, f)) if name == "blocked_mp_sum" \
            else (4, n)
        owned = [range(per * b, min(count, per * b + per))
                 for b in range(blocks)]
        assert [u for units in owned for u in units] == list(range(count))
        assert all(len(units) > 0 for units in owned)
    tasks = range(bm.sum_tasks(n, f))
    assert sorted((t // groups, 128 * (t % groups)) for t in tasks) == [
        (r, c) for r in range(n) for c in range(0, f, 128)]
