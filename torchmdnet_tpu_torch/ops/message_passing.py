"""Neighbor gathers and the packed neighbor sums.

Counterpart of ``torchmdnet_tpu/ops/message_passing.py`` (the gather
path).  The neighbor matrix holds both directions of every pair, so the
map ``(n, k) → (idx[n,k], rev_slot[n,k])`` is an involution on the valid
slots: the transpose of a masked gather is the sum over ``k`` of a masked
*reverse* gather, and every backward here is a gather, never a scatter.

The packed neighbor sum works over row chunks: gathering ``feats9[idx]``
whole is an ``[N, K, 9F]`` block (11.1 GB per layer at N=25,088, K=96,
F=128), so neither direction ever holds more than one chunk of it.

Force training differentiates through the backward of the symmetric sum
(the force pass) once more, so its backward is built from the
differentiable ops below, as in JAX (``:248-573``): the sum itself, the
weight gradient ``_PnsDattr`` and, for the latter's own backward, the
general sum with its scatter-free ``_PnsBwdPair``.  The asymmetric sum
of TensorNet2 is built the same way.  The reverse gather itself
(:func:`gather_rev`) is self-adjoint, so its backward is the same gather
at every order, and the position gather of the edge geometry
(:func:`gather_pair_deltas`) transposes onto it too.

Every transpose here is exact on a symmetric edge set.  After a K
overflow a row keeps only its first ``K`` neighbors, the map is no longer
an involution, and the transposes differ from the true ones exactly as
the JAX package's do.
"""

import torch

from torchmdnet_tpu_torch.ops.kernels import neighbour_sum_out

# Transient budget of one row chunk of an [N, K, width] gathered block.
CHUNK_BUDGET_BYTES = 512 * 1024 * 1024


def row_chunk(n: int, k: int, width: int, budget_bytes=None) -> int:
    """Rows per chunk so a [chunk, K, width] float32 block fits the budget
    (``CHUNK_BUDGET_BYTES`` unless given)."""
    if budget_bytes is None:
        budget_bytes = CHUNK_BUDGET_BYTES
    return int(min(n, max(budget_bytes // (k * width * 4), 8)))


def reverse_slots(idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``rev_slot[n,k]`` = position of ``n`` among the VALID slots of row
    ``idx[n,k]`` (0 on invalid slots).  The [C, K, K] comparison is built
    over row chunks so it stays bounded."""
    n, k = idx.shape
    out = torch.zeros_like(idx)
    chunk = row_chunk(n, k, k, budget_bytes=128 * 1024 * 1024)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        idx_c = idx[s:e]
        me = torch.arange(s, e, device=idx.device)
        hit = (idx[idx_c] == me[:, None, None]) & mask[idx_c]
        out[s:e] = hit.to(torch.uint8).argmax(dim=-1)
    return torch.where(mask, out, 0)


class _GatherRev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, idx, rev_slot, mask):
        ctx.save_for_backward(idx, rev_slot, mask)
        return torch.where(mask[..., None], g[idx, rev_slot], 0.0)

    @staticmethod
    def backward(ctx, ct):
        idx, rev_slot, mask = ctx.saved_tensors
        return _GatherRev.apply(ct, idx, rev_slot, mask), None, None, None


def gather_rev(g, idx, rev_slot, mask):
    """Masked reverse gather ``g[idx[n,k], rev_slot[n,k]]`` (JAX ``:51-68``).
    The slot map is an involution on the valid slots, so the op is its own
    transpose: its backward is this gather again, at every order (plain
    indexing would transpose to an ``index_put`` scatter)."""
    return _GatherRev.apply(g, idx, rev_slot, mask)


class _GatherPairDeltas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pos, idx, rev_slot, mask):
        ctx.save_for_backward(idx, rev_slot, mask)
        return pos[:, None, :] - pos[idx]

    @staticmethod
    def backward(ctx, ct):
        idx, rev_slot, mask = ctx.saved_tensors
        # invalid slots must not reach dpos through the reverse gather
        ct = torch.where(mask[..., None], ct, 0.0)
        dpos = ct.sum(dim=1) - gather_rev(ct, idx, rev_slot, mask).sum(dim=1)
        return dpos, None, None, None


def gather_pair_deltas(pos, idx, rev_slot, mask):
    """``delta[i,k] = pos[i] - pos[idx[i,k]]`` with a scatter-free backward
    (JAX ``:71-101``): ``dpos[j] = Σ_k ct[j,k] − Σ_k ct[idx[j,k],
    rev_slot[j,k]]`` over the valid slots, built from :func:`gather_rev`,
    so it is differentiable again (force training).  The default transpose
    of ``pos[idx]`` is an atomic scatter with duplicate indices."""
    return _GatherPairDeltas.apply(pos, idx, rev_slot, mask)


class _GatherNodes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, rev_slot, mask):
        ctx.save_for_backward(idx, rev_slot, mask)
        return torch.where(mask[..., None], x[idx], 0.0)

    @staticmethod
    def backward(ctx, ct):
        idx, rev_slot, mask = ctx.saved_tensors
        return gather_rev(ct, idx, rev_slot, mask).sum(dim=1), None, None, None


def gather_nodes(x, idx, rev_slot, mask):
    """Masked node-feature gather ``x[idx]`` → ``[N, K, C]`` (0 on invalid
    slots), whose transpose is the reverse gather summed over ``k``."""
    return _GatherNodes.apply(x, idx, rev_slot, mask)


def _pns_impl(attr3f, feats9, idx):
    """``msg[n] = Σ_k expand9(attr3f[n,k]) ⊙ feats9[idx[n,k]]`` → [N, 9F];
    ``attr3f`` carries the cutoff/pad mask already."""
    n, k, c3 = attr3f.shape
    f = c3 // 3
    out = attr3f.new_empty((n, 9 * f))
    chunk = row_chunk(n, k, 9 * f)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        xj = feats9[idx[s:e]].view(e - s, k, 9, f)
        w = attr3f[s:e].view(e - s, k, 3, f)
        o = out[s:e].view(e - s, 9, f)
        o[:, 0:1] = (w[:, :, 0:1] * xj[:, :, 0:1]).sum(1)
        o[:, 1:4] = (w[:, :, 1:2] * xj[:, :, 1:4]).sum(1)
        o[:, 4:9] = (w[:, :, 2:3] * xj[:, :, 4:9]).sum(1)
    return out


def _pns_dattr(g9, feats9, idx, mask):
    """∂/∂attr3f of the packed sum: ``fold9(g9[n] ⊙ feats9[idx[n,k]])``,
    zero on invalid slots → [N, K, 3F]."""
    n, k = idx.shape
    f = g9.shape[-1] // 9
    out = g9.new_empty((n, k, 3 * f))
    chunk = row_chunk(n, k, 9 * f)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        xj = feats9[idx[s:e]].view(e - s, k, 9, f)
        prod = g9[s:e].view(e - s, 1, 9, f) * xj
        o = out[s:e].view(e - s, k, 3, f)
        o[:, :, 0] = prod[:, :, 0]
        o[:, :, 1] = prod[:, :, 1:4].sum(2)
        o[:, :, 2] = prod[:, :, 4:9].sum(2)
        o.mul_(mask[s:e, :, None, None])
    return out


class _PackedNeighborSumAsym(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attr3f, attr_rev, feats9, idx, rev_slot, mask):
        ctx.save_for_backward(attr_rev, feats9, idx, rev_slot, mask)
        return neighbour_sum_out(lambda: _pns_impl(attr3f, feats9, idx),
                                 feats9)

    @staticmethod
    def backward(ctx, g):
        attr_rev, feats9, idx, rev_slot, mask = ctx.saved_tensors
        g = g.contiguous()
        dattr = dfeats = None
        if ctx.needs_input_grad[0]:
            dattr = _PnsDattr.apply(g, feats9, idx, rev_slot, mask)
        if ctx.needs_input_grad[2]:
            dfeats = packed_neighbor_sum(attr_rev, g, idx, rev_slot, mask)
        # attr_rev: a zero first-order cotangent, as in JAX (the output does
        # not depend on it); it reaches the second order through dfeats
        return dattr, None, dfeats, None, None, None


def packed_neighbor_sum_asym(attr3f, attr_rev, feats9, idx, rev_slot, mask):
    """Packed neighbor sum for direction-dependent edge weights whose
    reverse-edge weights ``attr_rev[j,k] = attr3f[idx[j,k], rev_slot[j,k]]``
    the caller recomputes (the swapped-argument edge MLP; JAX
    ``:576-631``).  The backward needs row gathers only: ``∂attr =
    fold9(g ⊙ feats9[idx])`` and ``∂feats9 = packed_sum(attr_rev, g)``,
    both differentiable again (force training); ``attr_rev`` gets a zero
    first-order cotangent.  Saves ``attr_rev`` and ``feats9`` only; the
    gathered blocks are rebuilt per chunk in the backward."""
    return _PackedNeighborSumAsym.apply(attr3f, attr_rev, feats9, idx,
                                        rev_slot, mask)


class _PnsDattr(torch.autograd.Function):
    """``fold9(g9[n] ⊙ feats9[idx[n,k]])`` (JAX ``_pns_dattr``,
    ``:511-541``); its VJP is two general packed sums:
    ``∂g9 = pns(ct, feats9)``, ``∂feats9 = pns(gather_rev(ct), g9)``."""

    @staticmethod
    def forward(ctx, g9, feats9, idx, rev_slot, mask):
        ctx.save_for_backward(g9, feats9, idx, rev_slot, mask)
        return _pns_dattr(g9, feats9, idx, mask)

    @staticmethod
    def backward(ctx, ct):
        g9, feats9, idx, rev_slot, mask = ctx.saved_tensors
        # the output is 0 on invalid slots: their cotangent has no effect
        ct = torch.where(mask[..., None], ct, 0.0)
        dg = dfeats = None
        if ctx.needs_input_grad[0]:
            dg = packed_neighbor_sum(ct, feats9, idx, rev_slot, mask)
        if ctx.needs_input_grad[1]:
            dfeats = packed_neighbor_sum(gather_rev(ct, idx, rev_slot, mask),
                                         g9, idx, rev_slot, mask)
        return dg, dfeats, None, None, None


class _PackedNeighborSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attr3f, feats9, idx, rev_slot, mask):
        ctx.save_for_backward(attr3f, feats9, idx, rev_slot, mask)
        return _pns_impl(attr3f, feats9, idx)

    @staticmethod
    def backward(ctx, g):
        attr3f, feats9, idx, rev_slot, mask = ctx.saved_tensors
        dattr, dfeats = _PnsBwdPair.apply(attr3f, feats9, g.contiguous(), idx,
                                          rev_slot, mask)
        return dattr, dfeats, None, None, None


class _PnsBwdPair(torch.autograd.Function):
    """``(∂attr, ∂feats)`` of the general packed sum (JAX ``_pns_bwd_pair``,
    ``:312-413``): ``∂attr = fold9(g ⊙ feats9[idx])``, ``∂feats =
    pns(attr_rev, g)`` with ``attr_rev = gather_rev(attr3f)``; its own
    VJP decomposes onto the packed sum, ``_PnsDattr`` and ``gather_rev``."""

    @staticmethod
    def forward(ctx, attr3f, feats9, g, idx, rev_slot, mask):
        ctx.save_for_backward(attr3f, feats9, g, idx, rev_slot, mask)
        dattr = _pns_dattr(g, feats9, idx, mask)
        dfeats = _pns_impl(gather_rev(attr3f, idx, rev_slot, mask), g, idx)
        return dattr, dfeats

    @staticmethod
    def backward(ctx, ct_da, ct_df):
        attr3f, feats9, g, idx, rev_slot, mask = ctx.saved_tensors
        ct_da = torch.where(mask[..., None], ct_da, 0.0)
        dattr = _PnsDattr.apply(g, ct_df.contiguous(), idx, rev_slot, mask)
        dg = (packed_neighbor_sum(ct_da, feats9, idx, rev_slot, mask)
              + packed_neighbor_sum(attr3f, ct_df, idx, rev_slot, mask))
        dfeats = packed_neighbor_sum(gather_rev(ct_da, idx, rev_slot, mask),
                                     g, idx, rev_slot, mask)
        return dattr, dfeats, dg, None, None, None


def packed_neighbor_sum(attr3f, feats9, idx, rev_slot, mask):
    """``msg[n] = Σ_k expand9(attr3f[n,k]) ⊙ feats9[idx[n,k]]`` for any
    edge weights (JAX ``:248-428``), differentiable to any order through
    row gathers and the slot involution (no scatter)."""
    return _PackedNeighborSum.apply(attr3f.contiguous(), feats9.contiguous(),
                                    idx, rev_slot, mask)


class _PackedNeighborSumSym(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attr3f, feats9, idx, rev_slot, mask):
        ctx.save_for_backward(attr3f, feats9, idx, rev_slot, mask)
        return neighbour_sum_out(lambda: _pns_impl(attr3f, feats9, idx),
                                 feats9)

    @staticmethod
    def backward(ctx, g):
        attr3f, feats9, idx, rev_slot, mask = ctx.saved_tensors
        g = g.contiguous()
        dattr = dfeats = None
        if ctx.needs_input_grad[0]:
            dattr = _PnsDattr.apply(g, feats9, idx, rev_slot, mask)
        if ctx.needs_input_grad[1]:
            dfeats = _PackedNeighborSumSym.apply(attr3f, g, idx, rev_slot,
                                                 mask)
        return dattr, dfeats, None, None, None


def packed_neighbor_sum_sym(attr3f, feats9, idx, rev_slot, mask):
    """Packed neighbor sum for edge-symmetric weights (``attr3f[i, s_ij] ==
    attr3f[j, s_ji]``, functions of the edge distance alone, as in
    TensorNet's interaction; JAX ``message_passing.py:544-573``).  The
    per-channel operator is then a symmetric matrix, so the feature
    backward is the forward itself: ``∂feats9 = packed_sum(attr3f, g)``;
    ``∂attr = fold9(g ⊙ feats9[idx])``.  Both are differentiable again
    (force training).  Exact transposition assumes a symmetric edge set,
    i.e. no K overflow."""
    return _PackedNeighborSumSym.apply(attr3f, feats9, idx, rev_slot, mask)
