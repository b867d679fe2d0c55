"""Cutoff Coulomb pair energy with gather-only gradients (list path).

Counterpart of ``coulomb_cutoff_energy_w`` (``torchmdnet_tpu/ops/
coulomb.py:209``): the per-atom energy of the multi-channel predicted
charges over a cutoff neighbor list with the reaction field of the
reference head (``output_modules.py:566-588``),

    E_i = Σ_k m_ik · G(d_ik) · Σ_c w_c b_ic b_jc,      j = idx[i,k]
    G(d) = factor · (1 − f_exp(d)) · (1/d + k_rf·d² − c_rf)

with the AIMNet2 short-range damping ``f_exp``.  Edges beyond ``rc``
contribute zero, so a skin-padded list is exact.

Both directions run over row chunks: at the 10 Å head with a skin the
list has ~1,060 slots per row, and autograd through an unchunked gather
would hold a [25,088, 1,060, 48] block (~5 GB).  The forward keeps no
per-edge tensor; the backward recomputes each chunk's geometry and uses
the first-order form of ``_ccew_bwd`` (``:223``, derived at ``:188-204``),
which needs row gathers only because the edge set is symmetric and G
depends on d alone:

    ∂pos_m = Σ_k G'(d)·v̂·pd·(ct_m + ct_j),   pd = Σ_c w_c b_mc b_jc
    ∂b_m   = ct_m·(w ⊙ S1_m) + w ⊙ S2_m,     S1 = Σ_k G·b_j, S2 = Σ_k G·ct_j·b_j
    ∂w_c   = Σ_m ct_m · b_mc · S1_mc

:func:`coulomb_cutoff_energy` is the general two-operand form
(``Σ_c a_ic b_jc``, JAX ``coulomb_cutoff_energy`` ``:94-186``), which the
JAX package exports and no head calls; its backward is ``_cce_bwd``'s
(``:144-185``), gathers only as well: one gathered block
``[pos | b | ct·a]`` a chunk,

    ∂pos_m = Σ_k G'(d)·v̂·(ct_m·Σ_c a_mc b_jc + Σ_c b_mc (ct·a)_jc)
    ∂a_m   = ct_m·Σ_k G·b_j,     ∂b_m = Σ_k G·(ct·a)_j

Both backwards are plain PyTorch on the saved inputs and the cotangent
(:func:`coulomb_w_vjp`, :func:`coulomb_ab_vjp`), so under
``create_graph`` autograd differentiates them once more, as JAX
differentiates ``_ccew_bwd``/``_cce_bwd``: a force loss's gradient
reaches the charges' weights.  G′ is the analytic derivative of G
(:func:`g_and_grad`), differentiable in turn.
"""

import torch

from torchmdnet_tpu_torch.ops.message_passing import row_chunk
from torchmdnet_tpu_torch.ops.neighbors import wrap_deltas

_DAMP_RC = 4.6
_INV_E = 0.36787944117144233


def _rf_constants(rc: float, eps: float):
    k_rf = (1.0 / rc ** 3) * (eps - 1.0) / (2.0 * eps + 1.0)
    c_rf = (1.0 / rc) * (3.0 * eps) / (2.0 * eps + 1.0)
    return k_rf, c_rf


def g_kernel(d, rc: float, eps: float, factor: float):
    """G(d) of ``_g_kernel`` (``:52``); requires d > 0."""
    t = torch.clamp(d / _DAMP_RC, 0.0, 1.0 - 1e-6)
    fexp = torch.exp(-1.0 / (1.0 - t * t)) / _INV_E
    k_rf, c_rf = _rf_constants(rc, eps)
    return factor * (1.0 - fexp) * (1.0 / d + k_rf * d * d - c_rf)


def g_and_grad(d, rc: float, eps: float, factor: float):
    """(G(d), dG/dd); the damping's derivative is zero where its argument
    is clamped, as in the clipped JAX expression."""
    t_raw = d / _DAMP_RC
    inside = (t_raw > 0.0) & (t_raw < 1.0 - 1e-6)
    t = torch.clamp(t_raw, 0.0, 1.0 - 1e-6)
    one_m = 1.0 - t * t
    fexp = torch.exp(-1.0 / one_m) / _INV_E
    dfexp = torch.where(inside, fexp * (-2.0 * t / (one_m * one_m)) / _DAMP_RC,
                        0.0)
    k_rf, c_rf = _rf_constants(rc, eps)
    h = 1.0 / d + k_rf * d * d - c_rf
    dh = -1.0 / (d * d) + 2.0 * k_rf * d
    g = factor * (1.0 - fexp) * h
    gp = factor * ((1.0 - fexp) * dh - dfexp * h)
    return g, gp


def _chunk_geometry(pos_c, pj, mask_c, box_c, rc):
    delta = pos_c[:, None, :] - pj
    if box_c is not None:
        delta = wrap_deltas(delta, box_c)
    d2 = (delta * delta).sum(-1)
    valid = mask_c & (d2 > 0)
    safe_d = torch.sqrt(torch.where(valid, d2, 1.0))
    return delta, safe_d, valid & (safe_d < rc)


def _box_rows(box, batch, s, e):
    if box is None or box.dim() == 2:
        return box
    return box[batch[s:e]][:, None]


def _energy(pos, a, b, idx, mask, rc, eps, factor, box, batch):
    """``E_i = Σ_k m·G(d)·Σ_c a_ic b_jc`` over row chunks, no graph."""
    n, k = idx.shape
    c = b.shape[-1]
    src = torch.cat([pos, b], dim=1)
    out = pos.new_empty(n)
    chunk = row_chunk(n, k, 3 + c)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        sj = src[idx[s:e]]
        _, safe_d, valid = _chunk_geometry(
            pos[s:e], sj[..., :3], mask[s:e], _box_rows(box, batch, s, e), rc)
        g = torch.where(valid, g_kernel(safe_d, rc, eps, factor), 0.0)
        pd = (a[s:e, None, :] * sj[..., 3:]).sum(-1)
        out[s:e] = (g * pd).sum(1)
    return out


def coulomb_w_vjp(pos, w, b, ct, idx, mask, rc, eps, factor, box, batch):
    """``(∂pos, ∂w, ∂b)`` of :func:`coulomb_cutoff_energy_w` for the
    cotangent ``ct [N]`` (``_ccew_bwd``), over row chunks; differentiable
    (a graph when grad mode is on)."""
    n, k = idx.shape
    c = b.shape[-1]
    src = torch.cat([pos, b, ct[:, None]], dim=1)
    wb = w[None, :] * b
    dpos, s1, s2 = [], [], []
    chunk = row_chunk(n, k, 4 + c)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        sj = src[idx[s:e]]
        delta, safe_d, valid = _chunk_geometry(
            pos[s:e], sj[..., :3], mask[s:e], _box_rows(box, batch, s, e), rc)
        bj = sj[..., 3:3 + c]
        ctj = sj[..., 3 + c]
        g, gp = g_and_grad(safe_d, rc, eps, factor)
        g = torch.where(valid, g, 0.0)
        gp = torch.where(valid, gp, 0.0)
        pd = (wb[s:e, None, :] * bj).sum(-1)
        sc = gp * pd * (ct[s:e, None] + ctj) / safe_d
        dpos.append((sc[..., None] * delta).sum(1))
        s1.append((g[..., None] * bj).sum(1))
        s2.append(((g * ctj)[..., None] * bj).sum(1))
    s1, s2 = torch.cat(s1), torch.cat(s2)
    db = ct[:, None] * (w[None, :] * s1) + w[None, :] * s2
    dw = (ct[:, None] * b * s1).sum(0)
    return torch.cat(dpos), dw, db


class _CoulombW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pos, w, b, idx, mask, rc, eps, factor, box, batch):
        ctx.save_for_backward(pos, w, b, idx, mask)
        ctx.consts = (rc, eps, factor, box, batch)
        return _energy(pos, w[None, :] * b, b, idx, mask, rc, eps, factor,
                       box, batch)

    @staticmethod
    def backward(ctx, ct):
        pos, w, b, idx, mask = ctx.saved_tensors
        dpos, dw, db = coulomb_w_vjp(pos, w, b, ct, idx, mask, *ctx.consts)
        return dpos, dw, db, None, None, None, None, None, None, None


def coulomb_cutoff_energy_w(pos, w, b, idx, mask, rc: float, eps: float,
                            factor: float, box=None, batch=None):
    """Per-atom energies ``E_i = Σ_k m·G(d)·Σ_c w_c b_ic b_jc`` → [N]
    (see the module docstring).  ``box``: None, [3, 3] or [B, 3, 3] (then
    ``batch`` picks each atom's box)."""
    if box is not None and box.dim() == 3 and batch is None:
        batch = torch.zeros(pos.shape[0], dtype=torch.long, device=pos.device)
    return _CoulombW.apply(pos, w, b, idx, mask, float(rc), float(eps),
                           float(factor), box, batch)


def coulomb_ab_vjp(pos, a, b, ct, idx, mask, rc, eps, factor, box, batch):
    """``(∂pos, ∂a, ∂b)`` of :func:`coulomb_cutoff_energy` for the
    cotangent ``ct [N]`` (``_cce_bwd``), over row chunks; differentiable
    (a graph when grad mode is on)."""
    n, k = idx.shape
    c = b.shape[-1]
    src = torch.cat([pos, b, ct[:, None] * a], dim=1)
    dpos, da, db = [], [], []
    chunk = row_chunk(n, k, 3 + 2 * c)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        sj = src[idx[s:e]]
        delta, safe_d, valid = _chunk_geometry(
            pos[s:e], sj[..., :3], mask[s:e], _box_rows(box, batch, s, e), rc)
        bj = sj[..., 3:3 + c]
        ctaj = sj[..., 3 + c:]
        g, gp = g_and_grad(safe_d, rc, eps, factor)
        g = torch.where(valid, g, 0.0)
        gp = torch.where(valid, gp, 0.0)
        pd = (a[s:e, None, :] * bj).sum(-1)
        pd2 = (b[s:e, None, :] * ctaj).sum(-1)
        da.append(((ct[s:e, None] * g)[..., None] * bj).sum(1))
        db.append((g[..., None] * ctaj).sum(1))
        sc = gp * (ct[s:e, None] * pd + pd2) / safe_d
        dpos.append((sc[..., None] * delta).sum(1))
    return torch.cat(dpos), torch.cat(da), torch.cat(db)


class _CoulombAB(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pos, a, b, idx, mask, rc, eps, factor, box, batch):
        ctx.save_for_backward(pos, a, b, idx, mask)
        ctx.consts = (rc, eps, factor, box, batch)
        return _energy(pos, a, b, idx, mask, rc, eps, factor, box, batch)

    @staticmethod
    def backward(ctx, ct):
        pos, a, b, idx, mask = ctx.saved_tensors
        dpos, da, db = coulomb_ab_vjp(pos, a, b, ct, idx, mask, *ctx.consts)
        return dpos, da, db, None, None, None, None, None, None, None


def coulomb_cutoff_energy(pos, a, b, idx, mask, rc: float, eps: float,
                          factor: float, box=None, batch=None):
    """Per-atom energies ``E_i = Σ_k m·G(d)·Σ_c a_ic b_jc`` → [N] (JAX
    ``ops/coulomb.py:94``).  Its backward assumes what the head's lists
    give: a symmetric edge set, each pair in both rows."""
    if box is not None and box.dim() == 3 and batch is None:
        batch = torch.zeros(pos.shape[0], dtype=torch.long, device=pos.device)
    return _CoulombAB.apply(pos, a, b, idx, mask, float(rc), float(eps),
                            float(factor), box, batch)
