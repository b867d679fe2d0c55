"""Widths that are not a multiple of 4 on the card (ROADMAP Queue 3 item 1):
kernels 1-4 read float4 rows, so their wrappers pad F and R to the next
multiple of 4 with zero lanes and slice the outputs.  Here the padding is
held on the plain versions at F = 30, R = 50: the plain op on the padded
operands, sliced, equals the plain op unpadded, in values and in the
gradients of every input, and the padded lanes come out exactly zero.
The plan functions accept these widths, and the wrappers refuse only the
CPU device.  Torch only."""

import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from torchmdnet_tpu_torch.ops import edge_mlp as em
from torchmdnet_tpu_torch.ops import radial_embedding as re_ops
from torchmdnet_tpu_torch.ops.kernels import (
    lane_width, pad_lanes, pad_runs, unpad_lanes, unpad_runs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, K, R, F = 7, 9, 50, 30


def rand(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, dtype=torch.float64) * scale


def emb_inputs(seed=0, f=F, r=R):
    gen = torch.Generator().manual_seed(seed)
    em_ = (torch.rand((N, K), generator=gen) < 0.7).double()
    v = rand(gen, N, K, 3)
    v = v / v.norm(dim=-1, keepdim=True)
    return [torch.rand((N, K, r), generator=gen, dtype=torch.float64),
            em_ * 0.5, v[..., 0], v[..., 1], v[..., 2], rand(gen, N, f),
            rand(gen, N, K, f) * em_[..., None], em_,
            rand(gen, r, 3 * f, scale=0.3), rand(gen, 3 * f, scale=0.1)]


def edge_inputs(seed=0, f=F, r=R, pre=False):
    gen = torch.Generator().manual_seed(seed)
    rows = rand(gen, N, K, f if pre else r)
    cw = torch.rand((N, K), generator=gen, dtype=torch.float64)
    w = [rand(gen, f, 2 * f, scale=0.3), rand(gen, 2 * f, scale=0.1),
         rand(gen, 2 * f, 3 * f, scale=0.3), rand(gen, 3 * f, scale=0.1)]
    if pre:
        return [rows, cw, *w]
    return [rows, cw, rand(gen, r, f, scale=0.3), rand(gen, f, scale=0.1),
            *w]


def test_lane_helpers():
    assert [lane_width(n) for n in (1, 4, 30, 50, 130)] == [4, 4, 32, 52, 132]
    t = torch.arange(18.0).reshape(2, 9)
    p = pad_lanes(t, -1, 3, 4)
    assert p.shape == (2, 12) and not p[:, 3::4].any()
    torch.testing.assert_close(unpad_lanes(p, -1, 3, 3), t, rtol=0, atol=0)
    assert pad_lanes(t, -1, 3, 3) is t
    runs = {"t": ((-1, 3),), "u": ((0, 1), (1, 3))}
    u = torch.arange(27.0).reshape(3, 9)
    p = pad_runs(dict(t=t, u=u, v=None), runs, 4)
    assert p["t"].shape == (2, 12) and p["u"].shape == (4, 12)
    assert p["v"] is None
    back = unpad_runs(p, runs, 3)
    torch.testing.assert_close(back["t"], t, rtol=0, atol=0)
    torch.testing.assert_close(back["u"], u, rtol=0, atol=0)
    assert back["v"] is None


def emb_padded(x, g=None):
    """Kernel 1's operands (and kernel 2's cotangent ``g``) padded by the
    wrappers' table, ``radial_embedding.RUNS``."""
    tensors = dict(zip(re_ops._NAMES, x), **({} if g is None else {"g": g}))
    p = pad_runs(tensors, re_ops.RUNS, lane_width(x[5].shape[-1]))
    return (list(p.values()), None) if g is None else (
        list(p.values())[:10], p["g"])


def edge_padded(x, f, r=4, pre=False):
    """Kernel 3's (``pre``) or 4's operands padded by the wrappers' tables
    (``edge_mlp.padded``)."""
    names = (("pre1", "cw") if pre else ("x", "cw", "w1", "b1")) + (
        "w2", "b2", "w3", "b3")
    return em.padded(dict(zip(names, x)), f, r)


def check_grads(leaves, want_fn, got_fn, g_shape, seed=9):
    """Values and the gradient of every leaf: ``got_fn`` (through the
    padding) against ``want_fn``, float64, to 1e-12."""
    g = torch.randn(g_shape, generator=torch.Generator().manual_seed(seed),
                    dtype=torch.float64)
    outs = []
    for fn in (want_fn, got_fn):
        x = [t.detach().clone().requires_grad_(True) for t in leaves]
        out = fn(*x)
        grads = torch.autograd.grad(out, x, g, allow_unused=True)
        outs.append((out.detach(), grads))
    (want, gw), (got, gg) = outs
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    for i, (a, b) in enumerate(zip(gg, gw)):
        if b is None:
            assert a is None or not a.any(), i
        else:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12,
                                       msg=f"input {i}")


def test_embedding_forward_padded():
    x = emb_inputs()
    padded = re_ops.radial_embedding_ref(*emb_padded(x)[0])
    assert padded.shape == (N, 9 * 32)
    assert not padded.reshape(N, 9, 32)[..., F:].any()

    def through_padding(*a):
        return unpad_lanes(re_ops.radial_embedding_ref(*emb_padded(a)[0]),
                           -1, 9, F)

    check_grads(x, re_ops.radial_embedding_ref, through_padding, (N, 9 * F))


@pytest.mark.parametrize("dz, dk", [(False, False), (True, False),
                                    (True, True)])
def test_embedding_backward_padded(dz, dk):
    """Kernel 2's forms (dz, dk) on the padded operands and cotangent,
    sliced back by ``unpad_runs`` on the same table, equal the unpadded
    plain backward."""
    x = emb_inputs(seed=1)
    g = torch.randn((N, 9 * F), generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    needs = [True] * 5 + [dz, dz, False, dk, dk]
    want = re_ops.radial_embedding_bwd_ref(x, g, needs)
    xp, gp = emb_padded(x, g)
    padded = re_ops.radial_embedding_bwd_ref(xp, gp, needs)
    if dz:
        assert not padded[5][:, F:].any() and not padded[6][..., F:].any()
    if dk:
        assert not padded[7].reshape(R, 3, 32)[..., F:].any()
    got = tuple(unpad_runs(dict(zip(re_ops._GRADS, padded)), re_ops.RUNS,
                           F).values())
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), i
        if b is not None:
            assert a.shape == b.shape, i
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("f, r", [(F, R), (F, 32), (32, R)])
def test_fused_edge_mlp_padded(f, r):
    """Kernel 4's chain: R and F each padded where they need it."""
    x = edge_inputs(f=f, r=r)

    def through_padding(*a):
        rows, cw, w1, b1, w2, b2, w3, b3 = edge_padded(a, f, r)
        assert rows.shape[-1] % 4 == 0 and w2.shape[0] % 4 == 0
        out = em.edge_mlp_ref(rows, cw, w1, b1, w2, b2, w3, b3)
        fp = lane_width(f)
        assert not out.reshape(N, K, 3, fp)[..., f:].any()
        return unpad_lanes(out, -1, 3, f)

    check_grads(x, em.edge_mlp_ref, through_padding, (N, K, 3 * f))


def test_edge_mlp_pre_padded():
    x = edge_inputs(pre=True)

    def through_padding(*a):
        return unpad_lanes(em.edge_mlp_pre_ref(*edge_padded(a, F, pre=True)),
                           -1, 3, F)

    check_grads(x, em.edge_mlp_pre_ref, through_padding, (N, K, 3 * F))


def test_plans_accept_every_width():
    for f in (1, 2, 3, 30, 130):
        for r in (1, 3, 50):
            assert re_ops.emb_plan_error(96, r, f) is None
            assert em.fused_plan_error(r, f) is None
        assert em.pre_plan_error(f) is None
    assert re_ops.emb_plan_error(96, 32, 0) is not None
    assert em.fused_plan_error(0, 30) is not None
    assert em.pre_plan_error(0) is not None


def test_wrappers_refuse_only_the_device():
    """At F = 30, R = 50 the CUDA wrappers raise for the CPU tensors alone
    (they consult the plan first)."""
    x = [t.float() for t in emb_inputs()]
    g = torch.zeros(N, 9 * F)
    w = [t.float() for t in edge_inputs()]
    p = [t.float() for t in edge_inputs(pre=True)]
    for call in (lambda: re_ops.radial_embedding_fwd_cuda(*x),
                 lambda: re_ops.radial_embedding_bwd_cuda(x, g, True, True),
                 lambda: em.edge_mlp_cuda(*w),
                 lambda: em.edge_mlp_pre_cuda(*p)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_a_model_at_odd_widths_takes_the_kernels():
    """TensorNet at F = 30 with 50 rbf keeps the fused embedding and edge
    MLP (the card runs kernels 1, 2 and 4 padded); its CPU forces are
    those of the plain model with the same weights."""
    from torchmdnet_tpu_torch.models.model import create_model

    args = dict(model="tensornet", embedding_dimension=F, num_layers=1,
                num_rbf=R, rbf_type="expnorm", trainable_rbf=False,
                activation="silu", cutoff_lower=0.0, cutoff_upper=4.5,
                max_z=10, max_num_neighbors=16, derivative=True,
                output_model="Scalar", reduce_op="add",
                equivariance_invariance_group="O(3)")
    fused = create_model(dict(args, pallas_embedding=True,
                              pallas_edge_mlp=True), device="cpu")
    plain = create_model(args, device="cpu")
    plain.module.load_state_dict(fused.module.state_dict())
    rep = fused.module.representation_model
    assert rep.tensor_embedding.fused and rep.layers[0].fused
    rng = np.random.RandomState(0)
    z = torch.as_tensor(rng.randint(1, 10, 12))
    pos = torch.as_tensor(rng.rand(12, 3) * 5, dtype=torch.float32)
    seg = torch.as_tensor([0] * 7 + [1] * 5)
    (y1, f1), (y2, f2) = (p.apply(z, pos, seg, num_mols=2)
                          for p in (fused, plain))
    torch.testing.assert_close(y1, y2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f1, f2, rtol=1e-5, atol=1e-5)


# the other kernels with channel widths: rows 5-7 (C = 3F channels), rows
# 8-11 and kernels A-B (F channels), held the same way on their plain
# versions
def cheb_inputs(seed=3, c=3 * F, t=16):
    gen = torch.Generator().manual_seed(seed)
    d = torch.rand((N, K), generator=gen, dtype=torch.float64) * 5.0
    fm = (d < 4.5).double()
    return d, fm, rand(gen, t, c, scale=0.3), rand(gen, N, K, c)


def test_cheb_filters_padded():
    from torchmdnet_tpu_torch.ops import cheb_filter as cf

    d, fm, coeffs, ct = cheb_inputs()
    c, cp = coeffs.shape[1], lane_width(coeffs.shape[1])
    assert c % 4 and cp == 92
    coeffs_p, ct_p = pad_runs(dict(coeffs=coeffs, ct=ct), cf.RUNS,
                              cp).values()
    pairs = [
        (cf.cheb_filter_ref(coeffs_p, d, fm, 0.0, 4.5)[..., :c],
         cf.cheb_filter_ref(coeffs, d, fm, 0.0, 4.5)),
        (cf.cheb_filter_dot_ref(coeffs_p, d, fm, ct_p, 0.0, 4.5),
         cf.cheb_filter_dot_ref(coeffs, d, fm, ct, 0.0, 4.5)),
        (cf.cheb_project_ref(d, fm, ct_p, 16, 0.0, 4.5)[:, :c],
         cf.cheb_project_ref(d, fm, ct, 16, 0.0, 4.5))]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="CUDA"):
        cf.cheb_filter_cuda(coeffs.float(), d.float(), fm.float(), 0.0, 4.5)


def blocked_inputs(seed=4, f=F, t=16):
    gen = torch.Generator().manual_seed(seed)
    rows = torch.arange(N)[:, None]
    mask = torch.rand((N, K), generator=gen) < 0.7
    idx = torch.where(mask, torch.randint(0, N, (N, K), generator=gen), rows)
    d = torch.rand((N, K), generator=gen, dtype=torch.float64) * 5.0
    return dict(idx=idx, mask=mask, d=d, fm=((d < 4.5) & mask).double(),
                attr3f=rand(gen, N, K, 3 * f) * mask[..., None],
                feats9=rand(gen, N, 9 * f), g9=rand(gen, N, 9 * f),
                coeffs=rand(gen, t, 3 * f, scale=0.3),
                dser=rand(gen, t, 3 * f, scale=0.3))


def test_blocked_mp_padded():
    from torchmdnet_tpu_torch.ops import blocked_mp as bm

    v = blocked_inputs()
    p = pad_runs(v, bm.RUNS, 32)
    attr, feats, g9, coeffs, dser = (p[k] for k in (
        "attr3f", "feats9", "g9", "coeffs", "dser"))
    assert feats.shape[1] == 9 * 32 and attr.shape[-1] == 3 * 32
    idx, mask, d, fm = v["idx"], v["mask"], v["d"], v["fm"]
    pairs = [
        (unpad_lanes(bm.neighbor_sum_ref(attr, feats, idx, mask), -1, 9, F),
         bm.neighbor_sum_ref(v["attr3f"], v["feats9"], idx, mask)),
        (unpad_lanes(bm.dattr_ref(g9, feats, idx, mask), -1, 3, F),
         bm.dattr_ref(v["g9"], v["feats9"], idx, mask)),
        (unpad_lanes(bm.neighbor_sum_cheb_ref(coeffs, d, fm, feats, idx, 0.0,
                                              4.5), -1, 9, F),
         bm.neighbor_sum_cheb_ref(v["coeffs"], d, fm, v["feats9"], idx, 0.0,
                                  4.5)),
        (bm.dd_cheb_ref(dser, d, fm, g9, feats, idx, 0.0, 4.5),
         bm.dd_cheb_ref(v["dser"], d, fm, v["g9"], v["feats9"], idx, 0.0,
                        4.5))]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("exact", [False, True])
def test_blocked_q_padded(exact):
    """Kernels A (with du) and B, both bases, on the operands widened by
    their F-runs (``_launch`` pads them so on the card)."""
    from torchmdnet_tpu_torch.ops import blocked_q as bq

    gen = torch.Generator().manual_seed(5)
    v = blocked_inputs(seed=6)
    t = R if exact else 16
    q = dict(cw=torch.rand((N, K), generator=gen, dtype=torch.float64)
             * v["mask"], mask=v["mask"], idx=v["idx"],
             urow=rand(gen, N, F, scale=0.5), ucol=rand(gen, N, F, scale=0.5),
             xwin=rand(gen, N, 9 * F), grow=rand(gen, N, 9 * F),
             coeffs=rand(gen, t, F, scale=0.3),
             dser=rand(gen, t, F, scale=0.3),
             w2=rand(gen, F, 2 * F, scale=0.2), b2=rand(gen, 2 * F, scale=0.1),
             w3=rand(gen, 2 * F, 3 * F, scale=0.2),
             b3=rand(gen, 3 * F, scale=0.1))
    if exact:
        q["rbf"] = torch.rand((N, K, R), generator=gen, dtype=torch.float64)
    p = pad_runs(q, bq.RUNS, 32)
    assert p["w3"].shape == (64, 96) and p["xwin"].shape == (N, 288)
    assert bq.plan_error(F, t, exact) is None

    def run(x):
        w = [x[k] for k in ("w2", "b2", "w3", "b3")]
        rows = [x["cw"], x["mask"], x["idx"], x["urow"], x["ucol"],
                x["xwin"]]
        if exact:
            return (bq.q_fwd_rbf_ref(x["rbf"], *rows, x["coeffs"], *w,
                                     grow=x["grow"]),
                    bq.q_dq_rbf_ref(x["rbf"], *rows, x["grow"], x["coeffs"],
                                    *w))
        return (bq.q_fwd_ref(v["d"], *rows, x["coeffs"], *w, 0.0, 4.5,
                             grow=x["grow"]),
                bq.q_dq_ref(v["d"], *rows, x["grow"], x["coeffs"], x["dser"],
                            *w, 0.0, 4.5))

    (out_p, du_p), (dup, *rest_p) = run(p)
    (out, du), (du2, *rest) = run(q)
    torch.testing.assert_close(unpad_lanes(out_p, -1, 9, F), out, rtol=1e-12,
                               atol=1e-12)
    for got, want in ((du_p, du), (dup, du2)):
        assert not got[:, F:].any()
        torch.testing.assert_close(got[:, :F], want, rtol=1e-12, atol=1e-12)
    for got, want in zip(rest_p, rest):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
