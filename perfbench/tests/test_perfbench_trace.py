"""The trace's arithmetic on synthetic events: the busy union, the idle
share and its gaps by host operation, the refusals, and the readers'
shares."""

import pytest

from perfbench.harness import Refused
from perfbench.readers import Span, kernels_named, plain_ops_ms, roofline
from perfbench.trace import (Trace, base_name, device_work, is_library,
                             program_kernels)

DEVICE = [(0.0, 0.4, "void q_tc_kernel<false, false, false>(QParams)"),
          (0.2, 0.5, "void at::native::vectorized_elementwise_kernel<4>()"),
          (0.7, 1.0, "sm90_xmma_gemm_f32f32_tf32f32"),
          (1.6, 1.8, "Memcpy DtoD (Device -> Device)")]
HOST = [(0.0, 2.0, "md.steps"), (0.5, 0.7, "aten::nonzero"),
        (1.0, 1.6, "cudaStreamSynchronize")]


def trace(window=2.0):
    return Trace(DEVICE, HOST, window)


def test_busy_union_and_idle():
    t = trace()
    assert t.busy_s == pytest.approx(0.5 + 0.3 + 0.2)
    assert t.idle_share() == pytest.approx(0.5)
    gaps = dict(t.idle_by_host())
    # 0.5-0.7 under nonzero, 1.0-1.6 under the sync, 0.2 at the edges
    assert gaps == pytest.approx({"aten::nonzero": 0.2,
                                  "cudaStreamSynchronize": 0.6,
                                  "span edges": 0.2})


def test_refusals():
    with pytest.raises(Refused):
        Trace([], HOST, 1.0)
    with pytest.raises(Refused):
        trace(window=0.5)


def test_ranges_on_the_device_timeline_are_no_work():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def event(row, device, **flag):
        return SimpleNamespace(
            time_range=SimpleNamespace(start=row[0] * 1e6, end=row[1] * 1e6),
            name=row[2], device_type=device, **flag)

    cuda = DeviceType.CUDA
    events = ([event(r, DeviceType.CPU) for r in HOST]
              + [event(r, cuda) for r in DEVICE]
              + [event((0.0, 1.9, "md.steps"), cuda),
                 event((0.1, 1.8, "a program range"), cuda,
                       is_user_annotation=True)])
    rows = device_work(events, {name for _, _, name in HOST})
    assert [r[2] for r in rows] == [r[2] for r in DEVICE]


def test_names():
    assert base_name(DEVICE[0][2]) == "q_tc_kernel"
    assert base_name("void (anonymous namespace)::dq_tc_kernel<false, false>"
                     "((anonymous namespace)::QParams)") == "dq_tc_kernel"
    assert base_name("void at::native::reduce_kernel<128, 4>()") == \
        "at::native::reduce_kernel"
    assert is_library(DEVICE[2][2]) and not is_library(DEVICE[1][2])
    assert {"q_tc_kernel", "dq_tc_kernel", "emb_fwd_tc_kernel",
            "edge_mlp_tc_kernel", "wc_tc_kernel"} <= program_kernels()


def span(work_scale=1.0):
    geom = {"atoms": 10, "molecules": 1, "pairs": int(1000 * work_scale),
            "coulomb_pairs": 0}
    cfg = dict(embedding_dimension=128, num_rbf=32, q_dim=16, num_layers=2)
    return Span(trace(), cfg, geom, evaluations=1, units=2,
                peak=(67e12, 3.35e12, 495e12))


def test_readers():
    s = span()
    share = roofline(s, "q_tier", kernels_named("q_tc_kernel"))
    assert 0 < share < 100
    assert roofline(s, "q_tier", kernels_named("no_such_kernel")) is None
    anon = "void (anonymous namespace)::"
    q, dq = kernels_named("q_tc_kernel"), kernels_named("dq_tc_kernel")
    assert q(anon + "q_tc_kernel<true, false, false>(QParams)")
    assert not q(anon + "dq_tc_kernel<false, false>(QParams)")
    assert dq(anon + "dq_tc_kernel<false, false>(QParams)")
    pre = kernels_named("edge_mlp_tc_kernel<false")
    assert pre(anon + "edge_mlp_tc_kernel<false, 128>(MlpParams)")
    assert not pre(anon + "edge_mlp_tc_kernel<true, 128>(MlpParams)")
    # the elementwise kernel and the copy: (0.3 + 0.2) s over 2 units
    assert plain_ops_ms(s) == pytest.approx(250.0)
    with pytest.raises(Refused):
        roofline(span(1e9), "q_tier", kernels_named("q_tc_kernel"))
