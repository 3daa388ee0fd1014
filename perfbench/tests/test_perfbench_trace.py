"""The trace arithmetic on a hand-made trace, and the FLOP accounting."""

import pytest

from harness import flops, trace
from uresnet_tpu_torch.tools import bench


def _op(name, i, a, b, shapes=(), nested=False):
    return trace.Op(name, i, a, b, list(shapes), nested)


def test_busy_union_idle_and_gaps():
    t = trace.Trace(
        device=[("k1", 10, 30, 0), ("k2", 20, 40, 0), ("copy", 60, 70, 0),
                ("late", 95, 120, 0)],
        host=[_op(trace.WINDOW, 1, 0, 100), _op("bench.step", 2, 0, 55),
              _op("aten::conv", 3, 45, 55), _op("bench.readback", 4, 55, 100),
              _op("cudaStreamSynchronize", 5, 75, 100)],
        window=(0, 100))
    assert t.busy_intervals() == [(10, 40), (60, 70), (95, 100)]
    assert t.busy_s == pytest.approx(45e-6)
    assert t.window_s == pytest.approx(100e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["late", pytest.approx(25e-6)]
    gaps = dict(b["idle_gaps"])
    assert gaps == {"bench.readback > cudaStreamSynchronize": pytest.approx(25e-6),
                    "bench.step > aten::conv": pytest.approx(20e-6),
                    "bench.step": pytest.approx(10e-6)}


def test_idle_share_and_roofline_readers():
    from harness import loops, spec

    x, w = [2, 8, 8, 16], [3, 3, 16, 16]
    calls = [_op("uresnet_tpu_torch::fused_conv3x3_bn_relu_v2", 7, 0, 5,
                 [x, w, [16], [16], [], []]),
             _op("uresnet_tpu_torch::fused_conv3x3_bn_relu_v2", 8, 1, 2,
                 [x, w, [16], [16], [], []], nested=True),
             _op(trace.WINDOW, 9, 0, 100)]
    t = trace.Trace(device=[("void conv3x3_tc_kernel<bf16>", 10, 60, 8)],
                    host=calls, window=(0, 100))
    # 1 step: 50 us busy in the trace, 200 us untraced
    run = loops.Traced("ana", t, 2e-4, 1, 2, 8, {}, 2, 1)
    assert spec.metric_reader("idle_share.serve")(run) == pytest.approx(75.0)
    assert spec.metric_reader("idle_share.train")(run) is None
    f, nbytes = flops.fused_conv_call([x, w, [16], [16], [], []], 2)
    assert f == 2 * 2 * 8 * 8 * 9 * 16 * 16
    assert nbytes == 2 * (2 * 64 * 16 * 2 + 9 * 256) + 4 * 32
    want = 100 * flops.least_seconds(f, nbytes) / 50e-6
    got = spec.metric_reader("fused_conv_roofline.serve")(run)
    assert got == pytest.approx(want)
    run.launches = 2  # the counter disagrees: nothing is read
    assert spec.metric_reader("fused_conv_roofline.serve")(run) is None


@pytest.mark.parametrize("dims,size,depth", [(2, 512, 5), (3, 192, 4),
                                             (2, 64, 3)])
def test_macs_equal_the_programs_accounting(dims, size, depth):
    kw = dict(size=size, batch=3, dims=dims, depth=depth, base=16)
    assert flops.uresnet_forward_macs(**kw) == bench.uresnet_forward_macs(**kw)
