"""The program's spans read as per-phase device time (harness/spans.py
and the metrics/*_ms.* readers): on hand-made traces, and on traces of a
small train and analysis window profiled on the CPU."""

import time

import pytest

import small
from harness import loops, spans, spec, trace

TRAIN_READERS = {"densify_ms.train": "uresnet.train.densify",
                 "forward_ms.train": "uresnet.train.forward",
                 "loss_ms.train": "uresnet.train.loss",
                 "backward_ms.train": "uresnet.train.backward",
                 "optim_ms.train": "uresnet.train.optim"}
ANA_READERS = {"densify_ms.serve": "uresnet.ana.densify",
               "forward_ms.serve": "uresnet.ana.forward",
               "scores_ms.serve": "uresnet.ana.scores"}


def _op(name, i, a, b):
    return trace.Op(name, i, a, b, [], False)


def _run(kind, t, steps=1):
    return loops.Traced(kind, t, 1e-3, steps, 2, 8, {}, 2, 0)


def _train_trace(copy=(62, 72)):
    """One train step (us): every phase span with its launch calls and
    their work on the card, which runs behind the host; the backward's
    launch on the autograd engine's thread, inside its span in time only;
    the staging copy at ``copy``; a readback outside every span."""
    host = [_op(trace.WINDOW, 1, 0, 1000),
            _op("bench.stage", 20, 5, 22), _op("uresnet.stage", 2, 10, 20),
            _op("aten::copy_", 3, 12, 18), _op("cudaMemcpyAsync", 30, 13, 15),
            _op("bench.step", 21, 22, 850),
            _op("uresnet.train.densify", 4, 22, 100),
            _op("aten::index_put_", 5, 30, 40),
            _op("cudaLaunchKernel", 31, 32, 34),
            _op("uresnet.train.forward", 6, 100, 300),
            _op("aten::cudnn_convolution", 7, 110, 150),
            _op("cudaLaunchKernelExC", 32, 112, 114),
            _op("uresnet_tpu_torch::fused_conv3x3_bn_relu_v2", 14, 120, 130),
            _op("cudaLaunchKernel", 33, 122, 124),
            _op("uresnet.train.loss", 8, 300, 350),
            _op("aten::log_softmax", 9, 310, 320),
            _op("cudaLaunchKernel", 34, 312, 314),
            _op("uresnet.train.backward", 10, 350, 700),
            _op("aten::convolution_backward", 11, 400, 420),
            _op("cuLaunchKernel", 35, 402, 404),
            _op("cudaMemsetAsync", 36, 405, 406),
            _op("uresnet.train.optim", 12, 700, 800),
            _op("aten::_foreach_add", 13, 710, 720),
            _op("cudaLaunchKernel", 37, 712, 714),
            _op("bench.readback", 22, 850, 1000),
            _op("aten::copy_", 15, 890, 905),
            _op("cudaMemcpyAsync", 38, 891, 893)]
    device = [("Memcpy HtoD (Pinned -> Device)", *copy, 0),
              ("index_put_kernel", 40, 60, 0),
              ("sm90_xmma_fprop", 150, 200, 0),
              ("conv3x3_tc_kernel", 205, 215, 0),
              ("softmax_kernel", 320, 330, 0),
              ("sm90_xmma_wgrad", 430, 600, 0),
              ("Memset (Device)", 600, 605, 0),
              ("multi_tensor_apply_kernel", 720, 760, 0),
              ("Memcpy DtoH (Device -> Pageable)", 900, 910, 0)]
    return trace.Trace(device=device, host=host, window=(0, 1000))


def test_work_goes_to_the_span_around_its_launch():
    s = spans.split(_train_trace(), 1)
    assert s.device_ms == pytest.approx({
        "uresnet.stage": 0.010, "uresnet.train.densify": 0.020,
        "uresnet.train.forward": 0.060, "uresnet.train.loss": 0.010,
        "uresnet.train.backward": 0.175, "uresnet.train.optim": 0.040,
        spans.UNHELD: 0.010})
    assert s.count == {"uresnet.stage": 1, "uresnet.train.densify": 1,
                       "uresnet.train.forward": 1, "uresnet.train.loss": 1,
                       "uresnet.train.backward": 1, "uresnet.train.optim": 1}
    assert s.pairs == {"staging copy": (1, 1), "kernel": (6, 6),
                       "memset": (1, 1), "copy": (1, 1)}
    assert s.fallback_ms == {}
    # the densify span's 78 us, 30 of them busy: its kernel and the copy
    assert s.idle_ms["uresnet.train.densify"] == pytest.approx(0.048)
    assert s.idle_ms["uresnet.train.backward"] == pytest.approx(0.175)


def test_launches_pair_with_the_work_in_order_however_far_ahead():
    """The host launches a whole step before the card runs any of it: the
    n-th kernel is still the n-th launch's."""
    t = _train_trace()
    t.device = [(n, a + 2000, b + 2000, 0) for n, a, b, _ in t.device]
    t.window = (0, 3000)
    s = spans.split(t, 1)
    assert s.device_ms["uresnet.train.backward"] == pytest.approx(0.175)
    assert s.device_ms["uresnet.train.forward"] == pytest.approx(0.060)
    # the card is idle while the host runs every span
    assert s.idle_ms["uresnet.train.backward"] == pytest.approx(0.350)


def test_a_launch_from_another_thread_falls_in_the_span_around_it():
    """The backward's launch has no parent span on its own thread; it is
    the backward's by time, and so are the kernels that follow it."""
    t = _train_trace()
    t.host.append(_op("cudaLaunchKernel", 39, 410, 412))
    t.device.append(("sm90_xmma_dgrad", 610, 640, 0))
    t.device.sort(key=lambda d: d[1])
    s = spans.split(t, 1)
    assert s.device_ms["uresnet.train.backward"] == pytest.approx(0.205)
    assert s.device_ms["uresnet.train.optim"] == pytest.approx(0.040)


def test_left_over_work_takes_the_span_of_the_work_before_it():
    t = _train_trace()
    t.device.append(("conv3x3_tc_kernel", 765, 770, 0))  # no launch left
    s = spans.split(t, 1)
    assert s.pairs["kernel"] == (7, 6)
    assert s.fallback_ms == pytest.approx({"uresnet.train.optim": 0.005})
    assert s.device_ms["uresnet.train.optim"] == pytest.approx(0.045)


def test_a_side_stream_copy_falls_in_the_staging_span():
    """The next batch's copy overlaps the forward's conv: it is the
    staging span's, and no phase reader counts it."""
    t = _train_trace(copy=(150, 160))
    s = spans.split(t, 1)
    assert s.device_ms["uresnet.stage"] == pytest.approx(0.010)
    assert s.device_ms["uresnet.train.forward"] == pytest.approx(0.060)
    run = _run("train", t)
    read = {name: spec.metric_reader(name)(run) for name in TRAIN_READERS}
    assert read == pytest.approx({
        "densify_ms.train": 0.020, "forward_ms.train": 0.060,
        "loss_ms.train": 0.010, "backward_ms.train": 0.175,
        "optim_ms.train": 0.040})
    # overlapping spans add up to more than the busy time
    assert s.total_ms - s.busy_ms == pytest.approx(0.010)


def test_spans_and_the_unheld_time_add_up_to_busy():
    t = _train_trace()
    s = spans.split(t, 1)
    assert s.total_ms == pytest.approx(t.busy_s * 1e3)
    assert s.busy_ms == pytest.approx(0.325)
    assert spans.split(t, 2).total_ms == pytest.approx(0.1625)  # a step's


def test_readers_read_their_own_loop_only():
    t = _train_trace()
    for name, span in TRAIN_READERS.items():
        read = spec.metric_reader(name)
        assert read(_run("ana", t)) is None
        assert read(_run("train", t)) == pytest.approx(
            spans.split(t, 1).device_ms[span])
        # a window whose phase spans did not occur once a step
        assert read(_run("train", t, steps=2)) is None
    host = [_op(trace.WINDOW, 1, 0, 100),
            _op("uresnet.ana.densify", 2, 0, 10),
            _op("cudaLaunchKernel", 3, 1, 2),
            _op("uresnet.ana.forward", 4, 10, 50),
            _op("cudaLaunchKernel", 5, 11, 12),
            _op("cudaLaunchKernel", 6, 13, 14),
            _op("uresnet.ana.scores", 7, 50, 60),
            _op("cudaLaunchKernel", 8, 51, 52)]
    a = trace.Trace(device=[("index", 3, 8, 0), ("cudnn_fprop", 12, 40, 0),
                            ("conv3x3_tc_kernel", 41, 45, 0),
                            ("softmax", 52, 58, 0)],
                    host=host, window=(0, 100))
    got = {name: spec.metric_reader(name)(_run("ana", a))
           for name in ANA_READERS}
    assert got == pytest.approx({"densify_ms.serve": 0.005,
                                 "forward_ms.serve": 0.032,
                                 "scores_ms.serve": 0.006})
    for name in ANA_READERS:
        assert spec.metric_reader(name)(_run("train", a)) is None


@pytest.mark.parametrize("name", ["train_2d_512", "serve_2d_512"])
def test_program_spans_stay_off_the_device_timeline(name):
    """A small window traced on the CPU: the program's spans are host
    events, once a step, and none is read as a device event or among the
    breakdown's device operations."""
    cell = small.cell(name, compute_dtype="float32")
    res = loops.run(cell, 2 ** 31 + 7, 0.2, True, "cpu", time.perf_counter())
    run = res["traced"]
    kind = cell.mix["loop"]
    assert not [d for d in run.trace.device if d[0].startswith("uresnet.")]
    assert not [op for op, _ in run.trace.breakdown()["device_ops"]
                if op.startswith("uresnet.")]
    s = spans.split(run.trace, run.steps)
    assert all(s.count[p] == run.steps for p in spans.PHASES[kind])
    assert s.count["uresnet.stage"] == run.steps
