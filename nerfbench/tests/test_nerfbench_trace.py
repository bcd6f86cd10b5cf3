"""The trace reader on a synthetic Chrome trace: the idle share is a union
of overlapping device intervals, device time is tied to the spans open at
launch, and idle gaps are named by the span open when they began."""

import pytest

from nerfbench import trace as tracing


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def synthetic():
    events = [
        x("user_annotation", "nb:window", 0, 100),
        x("user_annotation", "nb:step", 0, 60),
        x("user_annotation", "nb:field_pass", 5, 10),
        x("user_annotation", "nb:adam", 40, 10),
        x("user_annotation", "nb:encode_bwd", 20, 5, tid=2),
        x("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 8, 1, correlation=2),
        x("cuda_runtime", "cudaLaunchKernel", 21, 1, tid=2, correlation=3),
        x("cuda_runtime", "cudaLaunchKernel", 41, 1, correlation=4),
        # two streams: 10-30 and 20-35 overlap
        x("kernel", "fwd", 10, 20, correlation=1),
        x("kernel", "dw", 20, 15, correlation=2),
        x("kernel", "bwd", 36, 4, correlation=3),
        x("gpu_memset", "Memset", 60, 10, correlation=4),
        x("kernel", "orphan", 80, 5, correlation=99),
        x("kernel", "fill", 0, 0.5, correlation=98),  # the markers
        x("kernel", "fill", 99.5, 0.5, correlation=97),
    ]
    return {"traceEvents": events}


def test_union_not_sum():
    tr = tracing.summarize(synthetic())
    assert tr.window_s == pytest.approx(100e-6)
    # busy: [10, 35] + [36, 40] + [60, 70] + [80, 85] = 25 + 4 + 10 + 5, and
    # the markers' 0.5 each
    assert tr.busy_s() == pytest.approx(45e-6)
    assert sum(op.end - op.start for op in tr.ops) == pytest.approx(55e-6)


def test_device_time_by_span_at_launch():
    tr = tracing.summarize(synthetic())
    assert tr.device_time(["field_pass"]) == pytest.approx(35e-6)
    assert tr.device_time(["encode_bwd"]) == pytest.approx(4e-6)
    assert tr.device_time(["adam"]) == pytest.approx(10e-6)
    assert tr.device_time(["nothing"]) is None
    assert tr.unlaunched == 3
    assert len(tr.kernels()) == 4


def test_idle_gaps_named_by_open_span():
    tr = tracing.summarize(synthetic())
    idle = tr.idle_by_span()
    # gaps: [0.5, 10) and [35, 36) begin inside "step"; [40, 60) begins as
    # "adam" opens; [70, 80) and [85, 99.5) after every span closed
    assert idle["step"] == pytest.approx(10.5e-6)
    assert idle["adam"] == pytest.approx(20e-6)
    assert idle["window"] == pytest.approx(24.5e-6)
    assert sum(idle.values()) == pytest.approx(tr.window_s - tr.busy_s())
    bd = tracing.breakdown(tr, tr)
    assert bd["device_ops"][0][0] == "fwd" and len(bd["idle_gaps"]) == 3
