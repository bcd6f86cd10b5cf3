"""``runners/train_profile.split`` on a synthetic device-only Chrome
trace: the dW GEMM's two streams count once in the busy time, the window
is the markers' on the device's clock, and each idle gap goes to the port
span that was the deepest open when it began."""

import pytest

from torch_nerf_tpu_torch.runners import train_profile

BASE = 1_790_000_000_000_000_000


def kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def span(i, name, parent, start_us, end_us):
    return {"name": name, "id": i, "parent": parent, "unit": 1, "tid": 7,
            "start": BASE + round(start_us * 1000), "end": BASE + round(end_us * 1000)}


def chrome():
    events = [
        kernel("void at::native::fill_kernel<float>(float*)", 0, 1, "gpu_memset"),  # the markers
        kernel("void (anonymous namespace)::mlp_forward_stash<256>(int)", 10, 20),
        # the dW GEMM on two streams at once
        kernel("void (anonymous namespace)::dw_tc_kernel<__nv_bfloat16>(int)", 30, 30),
        kernel("void (anonymous namespace)::dw_tc_kernel<__nv_bfloat16>(int)", 40, 30),
        kernel("void at::native::adam(float*)", 90, 5),
        kernel("void at::native::fill_kernel<float>(float*)", 99, 1, "gpu_memset"),
    ]
    return {"baseTimeNanoseconds": BASE, "traceEvents": events}


def spans():
    return [span(1, "train.step", None, 0.2, 98), span(2, "field.layout", 1, 0.5, 9),
            span(3, "field.train_pass", 1, 9, 12), span(4, "train.adam", 1, 75, 96)]


def test_two_streams_count_once_and_gaps_go_to_their_phase():
    out = train_profile.split(chrome(), spans(), steps=2, host_s=300e-6)
    # busy: [0, 1] + [10, 70] + [90, 95] + [99, 100] = 67 us of a 100 us window
    assert out["window_ms"] == pytest.approx(100e-3 / 2)
    assert out["device_busy_ms"] == pytest.approx(67e-3 / 2)
    assert out["idle_share"] == pytest.approx(0.33)
    assert out["step_ms"] == pytest.approx(0.15)
    # each launch's own time, the two dW launches summed
    assert out["kernels_ms_per_step"]["dw_tc_kernel"] == pytest.approx(60e-3 / 2)
    assert out["kernels_ms_per_step"]["mlp_forward_stash"] == pytest.approx(20e-3 / 2)
    # gaps: [1, 10) begins in field.layout; [70, 90) in train.step (adam opens
    # at 75); [95, 99) in train.adam
    idle = {name: p["idle_ms"] for name, p in out["phases"].items() if p["idle_ms"]}
    assert idle == pytest.approx({"field.layout": 9e-3 / 2, "train.step": 20e-3 / 2, "train.adam": 4e-3 / 2})
    assert sum(idle.values()) == pytest.approx(out["window_ms"] - out["device_busy_ms"])
    assert out["phases"]["train.adam"]["host_ms"] == pytest.approx(21e-3 / 2)


def test_a_gap_before_any_span_is_named_dash():
    out = train_profile.split(chrome(), spans()[1:], steps=1, host_s=1e-3)
    assert out["phases"]["-"]["idle_ms"] == pytest.approx(20e-3)
