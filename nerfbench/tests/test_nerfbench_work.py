"""The FLOP and byte counts against hand counts."""

import pytest

from nerfbench import reference, spec, work

PEAKS = {"flops": 989e12, "bytes_per_s": 3.35e12}


def cfg(name):
    return spec.find(name).config


def test_classic_macs_per_point():
    # 63x256 + 4 x 256x256 + 319x256 + 2 x 256x256 + 256x257 + 283x128 + 128x3
    hand = 63 * 256 + 4 * 65536 + 319 * 256 + 2 * 65536 + 256 * 257 + 283 * 128 + 128 * 3
    assert hand == 593_408
    assert reference.model("nerf").macs_per_point(cfg("nerf_blender.train")) == hand


def test_ngp_macs_per_point():
    # density: fc_in 32x64, fc_hidden_0 64x64, fc_out 64x16; colour: fc_in
    # (16 + 16)x64, fc_hidden_0 and fc_hidden_1 64x64, fc_out 64x3. The
    # port's session.estimate_flops_per_step counts one colour hidden layer
    # (13,504): the model it runs has two.
    hand = 32 * 64 + 64 * 64 + 64 * 16 + 32 * 64 + 64 * 64 + 64 * 64 + 64 * 3
    assert hand == 17_600 == 13_504 + 64 * 64
    assert reference.model("ngp").macs_per_point(cfg("instant_ngp.train")) == hand


def test_step_flops():
    c = cfg("nerf_blender.train")
    assert work.points_per_step(c) == 4096 * (64 + 192) == 1_048_576
    assert work.train_flops_per_step(c, reference.model("nerf")) == 6 * 593_408 * 1_048_576
    n = cfg("instant_ngp.train")
    assert work.train_flops_per_step(n, reference.model("ngp")) == 6 * 17_600 * 4096 * 256


def test_frame_flops():
    c = cfg("nerf_blender.render")
    assert work.frame_flops(c, reference.model("nerf"), 640_000) == 2 * 593_408 * 640_000 * 256


def test_mlp_least_time_is_bound_by_operations():
    c = cfg("nerf_blender.train")
    least = work.mlp_train_least_s(c, reference.model("nerf"), PEAKS)
    assert least == pytest.approx(6 * 593_408 * 1_048_576 / 989e12)
    assert least == pytest.approx(3.775e-3, rel=1e-3)


def test_hash_bytes():
    n = cfg("instant_ngp.train")
    points = 4096 * 256
    table = 16 * 2**19 * 2 * 4
    fwd = points * 12 + table + points * 32 * 4
    bwd = points * 32 * 4 + points * 12 + table
    ngp = reference.model("ngp")
    assert ngp.encode_bytes(n, points, False) == fwd
    assert ngp.encode_bytes(n, points, True) == fwd + bwd
    assert work.encode_least_s(n, ngp, points, True, PEAKS) == pytest.approx((fwd + bwd) / 3.35e12)


def test_peaks_by_card_name():
    assert work.peaks("NVIDIA H100 80GB HBM3")["flops"] == 989e12
    assert work.peaks("some other card") is None
