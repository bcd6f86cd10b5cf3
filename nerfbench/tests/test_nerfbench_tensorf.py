"""The TensoRF cell's counts against hand counts, its reference's layout
against the port's tree, and its roofline reader on traces with and
without the VM kernels."""

import importlib.util
import types

import pytest
import torch

from nerfbench import reference, spec, work
from nerfbench.reference import optim
from nerfbench.trace import DeviceOp

PEAKS = {"flops": 989e12, "bytes_per_s": 3.35e12}


def cfg():
    return spec.find("tensorf_vm.train").config


def test_macs_and_step_flops():
    # basis_mat 144x27, render MLP 150x128, 128x128, 128x3, and the VM
    # products 3 x (16 + 48) counted as multiply-adds
    hand = 144 * 27 + 150 * 128 + 128 * 128 + 128 * 3 + 3 * (16 + 48)
    assert hand == 40_048
    c, ref = cfg(), reference.model("tensorf")
    assert ref.macs_per_point(c) == hand
    assert work.points_per_step(c) == 4096 * 800 == 3_276_800
    assert work.train_flops_per_step(c, ref) == 6 * hand * 3_276_800


def test_encode_bytes():
    c, ref = cfg(), reference.model("tensorf")
    points = 3_276_800
    factors = 3 * (16 + 48) * (300 * 300 + 300) * 4
    assert factors == 69_350_400 == c["widths"]["factor_bytes"]
    per_point = 12 + 4 + 144 * 2  # bf16 products
    assert ref.encode_bytes(c, points, False) == points * per_point + factors
    assert ref.encode_bytes(c, points, True) == 2 * points * per_point + 3 * factors
    least = work.encode_least_s(c, ref, points, True, PEAKS)
    assert least == pytest.approx(0.657e-3, rel=1e-2)


def test_layout_is_the_port_tree():
    from torch_nerf_tpu_torch import config, session

    c = dict(cfg(), **{"network.vm_grid_res": 8, "network.vm_density_components": 2,
                       "network.vm_app_components": 5})
    overrides = [f"{k}={v}" for k, v in c.items() if k.startswith("network.")]
    params = session.build_field(config.resolve("tensorf", overrides)).init(torch.Generator().manual_seed(0),
                                                                           torch.device("cpu"))
    tree = {("coarse",) + path: tuple(t.shape) for path, t in optim.leaves(params)}
    assert tree == {path: shape for path, shape, _, _ in reference.model("tensorf").layout(c)}


def _reader():
    path = spec.HERE / "metrics" / "vm_roofline.train.py"
    loader = importlib.util.spec_from_file_location("vm_roofline_train", path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module.read


def _run(ops):
    trace = types.SimpleNamespace(ops=ops)
    cell = types.SimpleNamespace(job="train")
    return types.SimpleNamespace(cell=cell, trace=trace, traced_units=2, cfg=cfg(),
                                 ref=reference.model("tensorf"), device=torch.device("cuda"))


def test_roofline_reads_the_vm_kernels_and_nothing_without_them(monkeypatch):
    from nerfbench.metrics import _common

    read = _reader()
    monkeypatch.setattr(_common.torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    ops = [DeviceOp("void (anonymous namespace)::vm_encode_fwd_kernel<__nv_bfloat16>(...)", "kernel", 0.0, 1e-3,
                    frozenset()),
           DeviceOp("void (anonymous namespace)::vm_encode_bwd_kernel<__nv_bfloat16>(...)", "kernel", 1e-3, 4e-3,
                    frozenset()),
           DeviceOp("void cutlass::Kernel2<...>", "kernel", 4e-3, 9e-3, frozenset())]
    least = work.encode_least_s(cfg(), reference.model("tensorf"), 3_276_800, True, PEAKS)
    assert read(_run(ops)) == pytest.approx(100.0 * least * 2 / 4e-3)
    assert read(_run(ops[2:])) is None
