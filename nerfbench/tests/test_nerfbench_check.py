"""The check that decides ``correct`` fails where it must: the control (the
reference with fp8 operands in the program's place) and every planted
fault under the timed path come out not correct, at a size the CPU runs.
The harness's look for a card is skipped; the rest of a run is driven as
on the card, the port taking its plain versions on CPU tensors."""

import json
import time

import pytest
import torch
from small import small_cell

from nerfbench import check, faults, inputs, jobs, spec
from nerfbench import run as nbrun
from nerfbench.reference import lowp

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
CPU = torch.device("cpu")


def one_run(cell, seed=20240611):
    return jobs.run(cell, seed, 0.0, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small_cell(name)
    ok, table = check.verdict(check.readings(one_run(cell), lowp.fp8, as_program=False), cell.limits)
    assert not ok, table


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    cell = small_cell(name)
    with faults.planted(cell.job, fault):
        run = one_run(cell)
    ok, table = check.verdict(check.readings(run), cell.limits)
    assert not ok, table


@pytest.mark.parametrize("name", CELLS)
def test_result_line(name):
    cell = small_cell(name)
    result = nbrun.measure(cell, 2**31 + 17, 0.2, False, CPU, time.perf_counter())
    assert list(result)[-1] == "check" and list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert {m["name"] for m in cell.end_to_end} == set(result["metrics"])
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["check"]) == set(cell.limits)
    json.dumps(result)


def test_same_seed_same_inputs():
    cell = small_cell("instant_ngp.train")
    a, b = jobs.train_inputs(cell, 5, CPU), jobs.train_inputs(cell, 5, CPU)
    assert torch.equal(a["images"], b["images"])
    assert torch.equal(a["checked"][2].rays.u, b["checked"][2].rays.u)
    c = jobs.train_inputs(cell, 6, CPU)
    assert not torch.equal(a["images"], c["images"])


def test_batch_order_splits_by_brightness():
    cell = small_cell("nerf_blender.train")
    data = jobs.train_inputs(cell, 5, CPU)
    draws = data["checked"][0]
    n = cell.config["renderer.num_pixels"]
    pixels = torch.topk(draws.pixel_u, n).indices
    assert len(set(pixels.tolist())) == n
    luma = data["images"][int(draws.image_index)].mean(-1)[pixels]
    ranks = torch.argsort(torch.argsort(luma, descending=True, stable=True))
    assert torch.equal(ranks, inputs.brightness_ranks(n))
    assert luma[: n // 2].min() >= luma[n // 2:].max()
    assert luma[0::2].mean() > luma[1::2].mean()


@pytest.mark.card
def test_cell_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    for name in CELLS:
        cell = spec.find(name)
        result = nbrun.measure(cell, 2**31 + 99, 2.0, False, torch.device("cuda", 0), time.perf_counter())
        assert result["correct"], (name, result["check"])
