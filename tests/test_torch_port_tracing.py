"""The port's spans and counters (``torch_nerf_tpu_torch.tracing``) on the
CPU: off without a profiler, stored with their parents and units under
one, in the profiler's Chrome trace on its clock, a unit's counters, the
store written out, and idle gaps named by the deepest span open."""

import json
import threading

import pytest
import torch

from torch_nerf_tpu_torch import cameras, renderer, tracing, train
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.fields_ngp import make_instant_ngp_field
from torch_nerf_tpu_torch.ops import fused_nerf, fused_train, launch_count

CAM = cameras.CameraParams(focal_x=20.0, focal_y=20.0, img_width=8, img_height=8)
CLASSIC = renderer.RenderSettings(num_samples_coarse=4, num_samples_fine=4)
SINGLE = renderer.RenderSettings(num_samples_coarse=4, num_samples_fine=0)


@pytest.fixture(autouse=True)
def fresh_store():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def scene():
    gen = torch.Generator().manual_seed(3)
    poses = torch.eye(4).repeat(2, 1, 1)
    poses[:, 2, 3] = 4.0
    return torch.rand((2, 64, 3), generator=gen), poses


def classic():
    return make_nerf_field(coord_encode_level=3, dir_encode_level=2, feat_dim=64), CLASSIC


def ngp():
    return make_instant_ngp_field(num_level=2, log_max_entry_per_level=6, max_res=32, density_feat_dim=16,
                                  color_feat_dim=16), SINGLE


def step_and_frame(field, settings):
    """One train step, then one 8x8 frame in two chunks."""
    images, poses = scene()
    gen = torch.Generator().manual_seed(0)
    state = train.create_train_state(gen, field, settings, train.OptimConfig())
    step = train.make_image_train_step(field, settings, train.OptimConfig(), CAM, num_pixels=16)
    state, _ = step(state, images, poses, gen)
    renderer.render_image(field, state.params["coarse"], state.params.get("fine"), CAM, poses[0], 5, settings,
                          chunk_size=32)


def profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def tree(records):
    """``{id: record}`` and each record's parent's name."""
    by_id = {r.id: r for r in records}
    return by_id, {r.id: (by_id[r.parent].name if r.parent in by_id else None) for r in records}


def test_off_without_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(tracing, "_mirror", lambda name: calls.append(name))
    step_and_frame(*classic())
    step_and_frame(*ngp())
    assert tracing.records() == [] and calls == []
    assert tracing.span("train.step") is tracing.span("render.frame")


def check_unit_ids(records, unit_kinds):
    by_id, _ = tree(records)
    for r in records:
        owner = by_id[r.unit]
        assert owner.name in unit_kinds
        if r.name not in unit_kinds:
            # the innermost unit among its ancestors
            up = by_id[r.parent]
            while up.name not in unit_kinds:
                up = by_id[up.parent]
            assert up.id == r.unit


@pytest.mark.parametrize("kind", ["classic", "ngp"])
def test_spans_of_a_step_and_a_frame(kind):
    field, settings = classic() if kind == "classic" else ngp()
    profiled(lambda: step_and_frame(field, settings))
    records = tracing.records()
    by_id, parent = tree(records)
    steps = [r for r in records if r.name == "train.step"]
    frames = [r for r in records if r.name == "render.frame"]
    chunks = [r for r in records if r.name == "render.chunk"]
    assert len(steps) == 1 and len(frames) == 1 and len(chunks) == 2
    assert steps[0].attrs["step"] == 0 and frames[0].attrs["seed"] == 5
    assert [c.attrs["first"] for c in chunks] == [0, 32] and {c.attrs["frame"] for c in chunks} == {frames[0].id}
    check_unit_ids(records, {"train.step", "render.frame", "render.chunk"})
    in_step = {(r.name, parent[r.id]) for r in records if r.unit == steps[0].id}
    in_chunk = {(r.name, parent[r.id]) for r in records if r.unit == chunks[0].id}
    in_frame = {(r.name, parent[r.id]) for r in records if r.unit == frames[0].id}
    assert {("train.ray_batch", "train.step"), ("train.adam", "train.step")} <= in_step
    assert {("render.rays", "render.frame"), ("field.prepare", "render.frame"),
            ("render.gather", "render.frame")} <= in_frame
    assert [parent[c.id] for c in chunks] == ["render.frame"] * 2
    assert {("render.uniforms", "render.chunk"), ("sample.coarse", "render.chunk"),
            ("render.composite", "render.chunk")} <= in_chunk
    if kind == "classic":
        assert {("sample.coarse", "train.step"), ("sample.fine", "train.step"),
                ("field.train_pass", "train.step")} <= in_step
        assert {("sample.fine", "render.chunk"), ("field.forward", "render.chunk")} <= in_chunk
    else:
        forward = {("field.sh", "train.render"), ("field.encode", "train.render"),
                   ("field.density_mlp", "train.render"), ("field.color_in", "train.render"),
                   ("field.color_mlp", "train.render"), ("render.composite", "train.render"),
                   ("sample.coarse", "train.render")}
        backward = {("field.color_mlp.bwd", "train.backward"), ("field.color_in.bwd", "train.backward"),
                    ("field.density_mlp.bwd", "train.backward"), ("field.encode_bwd", "train.backward")}
        assert forward | backward | {("train.render", "train.step"), ("train.loss", "train.step"),
                                     ("train.backward", "train.step")} <= in_step
        # the backward's spans follow each other in the order the gradients arrive
        bwd = sorted((r for r in records if parent[r.id] == "train.backward"), key=lambda r: r.start)
        assert [r.name for r in bwd] == ["field.color_mlp.bwd", "field.color_in.bwd", "field.density_mlp.bwd",
                                         "field.encode_bwd"]
        assert all(a.end <= b.start for a, b in zip(bwd, bwd[1:]))
        assert {("field.encode", "render.chunk"), ("field.color_mlp", "render.chunk")} <= in_chunk
        assert not any(r.name.endswith(".bwd") for r in records if r.unit != steps[0].id)


def test_mirrored_into_the_chrome_trace_on_its_clock(tmp_path):
    field, settings = ngp()
    prof = profiled(lambda: step_and_frame(field, settings))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    chrome = json.loads(path.read_text())
    base = chrome["baseTimeNanoseconds"]
    events = {}
    for ev in chrome["traceEvents"]:
        if ev.get("ph") == "X":
            events.setdefault(ev["name"], []).append(ev)
    records = tracing.records()
    by_name = {}
    for r in records:
        by_name.setdefault(r.name, []).append(r)
    for name, spans in by_name.items():
        evs = sorted(events.get(name, []), key=lambda ev: ev["ts"])
        assert len(evs) == len(spans), name
        for r, ev in zip(sorted(spans, key=lambda r: r.start), evs):
            assert abs(base + ev["ts"] * 1000 - r.start) < 1e6, name


def test_unit_counters_hold_the_steps_launches_and_images(monkeypatch):
    """A classic step whose train pass builds its weight images and counts
    its launch as the card's does (the plain pass computes it here)."""
    field, settings = classic()
    real = fused_train.fused_train_pass_reference

    def pass_on_card(params, ray_o, ray_d, t, delta, rgb_gt, cfg, num_real_rays):
        tracing.add("points", t.numel())
        fused_train.weight_images(params, cfg, "wgmma")
        launch_count.count(fused_train.fused_train_pass, tuple(t.shape))
        fused_train.fused_train_pass.route_launches["wgmma"] += 1
        return real(params, ray_o, ray_d, t, delta, rgb_gt, cfg, num_real_rays)

    monkeypatch.setattr(train, "fused_train_pass", pass_on_card)
    profiled(lambda: step_and_frame(field, settings))
    records = tracing.records()
    step = [r for r in records if r.name == "train.step"][0]
    cfg = field.fused_cfg
    params = field.init(torch.Generator().manual_seed(0))
    images = fused_train.weight_images(params, cfg, "wgmma")
    nbytes = sum(x.nbytes for group in images for x in group)
    assert step.attrs["counters"] == {"fused_train_pass": 2, "fused_train_pass/wgmma": 2, "layout_builds": 2,
                                      "layout_bytes": 2 * nbytes, "points": 16 * 4 + 16 * 8}
    assert len([r for r in records if r.name == "field.layout" and r.unit == step.id]) == 2
    chunks = [r for r in records if r.name == "render.chunk"]
    assert [c.attrs["counters"] for c in chunks] == [{"points": 32 * 4 + 32 * 8}] * 2
    # the forward's images of a frame on the card, counted where they are built
    tracing.enable()
    with tracing.unit("render.frame"):
        fused_nerf.kernel_weights(params, cfg, "wgmma")
    counted = tracing.records()[-1].attrs["counters"]
    assert counted["layout_builds"] == 1 and counted["layout_bytes"] > 0


def test_dump_writes_the_store(tmp_path):
    tracing.enable()
    with tracing.unit("train.step", step=7):
        with tracing.span("train.adam"):
            pass
    path = tmp_path / "spans.jsonl"
    tracing.dump(path)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines == [r.as_dict() for r in tracing.records()]
    assert [d["name"] for d in lines] == ["train.adam", "train.step"] and lines[1]["step"] == 7


def test_other_threads_take_the_handed_span_as_parent():
    tracing.enable()
    seen = []

    def worker():
        with tracing.span("field.encode_bwd") as s:
            seen.append(s)

    with tracing.unit("train.step") as step:
        with tracing.span("train.backward", handoff=True) as bwd:
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
        assert not t.is_alive()
        t2 = threading.Thread(target=worker)
        t2.start()
        t2.join(timeout=10)
    by_id = {r.id: r for r in tracing.records()}
    first, second = by_id[seen[0].id], by_id[seen[1].id]
    assert first.parent == bwd.id and first.unit == step.id and first.tid != by_id[bwd.id].tid
    assert second.parent is None and second.unit is None


def test_idle_gaps_go_to_the_deepest_open_span():
    spans = [dict(id=1, parent=None, name="train.step", start=0, end=100),
             dict(id=2, parent=1, name="train.backward", start=10, end=80),
             dict(id=3, parent=2, name="field.encode_bwd", start=30, end=40),  # another thread
             dict(id=4, parent=1, name="train.adam", start=80, end=95)]
    # two streams overlap in 20-35; the gaps begin at 5, 35, 39, 85 and 100
    intervals = [(0, 5), (20, 30), (25, 35), (37, 39), (45, 85), (90, 100), (104, 110)]
    busy, idle = tracing.idle_by_span(intervals, spans)
    assert busy == 5 + 15 + 2 + 40 + 10 + 6
    assert idle == {"train.step": 15, "field.encode_bwd": 2 + 6, "train.adam": 5, "-": 4}
    # within a window, the gap before the first interval counts too
    busy, idle = tracing.idle_by_span(intervals[1:], spans, window=(2, 50))
    assert busy == 15 + 2 + 5 and idle == {"train.step": 18, "field.encode_bwd": 2 + 6}


def test_the_store_keeps_the_last_spans(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 4)
    monkeypatch.setattr(tracing, "_TRIM", 8 * tracing._PACK.size)
    tracing.enable()
    ids = []
    for step in range(11):
        with tracing.unit("train.step", step=step) as s:
            ids.append(s.id)
    kept = tracing.records()
    assert [r.id for r in kept] == ids[-4:] and [r.attrs["step"] for r in kept] == [7, 8, 9, 10]
    # a unit whose children the trim cuts keeps its ids: records are stored
    # as spans end, so the children come first
    tracing.clear()
    with tracing.unit("render.frame", seed=3):
        for first in range(11):
            with tracing.span("render.rays"):
                pass
    kept = tracing.records()
    assert [r.name for r in kept] == ["render.rays"] * 3 + ["render.frame"] and kept[-1].attrs["seed"] == 3
