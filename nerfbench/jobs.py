"""The general generator: one run of a cell, a train job or a render job as
its traffic file says, through the port's public entries.

A train job builds the port's step (``make_image_train_step``) and its
state once, drives it through the checked steps on the seed's draws (the
warm-up, compared with the reference after the window), then steps back
to back for the window with one synchronize at each end. A render job
warms up on a whole frame, then renders 800x800 frames back to back with
``render_image``, the test poses in turn, each chunk's draws from the seed
through ``uniforms_for_chunk``, and keeps the frames for the check. With
``traced`` the run then records a stretch of the same work under the
profiler twice: with device activity alone, then with CPU activity and the
benchmark's spans installed.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional

import torch

from nerfbench import inputs, reference, spans
from nerfbench import trace as tracing
from nerfbench.spec import Cell
from torch_nerf_tpu_torch import config as port_config
from torch_nerf_tpu_torch import renderer as port_renderer
from torch_nerf_tpu_torch import session
from torch_nerf_tpu_torch import train as port_train

ADAM_BETA1 = 0.9


@dataclasses.dataclass
class Run:
    """What a run measured and kept, for the metrics and the check."""

    cell: Cell
    seed: int
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0  # steps or frames in the window
    rays_per_unit: int = 0
    memory_peak_bytes: int = 0
    trace: Optional[tracing.Trace] = None  # the device-only pass
    span_trace: Optional[tracing.Trace] = None  # the pass with the spans
    traced_units: int = 0
    traced_s: float = 0.0  # host seconds of the device-only pass
    chunks_per_frame: int = 0
    setup_phases: Dict[str, float] = dataclasses.field(default_factory=dict)  # seconds since the start
    kept: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def cfg(self) -> Dict:
        return self.cell.config

    @property
    def ref(self):
        return reference.model(self.cell.config["reference"])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def port_parts(cell: Cell):
    """``(field, render settings, optimizer config)`` of the cell's
    configuration, through the port's session layer."""
    pcfg = port_config.resolve(cell.config["preset"], cell.port_overrides())
    return session.build_field(pcfg), session.build_render_settings(pcfg), session.build_optim_config(pcfg)


def make_weights(cell: Cell, seed: int, device: torch.device) -> Dict:
    """The seed's weights, drawn as the configuration's ``init`` says (for
    the cell's job where it has one entry a job), then shaped by the
    reference's ``prepare`` where it has one."""
    cfg = cell.config
    ref, init = reference.model(cfg["reference"]), cfg["init"]
    init = init.get(cell.job, init)
    weights = inputs.weights(ref.layout(cfg), seed, device, init["mlp_gain"], init.get("table_bound", 0.0))
    if hasattr(ref, "prepare"):
        ref.prepare(weights, cfg)
    return weights


def train_inputs(cell: Cell, seed: int, device: torch.device) -> Dict[str, Any]:
    """The seed's weights, images, poses, camera and the checked steps'
    draws."""
    cfg, tr = cell.config, cell.traffic
    images, poses, cam = inputs.train_scene(cfg["scene"], seed, device)
    weights = make_weights(cell, seed, device)
    gen = inputs.generator(seed, "draws", device)
    rays = cfg["renderer.num_pixels"]
    shape = (images.shape[0], images.shape[1], rays, cfg["renderer.num_samples_coarse"],
             cfg["renderer.num_samples_fine"])
    luma = images.mean(-1)
    checked = [inputs.by_brightness(inputs.image_draws(gen, *shape), luma, rays) for _ in range(tr["checked_steps"])]
    return {"images": images, "poses": poses, "camera": cam, "weights": weights, "gen": gen, "draw_shape": shape,
            "checked": checked}


def render_inputs(cell: Cell, seed: int, device: torch.device) -> Dict[str, Any]:
    """The seed's weights, test poses and camera."""
    scene = cell.config["scene"]
    weights = make_weights(cell, seed, device)
    poses = inputs.poses(seed, "test", scene["test_views"], scene["radius"], device)
    return {"weights": weights, "poses": poses, "camera": inputs.camera(scene["test_size"], scene["camera_angle_x"])}


def trace_both(run: Run, stretch, units: int) -> None:
    """The stretch twice under the profiler: device activity alone, then
    with CPU activity and the benchmark's spans installed."""
    chrome, run.traced_s = tracing.record(stretch, with_spans=False)
    run.trace = tracing.summarize(chrome)
    with spans.installed():
        run.span_trace = tracing.summarize(tracing.record(stretch, with_spans=True)[0])
    run.traced_units = units


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device, t_start: float) -> Run:
    job = {"train": train_job, "render": render_job}[cell.job]
    return job(Run(cell, seed, device), seconds, traced, t_start)


def train_job(run: Run, seconds: float, traced: bool, t_start: float) -> Run:
    cell, device, cfg = run.cell, run.device, run.cell.config
    run.setup_phases["imports"] = time.perf_counter() - t_start
    field, settings, optim = port_parts(cell)
    data = train_inputs(cell, run.seed, device)
    sync(device)
    run.setup_phases["inputs"] = time.perf_counter() - t_start
    images, poses = data["images"], data["poses"]
    params = inputs.clone(data["weights"])
    leaves = port_train.parameter_list(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    opt = port_train.make_optimizer(params, optim)
    state = port_train.TrainState(0, params, opt, port_train.lr_schedule(opt, optim))
    step = port_train.make_image_train_step(field, settings, optim, data["camera"],
                                            num_pixels=cfg["renderer.num_pixels"])

    def draw():
        return inputs.image_draws(data["gen"], *data["draw_shape"])

    losses, first = [], None
    for i, draws in enumerate(data["checked"]):
        state, metrics = step(state, images, poses, draws=draws)
        losses.append((metrics["loss"].detach().clone(), metrics["coarse_loss"].detach().clone()))
        if i == 0:  # the gradient as Adam got it: its first moment after one step
            first = [opt.state[p]["exp_avg"].detach().clone() / (1.0 - ADAM_BETA1) if "exp_avg" in opt.state[p]
                     else torch.zeros_like(p) for p in leaves]
            sync(device)
            run.setup_phases["first_step"] = time.perf_counter() - t_start
    after = [p.detach().clone() for p in leaves]
    sync(device)
    run.setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    n = 0
    while True:
        state, _ = step(state, images, poses, draws=draw())
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    run.window_s, run.units, run.rays_per_unit = time.perf_counter() - t0, n, cfg["renderer.num_pixels"]
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)

    if traced:
        k = max(5, math.ceil(cell.traffic["trace_seconds"] * n / run.window_s))

        def stretch():
            nonlocal state
            for _ in range(k):
                with spans.span("draw"):
                    draws = draw()
                with spans.span("step"):
                    state, _ = step(state, images, poses, draws=draws)

        trace_both(run, stretch, k)

    program = {"losses": [float(a) for a, _ in losses], "coarse_losses": [float(c) for _, c in losses],
               "first": first, "after": after}
    run.kept = {"data": data, "program": program}
    return run


def render_job(run: Run, seconds: float, traced: bool, t_start: float) -> Run:
    cell, device, cfg, tr = run.cell, run.device, run.cell.config, run.cell.traffic
    run.setup_phases["imports"] = time.perf_counter() - t_start
    field, settings, _ = port_parts(cell)
    data = render_inputs(cell, run.seed, device)
    sync(device)
    run.setup_phases["inputs"] = time.perf_counter() - t_start
    weights = inputs.clone(data["weights"])
    pc, pf = weights["coarse"], weights.get("fine")
    cam, poses, size = data["camera"], data["poses"], tr["chunk_size"]
    sc, sf = cfg["renderer.num_samples_coarse"], cfg["renderer.num_samples_fine"]

    def frame(index: int) -> torch.Tensor:
        def uniforms_for_chunk(first: int, chunk: int):
            with spans.span("uniforms"):
                return inputs.chunk_uniforms(run.seed, index, first, chunk, sc, sf, device)

        with spans.span("frame"):
            return port_renderer.render_image(field, pc, pf, cam, poses[index % poses.shape[0]], run.seed, settings,
                                              chunk_size=size, uniforms_for_chunk=uniforms_for_chunk)

    for i in range(tr["warmup_frames"]):
        frame(-1 - i)
    sync(device)
    run.setup_s = time.perf_counter() - t_start

    frames: List[torch.Tensor] = []
    t0 = time.perf_counter()
    while True:
        frames.append(frame(len(frames)))
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    run.window_s, run.units = time.perf_counter() - t0, len(frames)
    run.rays_per_unit = cam.img_height * cam.img_width
    run.chunks_per_frame = -(-run.rays_per_unit // size)
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)

    if traced:
        k = max(1, round(tr["trace_seconds"] * len(frames) / run.window_s))

        def stretch():
            for i in range(k):
                frame(10**6 + i)

        trace_both(run, stretch, k)

    run.kept = {"data": data, "frames": frames}
    return run
