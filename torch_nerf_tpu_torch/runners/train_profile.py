"""Where a train step's time goes on the card, by kernel.

Runs train steps at ``bench.py``'s operating point (8 procedural views at
400x400, 4096 rays, seeded random weights) and traces a few steps of each
path with ``torch.profiler``: for the classic NeRF (64 + 128 samples) the
fused train pass and autograd through the field; with ``--model
instant_nerf`` (256 samples, no fine network, Adam 1e-2 at eps 1e-15) the
bricked and the per-corner hash layouts, or the ``--layout`` named: a
packed layout without and with its smoothness loss (weight 1e-3, 1024
probes). ``--occupancy`` adds the occupancy-pruned step of each model at
``bench.py --occupancy``'s point (classic: 32 of 64 coarse and 128 of 192
fine samples kept, through the fused pass; NGP: 128 of 256; the default
grid, whose warmup reads every cell occupied, swept at steps 0, 16, ...).
The steps are traced with device activity alone, between two marker
fills that bound the stretch on the device's clock, while the port's own
spans are stored (``tracing``). Prints one JSON line per path: the
host-clock ms per step, the stretch's ms per step on the device's clock
(``window_ms``), the device's busy ms per step (the union of its kernel,
copy and fill intervals, so the dW GEMM's two streams count once) and its
idle share of the window, the device ms per step of every kernel by name
(each launch's own device time), and the step's split by phase
(``phases``): for each port span, its host ms per step and the device's
idle ms per step whose gap began while it was the deepest span open (the
spans laid on the trace's clock by its ``baseTimeNanoseconds``); for the
fused classic path also each kernel of the train pass (forward, composite,
chain, dW GEMM, reduce) beside its floors by operations (989 TFLOP/s) and
by the bytes the design moves (3.35 TB/s), over the step's coarse and fine
passes (``fused_train.phase_floors``; ``floors``); then the card's
``nvidia-smi`` line.
``--route f32_wgmma`` profiles the classic NeRF in f32 (path A) and
``--route wgmma_general`` at width 512 with a 75-wide encoding in bf16 (path
B), both on the tensor-core general route; ``--route wide`` bf16 at width
1024 on the same route (four column passes), ``--route f32_wide`` f32 at
1024 (streaming its layers through device memory): each its forward,
chain and dW kernels beside their floors by operations at the route's
peak (989 TFLOP/s bf16, 989 / 8 for f32_wgmma's eight bf16 products; the
dW GEMM at 989 or 989 / 8, and by bytes, each stash read once) and the
pass's stash bytes (``fused_train.general_stash_bytes``) at 3.35 TB/s.

    python -m torch_nerf_tpu_torch.runners.train_profile [--model instant_nerf [--layout L]] [--occupancy] [--route R] [--steps 5]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import tempfile
import time

import torch

from torch_nerf_tpu_torch import config, occupancy, renderer, session, tracing, train
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.device import resolve_device
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.fields_ngp import make_instant_ngp_field
from torch_nerf_tpu_torch.ops import fused_nerf, fused_train
from torch_nerf_tpu_torch.runners.timing import nvidia_smi


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*$", "", name)
    name = re.sub(r"<.*>", "", name)
    return re.sub(r"^.*::", "", name.replace("void ", "").strip())


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def split(chrome: dict, spans, steps: int, host_s: float) -> dict:
    """A device-only Chrome trace of ``steps`` steps bounded by marker
    fills, with the port's ``spans`` (``tracing.records()`` as dicts) of the same
    stretch: the step's ms on the host and device clocks, the union of the
    device's busy intervals, its idle share, the kernels by name and the
    split by phase (see the module's doc), all per step."""
    ops = [(ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)))
           for ev in chrome["traceEvents"] if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS]
    lo, hi = min(a for _, a, _ in ops), max(b for _, _, b in ops)
    kernels = collections.defaultdict(float)
    for name, a, b in ops:
        kernels[_short(name)] += (b - a) / 1e3 / steps
    base = chrome["baseTimeNanoseconds"]
    on_trace = [dict(s, start=(s["start"] - base) / 1e3, end=(s["end"] - base) / 1e3) for s in spans]
    busy, idle = tracing.idle_by_span([(a, b) for _, a, b in ops], on_trace)
    phases = collections.defaultdict(lambda: {"host_ms": 0.0, "idle_ms": 0.0})
    for s in on_trace:
        phases[s["name"]]["host_ms"] += (s["end"] - s["start"]) / 1e3 / steps
    for name, length in idle.items():
        phases[name]["idle_ms"] += length / 1e3 / steps
    return dict(step_ms=host_s / steps * 1e3, window_ms=(hi - lo) / 1e3 / steps, device_busy_ms=busy / 1e3 / steps,
                idle_share=1.0 - busy / (hi - lo),
                kernels_ms_per_step=dict(sorted(kernels.items(), key=lambda kv: -kv[1])),
                phases=dict(sorted(phases.items(), key=lambda kv: -kv[1]["idle_ms"])))


def profile_path(step, state, grid, images, poses, gen, steps: int) -> dict:
    """``steps`` traced steps after 3 untraced ones; ``grid`` is the
    occupancy grid the step threads, or None."""
    def one(state, grid):
        if grid is None:
            return step(state, images, poses, gen)[0], None
        state, grid, _ = step(state, grid, images, poses, gen)
        return state, grid

    for _ in range(3):
        state, grid = one(state, grid)
    marker = torch.empty(1, device=images.device)
    torch.cuda.synchronize()
    tracing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        marker.fill_(0.0)
        for _ in range(steps):
            state, grid = one(state, grid)
        marker.fill_(1.0)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            chrome = json.load(f)
    finally:
        os.unlink(path)
    return split(chrome, [s.as_dict() for s in tracing.records()], steps, elapsed)


# H100 SXM data-sheet peaks: dense bf16, HBM3
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# the classic field of each route: the preset (wgmma), path B, path A,
# width 1024 in bf16 (wgmma_general's column passes) and in f32 (f32_wgmma,
# streaming)
ROUTE_FIELDS = {"wgmma": dict(compute_dtype=torch.bfloat16),
                "wgmma_general": dict(compute_dtype=torch.bfloat16, feat_dim=512, coord_encode_level=12),
                "f32_wgmma": dict(compute_dtype=torch.float32),
                "wide": dict(compute_dtype=torch.bfloat16, feat_dim=1024),
                "f32_wide": dict(compute_dtype=torch.float32, feat_dim=1024)}
ROUTE_PEAKS = {"f32_wgmma": PEAK_FLOPS / 8}


def kernel_floors(kernels_ms: dict, cfg, passes) -> dict:
    """The train pass's kernels' ms per step beside their floors over the
    step's passes (points each)."""
    out = {}
    for name in fused_train.phase_floors(cfg, 1):
        flops = sum(fused_train.phase_floors(cfg, m)[name]["flops"] for m in passes)
        nbytes = sum(fused_train.phase_floors(cfg, m)[name]["bytes"] for m in passes)
        out[name] = dict(ms=kernels_ms.get(name, 0.0), floor_ops_ms=flops / PEAK_FLOPS * 1e3,
                         floor_bytes_ms=nbytes / PEAK_BYTES * 1e3)
    return out


def general_floors(kernels_ms: dict, cfg, passes) -> dict:
    """The general route's forward, chain and dW kernels' ms per step beside
    their floors by operations over the step's passes, at the peak of the
    route's products (the dW GEMM's, ``dw_tc_kernel``, on both general
    routes' tensor cores: 989 TFLOP/s, 989 / 8 in f32), the dW GEMM's floor
    by bytes (each stash read once, ``fused_train.dw_floors``) and its
    reduce's ms (``dw_tc_reduce``), and the pass's stash floor by bytes."""
    peak = ROUTE_PEAKS.get(fused_nerf.train_route(cfg), PEAK_FLOPS)
    flops = fused_nerf.flops_per_point(cfg) * sum(passes)
    out = {name: dict(ms=kernels_ms.get(name, 0.0), floor_ops_ms=flops / peak * 1e3)
           for name in ("forward_kernel", "chain_kernel")}
    dw = [fused_train.dw_floors(cfg, m) for m in passes]
    dw_peak = PEAK_FLOPS / (8 if cfg.compute_dtype == torch.float32 else 1)
    out["dw_tc_kernel"] = dict(ms=kernels_ms.get("dw_tc_kernel", 0.0),
                               floor_ops_ms=sum(f["flops"] for f in dw) / dw_peak * 1e3,
                               floor_bytes_ms=sum(f["bytes"] for f in dw) / PEAK_BYTES * 1e3)
    out["dw_tc_reduce"] = dict(ms=kernels_ms.get("dw_tc_reduce", 0.0))
    out["stash_floor_ms"] = sum(fused_train.general_stash_bytes(cfg, m) for m in passes) / PEAK_BYTES * 1e3
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--model", choices=("nerf", "instant_nerf"), default="nerf")
    parser.add_argument("--layout", choices=("bricked", "hash", "packed", "packed_dual"), default=None,
                        help="with --model instant_nerf: one table layout (default: bricked and hash)")
    parser.add_argument("--occupancy", action="store_true", help="also the occupancy-pruned step")
    parser.add_argument("--route", choices=tuple(ROUTE_FIELDS), default="wgmma",
                        help="the classic field's route: f32_wgmma (path A), wgmma_general (path B, width "
                             "512), wide (bf16 1024, wgmma_general) or f32_wide (f32 1024, f32_wgmma)")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    images, poses, camera, _ = synthetic.make_dataset(num_views=8, img_size=400, device=dev)
    images, poses = torch.as_tensor(images, device=dev), torch.as_tensor(poses, device=dev)
    if args.model == "instant_nerf":
        settings = renderer.RenderSettings(num_samples_coarse=256, num_samples_fine=0)
        optim = train.OptimConfig(num_iter=300_000, init_lr=1e-2, end_lr=1e-3, eps=1e-15)
        paths = {}
        for layout in (args.layout,) if args.layout else ("bricked", "hash"):
            field = make_instant_ngp_field(compute_dtype=torch.bfloat16, table_layout=layout)
            paths[layout] = (field, False, None, None)
            if layout.startswith("packed"):
                cfg = config.resolve("instant_nerf", [f"network.table_layout={layout}",
                                                      "objective.encode_smoothness_weight=0.001"])
                paths[f"{layout}+smoothness"] = (field, False, session.build_aux_loss(cfg), None)
            if args.occupancy:
                paths[f"{layout}+occupancy"] = (field, False, None, occupancy.OccupancyConfig(keep_samples=128))
    else:
        settings = renderer.RenderSettings(num_samples_coarse=64, num_samples_fine=128)
        optim = train.OptimConfig()
        field = make_nerf_field(**ROUTE_FIELDS[args.route])
        paths = {"fused": (field, False, None, None), "generic": (field, True, None, None)}
        if args.occupancy:
            paths["fused_occupancy"] = (field, False, None,
                                        occupancy.OccupancyConfig(keep_samples=32, keep_samples_fine=128))
    out = {}
    for path, (field, generic, aux, occ) in paths.items():
        state = train.create_train_state(torch.Generator(device=dev).manual_seed(0), field, settings, optim, dev)
        step = train.make_image_train_step(field, settings, optim, camera, 4096, force_generic=generic,
                                           aux_loss_fn=aux, occupancy_cfg=occ)
        gen = torch.Generator(device=dev).manual_seed(1)
        grid = occupancy.init_grid(occ, dev) if occ else None
        out[path] = profile_path(step, state, grid, images, poses, gen, args.steps)
        if path == "fused":
            floors = kernel_floors if fused_nerf.train_route(field.fused_cfg) == "wgmma" else general_floors
            out[path]["floors"] = floors(out[path]["kernels_ms_per_step"], field.fused_cfg,
                                        (4096 * settings.num_samples_coarse,
                                         4096 * (settings.num_samples_coarse + settings.num_samples_fine)))
        print(json.dumps({"path": path, **out[path]}), flush=True)
    print(json.dumps({"card": nvidia_smi("name,power.limit,clocks.sm,power.draw")}), flush=True)
    return out


if __name__ == "__main__":
    main()
