"""Where a train step's time goes on the card, by kernel.

Runs train steps at ``bench.py``'s operating point (8 procedural views at
400x400, 4096 rays, seeded random weights) and traces a few steps of each
path with ``torch.profiler``: for the classic NeRF (64 + 128 samples) the
fused train pass and autograd through the field; with ``--model
instant_nerf`` (256 samples, no fine network, Adam 1e-2 at eps 1e-15) the
bricked and the per-corner hash layouts. Prints one JSON line per path:
the host-clock ms per step, the device ms per step of every kernel by name
(each launch's own device time, summed and divided by the steps), their
sum, and the device's idle share of the step (1 - busy / step); then the
card's ``nvidia-smi`` line.

    python -m torch_nerf_tpu_torch.runners.train_profile [--model instant_nerf] [--steps 5]
"""

from __future__ import annotations

import argparse
import json
import re
import time

import torch

from torch_nerf_tpu_torch import renderer, train
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.device import resolve_device
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.fields_ngp import make_instant_ngp_field
from torch_nerf_tpu_torch.runners.timing import nvidia_smi


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*$", "", name)
    name = re.sub(r"<.*>", "", name)
    return name.replace("void ", "").strip()


def profile_path(step, state, images, poses, gen, steps: int) -> dict:
    for _ in range(3):
        state, _ = step(state, images, poses, gen)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, images, poses, gen)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    kernels = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = _short(evt.key)
        kernels[key] = kernels.get(key, 0.0) + us / 1e3 / steps
    busy = sum(kernels.values())
    step_ms = elapsed / steps * 1e3
    return dict(step_ms=step_ms, device_busy_ms=busy, idle_share=1.0 - busy / step_ms,
                kernels_ms_per_step=dict(sorted(kernels.items(), key=lambda kv: -kv[1])))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--model", choices=("nerf", "instant_nerf"), default="nerf")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    images, poses, camera, _ = synthetic.make_dataset(num_views=8, img_size=400, device=dev)
    images, poses = torch.as_tensor(images, device=dev), torch.as_tensor(poses, device=dev)
    if args.model == "instant_nerf":
        settings = renderer.RenderSettings(num_samples_coarse=256, num_samples_fine=0)
        optim = train.OptimConfig(num_iter=300_000, init_lr=1e-2, end_lr=1e-3, eps=1e-15)
        paths = {layout: (make_instant_ngp_field(compute_dtype=torch.bfloat16, table_layout=layout), False)
                 for layout in ("bricked", "hash")}
    else:
        settings = renderer.RenderSettings(num_samples_coarse=64, num_samples_fine=128)
        optim = train.OptimConfig()
        field = make_nerf_field(compute_dtype=torch.bfloat16)
        paths = {"fused": (field, False), "generic": (field, True)}
    out = {}
    for path, (field, generic) in paths.items():
        state = train.create_train_state(torch.Generator(device=dev).manual_seed(0), field, settings, optim, dev)
        step = train.make_image_train_step(field, settings, optim, camera, 4096, force_generic=generic)
        gen = torch.Generator(device=dev).manual_seed(1)
        out[path] = profile_path(step, state, images, poses, gen, args.steps)
        print(json.dumps({"path": path, **out[path]}), flush=True)
    print(json.dumps({"card": nvidia_smi("name,power.limit,clocks.sm,power.draw")}), flush=True)
    return out


if __name__ == "__main__":
    main()
