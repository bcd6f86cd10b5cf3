"""Time two versions of the fused train pass in turns on one card.

Builds the repository's ``ops/csrc/fused_train.cu`` and another source with
the same C interface (a directory holding its ``fused_train.cu`` and the
headers it includes, for example an earlier version kept under
``outputs/``), checks that both give the same result on one batch, and
times each at ``bench.py``'s operating point: one launch at the fine pass
(4096 x 192 points) and at the coarse pass (4096 x 64) by CUDA events, and
whole fused train steps by the host clock. Rounds alternate the order
(other, repo, repo, other, ...). Prints one JSON line per turn with the SM
clock, temperature and power draw after it, then each side's median and
quartiles and the card's ``nvidia-smi`` line.

    python -m torch_nerf_tpu_torch.runners.train_ab --other DIR [--rounds 4]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from torch_nerf_tpu_torch import cameras, renderer, train
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.device import resolve_device
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.ops import build, sampling
from torch_nerf_tpu_torch.ops import fused_train as ftm
from torch_nerf_tpu_torch.runners.timing import event_ms, kernel_library, nvidia_smi, quartiles


def step_batch(step, images, poses, camera, gen):
    """One ray batch of an image train step without precrop, drawn as the
    step draws it: ``(ray_o, ray_d, rgb_gt, RayUniforms)``."""
    draws = step.draw(gen, images.shape[0])
    pix = train.sample_pixels_without_replacement_from_uniforms(draws.pixel_u, step.num_pixels)
    idx = int(draws.image_index)
    o, d = cameras.rays_for_pixels(pix, camera, poses[idx])
    return o.contiguous(), d.contiguous(), images[idx][pix].contiguous(), draws.rays


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="a directory with a fused_train.cu of the same C interface")
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--steps", type=int, default=10, help="timed train steps per turn")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    libs = {
        "repo": ftm.bind(build.load(ftm.KERNEL)),
        "other": ftm.bind(build.load_source(Path(args.other).resolve() / "fused_train.cu")),
    }
    images, poses, camera, _ = synthetic.make_dataset(num_views=8, img_size=400, device=dev)
    images, poses = torch.as_tensor(images, device=dev), torch.as_tensor(poses, device=dev)
    field = make_nerf_field(compute_dtype=torch.bfloat16)
    cfg = field.fused_cfg
    settings = renderer.RenderSettings(num_samples_coarse=64, num_samples_fine=128)
    optim = train.OptimConfig()
    state = train.create_train_state(torch.Generator(device=dev).manual_seed(0), field, settings, optim, dev)
    step = train.make_image_train_step(field, settings, optim, camera, 4096)
    gen = torch.Generator(device=dev).manual_seed(1)

    # one batch of the step, its coarse and fine depths
    o, d, gt, rays = step_batch(step, images, poses, camera, gen)
    params = state.params
    with torch.no_grad():
        t_c = sampling.stratified_t_samples_from_uniforms(rays.coarse, settings.t_near, settings.t_far)
        _, w_c, _ = ftm.fused_train_pass(params["coarse"], o, d, t_c, sampling.t_deltas(t_c), gt, cfg, 4096)
        t_f = sampling.hierarchical_t_samples_from_uniforms(
            w_c, settings.t_near, settings.t_far, rays.fine_coarse, rays.u, rays.fine
        ).contiguous()
    inputs = {name: (params[net], t, sampling.t_deltas(t))
              for name, net, t in (("fine", "fine", t_f), ("coarse", "coarse", t_c))}

    outs = {}
    for side, lib in libs.items():
        with kernel_library(ftm, lib), torch.no_grad():
            p, t, delta = inputs["fine"]
            outs[side] = ftm.fused_train_pass(p, o, d, t, delta, gt, cfg, 4096)
    torch.cuda.synchronize()
    a, b = outs["repo"], outs["other"]
    agree = max([(a[0] - b[0]).abs().max().item(), (a[1] - b[1]).abs().max().item()]
                + [(a[2][n][k] - b[2][n][k]).abs().max().item() for n in a[2] for k in a[2][n]])
    print(json.dumps({"max_abs_diff_repo_vs_other": agree}), flush=True)

    results = {side: {"fine_ms": [], "coarse_ms": [], "step_ms": []} for side in libs}
    for r in range(args.rounds):
        order = ("other", "repo") if r % 2 == 0 else ("repo", "other")
        for side in order:
            row = {"round": r, "side": side}
            with kernel_library(ftm, libs[side]):
                with torch.no_grad():
                    for name, (p, t, delta) in inputs.items():
                        ms = event_ms(lambda: ftm.fused_train_pass(p, o, d, t, delta, gt, cfg, 4096), 10)
                        row[f"{name}_ms"] = ms
                        results[side][f"{name}_ms"].append(ms)
                state, _ = step(state, images, poses, gen)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    state, _ = step(state, images, poses, gen)
                torch.cuda.synchronize()
            row["step_ms"] = (time.perf_counter() - t0) / args.steps * 1e3
            results[side]["step_ms"].append(row["step_ms"])
            row["sm_clock_temp_power"] = nvidia_smi("clocks.sm,temperature.gpu,power.draw")
            print(json.dumps(row), flush=True)

    summary = {side: {k: quartiles(v) for k, v in res.items()} for side, res in results.items()}
    print(json.dumps({"summary": summary, "card": nvidia_smi("name,power.limit")}), flush=True)
    return summary


if __name__ == "__main__":
    main()
