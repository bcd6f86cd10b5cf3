"""Time two versions of the fused field kernel in turns on one card.

Builds the repository's ``ops/csrc/fused_nerf_fwd.cu`` and another source
with the same C interface (for example the parent commit's, unpacked with
``git archive``), checks that both agree with the plain version, and times
each at the render path's shapes: one launch at the fine chunk (786,432
points) and at the coarse chunk (262,144 points) by CUDA events, and whole
800x800 frames by the host clock. Rounds alternate the order (other, repo,
repo, other, ...). Prints one JSON line per measurement, with the SM
clock, temperature and power draw after it, then a summary with each side's
median and quartiles, and the card's ``nvidia-smi`` line.

    python -m torch_nerf_tpu_torch.runners.kernel_ab --other OLD.cu [--rounds 4]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from torch_nerf_tpu_torch import cameras, renderer
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.device import resolve_device
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.models.nerf import init_nerf_params
from torch_nerf_tpu_torch.ops import build, fused_nerf
from torch_nerf_tpu_torch.runners.timing import event_ms, kernel_library, nvidia_smi, quartiles


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="a .cu with fused_nerf_fwd's C interface")
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--frames", type=int, default=1, help="timed frames per turn")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")

    libs = {
        "repo": fused_nerf.bind(build.load(fused_nerf.KERNEL)),
        "other": fused_nerf.bind(build.load_source(Path(args.other).resolve())),
    }
    cfg = fused_nerf.FusedNeRFConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {k: init_nerf_params(gen, 63, 27, 256, dev) for k in ("coarse", "fine")}
    prepared = fused_nerf.prepare(params["fine"], cfg)
    camera = cameras.CameraParams(960.0, 960.0, 800, 800)
    pose = torch.as_tensor(synthetic.split_poses(1, "train")[0], device=dev)
    o, d = cameras.rays_for_pixels(torch.arange(4096, device=dev), camera, pose)
    inputs = {}
    for name, samples in (("fine", 192), ("coarse", 64)):
        t = torch.sort(2.0 + 4.0 * torch.rand((4096, samples), generator=gen, device=dev)).values
        pts = (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 3).contiguous()
        dirs = d[:, None, :].expand(-1, samples, -1).reshape(-1, 3).contiguous()
        inputs[name] = (pts, dirs)

    pts, dirs = inputs["fine"]
    outs = {}
    for side, lib in libs.items():
        with kernel_library(fused_nerf, lib):
            outs[side] = fused_nerf.fused_nerf_apply(prepared, pts, dirs, cfg)
    torch.cuda.synchronize()
    agree = max((a - b).abs().max().item() for a, b in zip(outs["repo"], outs["other"]))
    print(json.dumps({"max_abs_diff_repo_vs_other": agree}), flush=True)

    field = make_nerf_field(compute_dtype=torch.bfloat16)
    settings = renderer.RenderSettings(num_samples_coarse=64, num_samples_fine=128)
    results = {side: {"fine_ms": [], "coarse_ms": [], "s_per_frame": []} for side in libs}
    for r in range(args.rounds):
        order = ("other", "repo") if r % 2 == 0 else ("repo", "other")
        for side in order:
            row = {"round": r, "side": side}
            with kernel_library(fused_nerf, libs[side]):
                for shape, (p, q) in inputs.items():
                    ms = event_ms(lambda: fused_nerf.fused_nerf_apply(prepared, p, q, cfg), 20)
                    row[f"{shape}_ms"] = ms
                    results[side][f"{shape}_ms"].append(ms)
                renderer.render_image(field, params["coarse"], params["fine"], camera, pose, 0,
                                      settings, chunk_size=4096)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(args.frames):
                    renderer.render_image(field, params["coarse"], params["fine"], camera, pose,
                                          1 + i, settings, chunk_size=4096)
                torch.cuda.synchronize()
            row["s_per_frame"] = (time.perf_counter() - t0) / args.frames
            results[side]["s_per_frame"].append(row["s_per_frame"])
            # a card that heats or hits its power limit slows down
            # within a call: the clock beside each turn shows it
            row["sm_clock_temp_power"] = nvidia_smi("clocks.sm,temperature.gpu,power.draw")
            print(json.dumps(row), flush=True)

    smi = nvidia_smi("name,power.limit")
    summary = {side: {k: quartiles(v) for k, v in res.items()} for side, res in results.items()}
    print(json.dumps({"summary": summary, "card": smi}), flush=True)
    return summary


if __name__ == "__main__":
    main()
