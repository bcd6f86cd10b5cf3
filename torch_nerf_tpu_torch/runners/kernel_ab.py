"""Time two versions of a kernel in turns on one card.

Builds the repository's source of the kernel and another source with the
same C interface (for example the parent commit's, unpacked with ``git
archive``), checks that both agree, and times each. Rounds alternate the
order (other, repo, repo, other, ...). Prints one JSON line per turn, with
the SM clock, temperature and power draw after it, then a summary with
each side's median and quartiles, and the card's ``nvidia-smi`` line.

``--kernel fused_nerf_fwd`` (kernel 1, the default; ``--other`` a
``fused_nerf_fwd.cu``, which needs the headers it includes beside it):
each side on its own weight layout, as its library's
``fused_nerf_fwd_layout`` says (forward panel images on the ``wgmma``
route; fragment order in a library without that symbol); one launch at the
fine chunk (786,432 points) and at the coarse chunk (262,144 points) by
CUDA events, and whole 800x800 frames by the host clock, through a field
that prepares that side's layout.

``--kernel hash_fold_bwd`` (kernel 9; ``--other`` a ``hash_grid.cu``): the
table gradient of the ``packed`` and ``packed_dual`` layouts at the NGP
train point (L 16, F 2, 2^19 / 8 packed rows a level; 4096 rays x 256
samples of a 400x400 view), by CUDA events, each side held against the
plain version (relative L2).

    python -m torch_nerf_tpu_torch.runners.kernel_ab --other OLD.cu [--kernel K] [--rounds 4]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from torch_nerf_tpu_torch import cameras, renderer
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.device import resolve_device
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.models import hash_math, instant_ngp
from torch_nerf_tpu_torch.models.nerf import init_nerf_params
from torch_nerf_tpu_torch.ops import build, fused_nerf, hash_grid, sampling
from torch_nerf_tpu_torch.runners.timing import event_ms, kernel_library, nvidia_smi, quartiles


def _turns(rounds: int, libs: dict, module, measure, results: dict) -> None:
    """``measure(side) -> {metric: value}`` in alternating turns, each with
    ``module``'s launches routed through that side's library."""
    for r in range(rounds):
        order = ("other", "repo") if r % 2 == 0 else ("repo", "other")
        for side in order:
            with kernel_library(module, libs[side]):
                row = {"round": r, "side": side, **measure(side)}
            for k, v in row.items():
                if k not in ("round", "side"):
                    results[side].setdefault(k, []).append(v)
            # a card that heats or hits its power limit slows down
            # within a call: the clock beside each turn shows it
            row["sm_clock_temp_power"] = nvidia_smi("clocks.sm,temperature.gpu,power.draw")
            print(json.dumps(row), flush=True)


def field_forward(other: Path, rounds: int, frames: int, dev) -> dict:
    libs = {
        "repo": fused_nerf.bind(build.load(fused_nerf.KERNEL)),
        "other": fused_nerf.bind(build.load_source(other)),
    }
    routes = {side: "wgmma" if fused_nerf.library_layout(lib) == fused_nerf.LAYOUT_IMAGES else "mma_sync"
              for side, lib in libs.items()}
    print(json.dumps({"routes": routes}), flush=True)
    cfg = fused_nerf.FusedNeRFConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {k: init_nerf_params(gen, 63, 27, 256, dev) for k in ("coarse", "fine")}
    prepared = {side: fused_nerf.kernel_weights(params["fine"], cfg, route) for side, route in routes.items()}
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
            outs[side] = fused_nerf.fused_nerf_apply(prepared[side], pts, dirs, cfg)
    torch.cuda.synchronize()
    agree = max((a - b).abs().max().item() for a, b in zip(outs["repo"], outs["other"]))
    print(json.dumps({"max_abs_diff_repo_vs_other": agree}), flush=True)

    base = make_nerf_field(compute_dtype=torch.bfloat16)
    fields = {side: dataclasses.replace(base, prepare=lambda p, r=route: fused_nerf.kernel_weights(p, cfg, r))
              for side, route in routes.items()}
    settings = renderer.RenderSettings(num_samples_coarse=64, num_samples_fine=128)

    def measure(side):
        row = {}
        for shape, (p, q) in inputs.items():
            row[f"{shape}_ms"] = event_ms(lambda: fused_nerf.fused_nerf_apply(prepared[side], p, q, cfg), 20)
        field = fields[side]
        renderer.render_image(field, params["coarse"], params["fine"], camera, pose, 0, settings, chunk_size=4096)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(frames):
            renderer.render_image(field, params["coarse"], params["fine"], camera, pose, 1 + i, settings,
                                  chunk_size=4096)
        torch.cuda.synchronize()
        row["s_per_frame"] = (time.perf_counter() - t0) / frames
        return row

    results = {side: {} for side in libs}
    _turns(rounds, libs, fused_nerf, measure, results)
    return results


def fold_backward(other: Path, rounds: int, dev) -> dict:
    libs = {
        "repo": hash_grid.bind(build.load(hash_grid.KERNEL)),
        "other": hash_grid.bind(build.load_source(other)),
    }
    gen = torch.Generator(device=dev).manual_seed(0)
    camera = cameras.CameraParams(480.0, 480.0, 400, 400)
    pose = torch.as_tensor(synthetic.split_poses(8, "train")[0], device=dev)
    o, d = cameras.rays_for_pixels(torch.randperm(400 * 400, generator=gen, device=dev)[:4096], camera, pose)
    uni = renderer.draw_uniforms(gen, 4096, renderer.RenderSettings(num_samples_coarse=256, num_samples_fine=0))
    t = sampling.stratified_t_samples_from_uniforms(uni.coarse, 2.0, 6.0)
    pts = (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 3).contiguous()
    base = torch.as_tensor(hash_math.level_resolutions(16, 16, 512), device=dev)
    f, lines = 2, 2**19 // 8 // hash_grid.fold_factor(2)
    cases = {"packed": (base, torch.zeros_like(base)), "packed_dual": instant_ngp.dual_resolutions_offsets(base)}
    grads = {k: torch.randn((pts.shape[0], r.shape[0] * f), generator=gen, device=dev) for k, (r, _) in cases.items()}
    check = {}
    for layout, (res, off) in cases.items():
        ref = hash_grid.fold_backward_reference(grads[layout], pts, res, off, lines, f)
        for side, lib in libs.items():
            with kernel_library(hash_grid, lib):
                got = hash_grid.hash_fold_bwd(grads[layout], pts, res, off, lines, f)
            check[f"{side}/{layout}"] = ((got - ref).norm() / ref.norm()).item()
    print(json.dumps({"rel_l2_vs_plain": check}), flush=True)

    def measure(side):
        return {f"{layout}_ms": event_ms(lambda: hash_grid.hash_fold_bwd(grads[layout], pts, res, off, lines, f), 20)
                for layout, (res, off) in cases.items()}

    results = {side: {} for side in libs}
    _turns(rounds, libs, hash_grid, measure, results)
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="the other version's .cu, with the same C interface")
    parser.add_argument("--kernel", choices=("fused_nerf_fwd", "hash_fold_bwd"), default="fused_nerf_fwd")
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--frames", type=int, default=1, help="timed frames per turn (fused_nerf_fwd)")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    other = Path(args.other).resolve()
    if args.kernel == "fused_nerf_fwd":
        results = field_forward(other, args.rounds, args.frames, dev)
    else:
        results = fold_backward(other, args.rounds, dev)
    smi = nvidia_smi("name,power.limit")
    summary = {side: {k: quartiles(v) for k, v in res.items()} for side, res in results.items()}
    print(json.dumps({"kernel": args.kernel, "summary": summary, "card": smi}), flush=True)
    return summary


if __name__ == "__main__":
    main()
