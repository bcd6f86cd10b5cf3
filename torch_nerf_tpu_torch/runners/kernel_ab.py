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

``--kernel hash_fold_bwd`` (kernel 9), ``hash_brick_bwd`` (kernel 5),
``hash_corner_bwd`` (kernel 7), ``hash_brick_fwd`` (kernel 4),
``hash_corner_fwd`` (kernel 6) or ``hash_fold_fwd`` (kernel 8), ``--other``
a ``hash_grid.cu``: the table gradient (a backward) or the features (a
forward) of the kernel's layouts (``packed`` and ``packed_dual``;
``bricked``; ``hash``) at the NGP train point (L 16, F 2, T 2^19, the brick
table (16, 8192, 128); 4096 rays x 256 samples of a 400x400 view, 2^20
points), by CUDA events, each side held against the plain version
(relative L2, and the two sides' largest difference); then whole train
steps of each layout at ``bench.py --model=instant_nerf``'s point (host
clock, each side's library taking the step's hash forward and backward)
and, for a forward, one 800x800 frame of each layout at ``bench.py
--render --model=instant_nerf``'s point (157 forward launches).

    python -m torch_nerf_tpu_torch.runners.kernel_ab --other OLD.cu [--kernel K] [--rounds 4]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from torch_nerf_tpu_torch import cameras, renderer, train
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.device import resolve_device
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.fields_ngp import make_instant_ngp_field
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


HASH_KERNELS = {"hash_fold_bwd": ("packed", "packed_dual"), "hash_brick_bwd": ("bricked",),
                "hash_corner_bwd": ("hash",), "hash_brick_fwd": ("bricked",), "hash_corner_fwd": ("hash",),
                "hash_fold_fwd": ("packed", "packed_dual")}
NGP_GRID = dict(num_level=16, log_max_entry_per_level=19, table_feat_dim=2, min_res=16, max_res=512)
TRAIN_STEPS = 10  # timed train steps a layout and turn, after one untimed


def _hash_backward_call(layout, g, pts, base):
    """(the kernel's call, its plain version's) for ``layout``'s table
    gradient of cotangent ``g`` at ``pts``."""
    f, log_t = NGP_GRID["table_feat_dim"], NGP_GRID["log_max_entry_per_level"]
    if layout == "bricked":
        bricks = hash_grid.bricks_per_level(log_t, f)
        return (lambda: hash_grid.hash_brick_bwd(g, pts, base, bricks),
                lambda: hash_grid.brick_backward_reference(g, pts, base, bricks))
    if layout == "hash":
        return (lambda: hash_grid.hash_corner_bwd(g, pts, base, 2**log_t, f),
                lambda: hash_grid.corner_backward_reference(g, pts, base, 2**log_t, f))
    res, off = (base, torch.zeros_like(base)) if layout == "packed" else instant_ngp.dual_resolutions_offsets(base)
    lines = 2**log_t // 8 // hash_grid.fold_factor(f)
    return (lambda: hash_grid.hash_fold_bwd(g, pts, res, off, lines, f),
            lambda: hash_grid.fold_backward_reference(g, pts, res, off, lines, f))


def _hash_forward_call(layout, tables, pts, base):
    """(the kernel's call, its plain version's) for ``layout``'s features of
    ``tables`` (the brick layout's (L, T_b, 128); the corner layout's (L, T,
    F); the packed layouts' folded (L', rows/fold, 128)) at ``pts``."""
    if layout == "bricked":
        return (lambda: hash_grid.hash_brick_fwd(tables, pts, base),
                lambda: hash_grid.brick_encode_reference(tables, pts, base))
    if layout == "hash":
        return (lambda: hash_grid.hash_corner_fwd(tables, pts, base),
                lambda: hash_grid.corner_encode_reference(tables, pts, base))
    f = NGP_GRID["table_feat_dim"]
    res, off = (base, torch.zeros_like(base)) if layout == "packed" else instant_ngp.dual_resolutions_offsets(base)
    return (lambda: hash_grid.hash_fold_fwd(tables, pts, res, off, f),
            lambda: hash_grid.fold_encode_reference(tables, pts, res, off, f))


def hash_kernel(kernel: str, other: Path, rounds: int, dev) -> dict:
    libs = {
        "repo": hash_grid.bind(build.load(hash_grid.KERNEL)),
        "other": hash_grid.bind(build.load_source(other)),
    }
    forward = kernel.endswith("_fwd")
    gen = torch.Generator(device=dev).manual_seed(0)
    images, poses, camera, _ = synthetic.make_dataset(num_views=8, img_size=400, device=dev)
    images, poses = torch.as_tensor(images, device=dev), torch.as_tensor(poses, device=dev)
    settings = renderer.RenderSettings(num_samples_coarse=256, num_samples_fine=0)
    o, d = cameras.rays_for_pixels(torch.randperm(400 * 400, generator=gen, device=dev)[:4096], camera, poses[0])
    t = sampling.stratified_t_samples_from_uniforms(renderer.draw_uniforms(gen, 4096, settings).coarse, 2.0, 6.0)
    pts = (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 3).contiguous()
    base = torch.as_tensor(
        hash_math.level_resolutions(NGP_GRID["num_level"], NGP_GRID["min_res"], NGP_GRID["max_res"]), device=dev)
    f, log_t = NGP_GRID["table_feat_dim"], NGP_GRID["log_max_entry_per_level"]
    calls, check = {}, {}
    for layout in HASH_KERNELS[kernel]:
        levels = 2 * base.shape[0] if layout == "packed_dual" else base.shape[0]
        if forward:
            if layout == "bricked":
                shape = (levels, hash_grid.bricks_per_level(log_t, f), 128)
            elif layout == "hash":
                shape = (levels, 2**log_t, f)
            else:
                shape = (levels, 2**log_t // 8 // hash_grid.fold_factor(f), 128)
            tables = torch.rand(shape, generator=gen, device=dev) * 2.0 - 1.0
            calls[layout], plain = _hash_forward_call(layout, tables, pts, base)
        else:
            g = torch.randn((pts.shape[0], levels * f), generator=gen, device=dev)
            calls[layout], plain = _hash_backward_call(layout, g, pts, base)
        ref = plain()
        got = {}
        for side, lib in libs.items():
            with kernel_library(hash_grid, lib):
                got[side] = calls[layout]()
            check[f"{side}/{layout}"] = ((got[side] - ref).norm() / ref.norm()).item()
        check[f"max_abs_diff_repo_vs_other/{layout}"] = (got["repo"] - got["other"]).abs().max().item()
    print(json.dumps({"rel_l2_vs_plain": check}), flush=True)

    optim = train.OptimConfig(num_iter=300_000, init_lr=1e-2, end_lr=1e-3, eps=1e-15)
    trainers, fields = {}, {}
    frame_camera = cameras.CameraParams(960.0, 960.0, 800, 800)
    frame_pose = torch.as_tensor(synthetic.split_poses(1, "train")[0], device=dev)
    for layout in HASH_KERNELS[kernel]:
        field = make_instant_ngp_field(**NGP_GRID, compute_dtype=torch.bfloat16, table_layout=layout)
        step = train.make_image_train_step(field, settings, optim, camera, 4096)
        # each side steps a state of its own from the same seed
        trainers[layout] = (step, {side: train.create_train_state(torch.Generator(device=dev).manual_seed(0), field,
                                                                 settings, optim, dev) for side in libs})
        if forward:
            fields[layout] = (field, field.init(torch.Generator(device=dev).manual_seed(0), dev))

    def measure(side):
        row = {f"{layout}_ms": event_ms(run, 20) for layout, run in calls.items()}
        for layout, (step, states) in trainers.items():
            step_gen = torch.Generator(device=dev).manual_seed(1)
            states[side], _ = step(states[side], images, poses, step_gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                states[side], _ = step(states[side], images, poses, step_gen)
            torch.cuda.synchronize()
            row[f"{layout}_step_ms"] = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        for layout, (field, params) in fields.items():
            renderer.render_image(field, params, None, frame_camera, frame_pose, 1, settings, chunk_size=4096)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            renderer.render_image(field, params, None, frame_camera, frame_pose, 2, settings, chunk_size=4096)
            torch.cuda.synchronize()
            row[f"{layout}_s_per_frame"] = time.perf_counter() - t0
        return row

    results = {side: {} for side in libs}
    _turns(rounds, libs, hash_grid, measure, results)
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="the other version's .cu, with the same C interface")
    parser.add_argument("--kernel", choices=("fused_nerf_fwd", *HASH_KERNELS), default="fused_nerf_fwd")
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--frames", type=int, default=1, help="timed frames per turn (fused_nerf_fwd)")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    other = Path(args.other).resolve()
    if args.kernel == "fused_nerf_fwd":
        results = field_forward(other, args.rounds, args.frames, dev)
    else:
        results = hash_kernel(args.kernel, other, args.rounds, dev)
    smi = nvidia_smi("name,power.limit")
    summary = {side: {k: quartiles(v) for k, v in res.items()} for side, res in results.items()}
    print(json.dumps({"kernel": args.kernel, "summary": summary, "card": smi}), flush=True)
    return summary


if __name__ == "__main__":
    main()
