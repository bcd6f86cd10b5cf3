"""Time versions of the training kernels in turns on one card.

Each side is a whole checkout of the port: this repository and each
``--other DIR`` (for example ``git archive`` of an earlier commit unpacked
under ``outputs/``), each with its own kernels and its own weight-layout
code, so two designs whose layouts differ can be held side by side. Every
turn is a fresh process run from one side's checkout (``PYTHONPATH`` set to
it, this file run by its path): it builds that side's kernels into the
side's own ``_build`` (every side is built first, at once) and times, at
``bench.py``'s train point, kernel 3 at the fine (4096 x 192) and the
coarse (4096 x 64) pass and kernel 2 at the fine points (CUDA events), then
whole fused and ``force_generic`` train steps (host clock) and the peak
device memory of those steps (``torch.cuda.max_memory_allocated``). With
``--kernel dw`` a turn times instead the general route's dW GEMM alone
(``fused_nerf.general_dw``, in checkouts that have it) over each
``--config``'s kernel-2 stash at the fine shape (786,432 seeded random
points, port-init weights). Turns alternate (others, repo, repo, others,
...). The first turn of each side saves its outputs (the fine pass's, or
the dW's grads), and each side's largest difference from this
repository's is printed.
Prints one JSON line per turn with the SM clock, temperature and power
draw after it, then each side's median and quartiles and the card's
``nvidia-smi`` line. ``--route f32_wgmma`` or ``wgmma_general`` times the
tensor-core general route at path A's or B's config, ``wide`` its bf16
1024 (``train_profile.ROUTE_FIELDS``), in place of the preset's ``wgmma``;
the other side runs the same config under the route name its checkout
knows (``--other-route``, by default the same name), so that each side's
route takes it. ``--field FEAT:LEVEL[:DIR_LEVEL][:f32]`` times that
classic config on both sides instead, each on the route its own checkout
gives it (an f32 config past 512 against a checkout that ran it on FFMA,
for example). ``--steps 0`` leaves out the train steps (kernels 2-3
alone: a step's generic path at f32 1024 holds more than the card).

    python -m torch_nerf_tpu_torch.runners.train_ab --other DIR [--rounds 4] [--route R [--other-route R]]
    python -m torch_nerf_tpu_torch.runners.train_ab --kernel dw --other DIR [--other DIR ...]
        [--config 512:12 --config 256:10:f32] [--rounds 2]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from torch_nerf_tpu_torch import cameras, renderer, train
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.device import resolve_device
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.models.nerf import init_nerf_params
from torch_nerf_tpu_torch.ops import fused_nerf as fn
from torch_nerf_tpu_torch.ops import fused_train as ftm
from torch_nerf_tpu_torch.ops import sampling
from torch_nerf_tpu_torch.runners.timing import event_ms, nvidia_smi, quartiles
from torch_nerf_tpu_torch.runners import train_profile

REPO = Path(__file__).resolve().parents[2]
# the training and forward kernels' sources (a side builds those it has)
KERNELS = ["fused_nerf_fwd", "fused_nerf_bwd", "fused_train", "fused_tc_fwd", "fused_tc_bwd", "fused_tc_train"]


def step_batch(step, images, poses, camera, gen):
    """One ray batch of an image train step without precrop, drawn as the
    step draws it: ``(ray_o, ray_d, rgb_gt, RayUniforms)``."""
    draws = step.draw(gen, images.shape[0])
    pix = train.sample_pixels_without_replacement_from_uniforms(draws.pixel_u, step.num_pixels)
    idx = int(draws.image_index)
    o, d = cameras.rays_for_pixels(pix, camera, poses[idx])
    return o.contiguous(), d.contiguous(), images[idx][pix].contiguous(), draws.rays


def field_of(spec: str):
    """The classic field of ``FEAT:LEVEL[:DIR_LEVEL][:f32]`` (dir level 4
    by default), its kernels on. (A turn imports the other side's package,
    whose runners may not parse such specs: this file parses its own.)"""
    parts = spec.split(":")
    single = parts[-1] == "f32"
    parts = parts[:-1] if single else parts
    return make_nerf_field(coord_encode_level=int(parts[1]), dir_encode_level=int(parts[2]) if len(parts) > 2 else 4,
                           feat_dim=int(parts[0]), compute_dtype=torch.float32 if single else torch.bfloat16)


def turn(steps: int, save: str = "", route: str = "wgmma", field_spec: str = "") -> dict:
    """One side's timings, in the checkout this process imports: the
    field of ``field_spec`` where given, else ``route``'s path's."""
    dev = resolve_device("cuda")
    images, poses, camera, _ = synthetic.make_dataset(num_views=8, img_size=400, device=dev)
    images, poses = torch.as_tensor(images, device=dev), torch.as_tensor(poses, device=dev)
    field = field_of(field_spec) if field_spec else make_nerf_field(**train_profile.ROUTE_FIELDS[route])
    cfg = field.fused_cfg
    settings = renderer.RenderSettings(num_samples_coarse=64, num_samples_fine=128)
    optim = train.OptimConfig()
    out = {"route": fn.train_route(cfg)}
    for path, generic in (("fused", False), ("generic", True)) if steps else (("fused", False),):
        state = train.create_train_state(torch.Generator(device=dev).manual_seed(0), field, settings, optim, dev)
        step = train.make_image_train_step(field, settings, optim, camera, 4096, force_generic=generic)
        gen = torch.Generator(device=dev).manual_seed(1)
        if path == "fused":
            # one batch of the step, its coarse and fine depths
            o, d, gt, rays = step_batch(step, images, poses, camera, gen)
            params = state.params
            with torch.no_grad():
                t_c = sampling.stratified_t_samples_from_uniforms(rays.coarse, settings.t_near, settings.t_far)
                _, w_c, _ = ftm.fused_train_pass(params["coarse"], o, d, t_c, sampling.t_deltas(t_c), gt, cfg, 4096)
                t_f = sampling.hierarchical_t_samples_from_uniforms(
                    w_c, settings.t_near, settings.t_far, rays.fine_coarse, rays.u, rays.fine).contiguous()
                for name, net, t in (("fine", "fine", t_f), ("coarse", "coarse", t_c)):
                    delta = sampling.t_deltas(t)
                    out[f"{name}_ms"] = event_ms(
                        lambda: ftm.fused_train_pass(params[net], o, d, t, delta, gt, cfg, 4096), 10)
                pts = (o[:, None, :] + t_f[..., None] * d[:, None, :]).reshape(-1, 3).contiguous()
                dirs = d[:, None, :].expand(-1, t_f.shape[1], -1).reshape(-1, 3).contiguous()
                g = torch.Generator(device=dev).manual_seed(4)
                g_sigma = torch.randn((pts.shape[0],), generator=g, device=dev)
                g_rgb = torch.randn((pts.shape[0], 3), generator=g, device=dev)
                out["bwd_ms"] = event_ms(lambda: fn.fused_nerf_bwd(params["fine"], pts, dirs, g_sigma, g_rgb, cfg), 5)
                if save:
                    rgb, w, grads = ftm.fused_train_pass(params["fine"], o, d, t_f, sampling.t_deltas(t_f), gt, cfg,
                                                         4096)
                    torch.save({"rgb": rgb.cpu(), "weights": w.cpu(),
                                "grads": {n: {k: v.cpu() for k, v in p.items()} for n, p in grads.items()}}, save)
        if not steps:
            break
        state, _ = step(state, images, poses, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, images, poses, gen)
        torch.cuda.synchronize()
        out[f"{path}_step_ms"] = (time.perf_counter() - t0) / steps * 1e3
        out[f"{path}_step_peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    out["sm_clock_temp_power"] = nvidia_smi("clocks.sm,temperature.gpu,power.draw")
    return out


def dw_turn(configs, save: str = "") -> dict:
    """This checkout's dW GEMM alone on each config's fine stash."""
    dev = resolve_device("cuda")
    out, grads = {}, {}
    for spec in configs:
        feat, level, *dtype = spec.split(":")
        cfg = fn.FusedNeRFConfig(coord_encode_level=int(level), feat_dim=int(feat),
                                 compute_dtype=torch.float32 if dtype == ["f32"] else torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(3)
        m = 4096 * 192
        pts = torch.rand((m, 3), generator=gen, device=dev) * 4 - 2
        dirs = torch.nn.functional.normalize(torch.randn((m, 3), generator=gen, device=dev), dim=-1)
        g_sigma = torch.randn((m,), generator=gen, device=dev)
        g_rgb = torch.randn((m, 3), generator=gen, device=dev)
        params = init_nerf_params(torch.Generator(device=dev).manual_seed(0), cfg.pos_enc_dim, cfg.dir_enc_dim,
                                  cfg.feat_dim, device=dev)
        workspace = fn.general_stash(params, pts, dirs, g_sigma, g_rgb, cfg)
        out[f"{spec}_ms"] = event_ms(lambda: fn.general_dw(workspace, m, cfg), 10)
        if save:
            grads[spec] = {str(i): t.cpu() for i, t in enumerate(t for ts in fn.general_dw(workspace, m, cfg)
                                                               for t in ts)}
        del workspace
        torch.cuda.empty_cache()
    if save:
        torch.save(grads, save)
    out["sm_clock_temp_power"] = nvidia_smi("clocks.sm,temperature.gpu,power.draw")
    return out


def _run(side: Path, args) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(side))
    return subprocess.run([sys.executable, str(Path(__file__).resolve()), *args], cwd=side, env=env,
                          capture_output=True, text=True, check=True)


def _build(side: Path, kernels) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(side))
    names = [k for k in kernels if (side / "torch_nerf_tpu_torch" / "ops" / "csrc" / f"{k}.cu").exists()]
    code = f"from torch_nerf_tpu_torch.ops import build; build.build({names!r})"
    return subprocess.Popen([sys.executable, "-c", code], cwd=side, env=env)


def _max_diff(a, b) -> float:
    if isinstance(a, dict):
        return max(_max_diff(a[k], b[k]) for k in a)
    return (a - b).abs().max().item()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", action="append", default=[], help="a checkout of another version of the port")
    parser.add_argument("--kernel", choices=("train", "dw"), default="train",
                        help="train: kernels 2-3 and the train steps; dw: the general route's dW GEMM alone")
    parser.add_argument("--config", action="append", help="with --kernel dw: FEAT:LEVEL (bf16) or FEAT:LEVEL:f32 "
                                                          "(default: 512:12 and 256:10:f32)")
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--steps", type=int, default=10, help="timed train steps per path and turn (0: none)")
    parser.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--save", default="", help=argparse.SUPPRESS)
    parser.add_argument("--route", choices=tuple(train_profile.ROUTE_FIELDS), default="wgmma",
                        help="the classic field's route: f32_wgmma (path A), wgmma_general (path B, width 512), "
                             "wide (bf16 1024) or f32 (width 320)")
    parser.add_argument("--field", default="", help="FEAT:LEVEL[:DIR_LEVEL][:f32]: time this classic config on "
                                                     "both sides, each on the route its checkout gives it (in "
                                                     "place of --route)")
    parser.add_argument("--other-route", default=None,
                        help="the same config's route name in the other checkout (default: "
                             "the same name)")
    args = parser.parse_args(argv)
    configs = args.config or ["512:12", "256:10:f32"]
    if args.turn:
        row = (dw_turn(configs, args.save) if args.kernel == "dw" else
               turn(args.steps, args.save, args.route, args.field))
        print(json.dumps(row), flush=True)
        return {}
    if not args.other:
        parser.error("--other is required")
    others = {("other" if len(args.other) == 1 else f"other{i}"): Path(d).resolve() for i, d in enumerate(args.other)}
    sides = {**others, "repo": REPO}
    other_route = args.other_route or args.route
    flags = {side: (["--kernel", "dw"] + [f for c in configs for f in ("--config", c)] if args.kernel == "dw" else
                    ["--steps", str(args.steps), "--route", args.route if side == "repo" else other_route]
                    + (["--field", args.field] if args.field else []))
             for side in sides}
    builds = [_build(side, ["fused_tc_bwd"] if args.kernel == "dw" else KERNELS) for side in sides.values()]
    if any(p.wait() != 0 for p in builds):
        raise RuntimeError("a side's kernels did not build")
    out_dir = REPO / "outputs" / "train_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    results = {side: {} for side in sides}
    names = list(sides)
    for r in range(args.rounds):
        for side in (names if r % 2 == 0 else names[::-1]):
            extra = ["--save", str(out_dir / f"{side}.pt")] if r == 0 else []
            row = json.loads(_run(sides[side], ["--turn", *flags[side], *extra]).stdout.splitlines()[-1])
            for k, v in row.items():
                if k not in ("sm_clock_temp_power", "route"):
                    results[side].setdefault(k, []).append(v)
            print(json.dumps({"round": r, "side": side, **row}), flush=True)
        if r == 0:
            repo = torch.load(out_dir / "repo.pt")
            for side in others:
                print(json.dumps({"side": side, "max_abs_diff_repo_vs_other": _max_diff(repo, torch.load(
                    out_dir / f"{side}.pt"))}), flush=True)

    summary = {side: {k: quartiles(v) for k, v in res.items()} for side, res in results.items()}
    print(json.dumps({"summary": summary, "card": nvidia_smi("name,power.limit")}), flush=True)
    return summary


if __name__ == "__main__":
    main()
