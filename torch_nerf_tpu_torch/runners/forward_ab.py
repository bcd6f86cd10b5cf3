"""Time kernel 1 of two checkouts in turns, each through its own package.

``kernel_ab`` loads another version's library beside this package's, so
it needs this package's Python layer to lay out that version's weights.
Where the other version reads a layout this package no longer builds (the
``mma.sync`` forward that the general route replaced, with its weights in
64-point-tile fragment order), this runner times each side in a process
of its own, with that side's checkout root first on ``sys.path``: each
builds its own kernels from its own sources and launches its own
``fused_nerf_apply`` on its own ``prepare``d weights. At each config
(``FEAT:LEVEL[:DIR_LEVEL]``: feat_dim, coord_encode_level and
dir_encode_level (default 4) in bf16, ``...:f32`` in f32; ``--route R``
adds the config of ``R``'s path,
``train_profile.ROUTE_FIELDS``) it takes one launch at the coarse and at
the fine render chunk (4096 rays of an 800x800 view x 64 and x 192 sorted
depths, 262,144 and 786,432 points) by CUDA events, after its max-abs
error against the plain version one precision up (f32 on the bf16-rounded
weights; f64) and the route it took: each side's ``prepare`` picks its own
route for the config. Turns go other, repo, repo, other, ... Prints one
JSON line a turn with the SM clock, temperature and power after it, then
each side's median and quartiles and the card's ``nvidia-smi`` line.

    python -m torch_nerf_tpu_torch.runners.forward_ab --other-root DIR [--config 96:10] [--route R] [--rounds 2]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
# FEAT:LEVEL[:f32] of each route's path (train_profile.ROUTE_FIELDS)
ROUTE_SPECS = {"wgmma": "256:10", "wgmma_general": "512:12", "f32_wgmma": "256:10:f32", "wide": "1024:10",
               "f32_wide": "1024:10:f32"}
# a turn's process: this file loaded by path (importing it as part of the
# package would import this checkout's package), then :func:`turn`
_TURN = ("import importlib.util, sys; "
         "spec = importlib.util.spec_from_file_location('forward_ab_turn', sys.argv[1]); "
         "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
         "m.turn(sys.argv[2], sys.argv[3])")


def parse_spec(spec: str):
    """``FEAT:LEVEL[:DIR_LEVEL][:f32]`` -> ``(feat_dim, coord_encode_level,
    dir_encode_level (default 4), f32)``."""
    parts = spec.split(":")
    single = parts[-1] == "f32"
    parts = parts[:-1] if single else parts
    return int(parts[0]), int(parts[1]), int(parts[2]) if len(parts) > 2 else 4, single


def turn(root: str, configs: str) -> None:
    """One side's measurement, with ``root``'s package: prints one JSON
    line ``{config: {shape_ms, shape_max_abs_err, route}}``."""
    sys.path.insert(0, root)
    import torch  # noqa: PLC0415

    import torch_nerf_tpu_torch  # noqa: PLC0415
    from torch_nerf_tpu_torch import cameras  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415
    from torch_nerf_tpu_torch.models.nerf import init_nerf_params  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_nerf  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners.timing import event_ms  # noqa: PLC0415

    if not Path(torch_nerf_tpu_torch.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {torch_nerf_tpu_torch.__file__}, not the package under {root}")
    dev = torch.device("cuda")
    camera = cameras.CameraParams(960.0, 960.0, 800, 800)
    pose = torch.as_tensor(synthetic.split_poses(1, "train")[0], device=dev)
    o, d = cameras.rays_for_pixels(torch.arange(4096, device=dev), camera, pose)
    gen = torch.Generator(device=dev).manual_seed(5)
    chunks = {}
    for name, samples in (("coarse", 64), ("fine", 192)):
        t = torch.sort(2.0 + 4.0 * torch.rand((4096, samples), generator=gen, device=dev)).values
        pts = (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 3).contiguous()
        chunks[name] = (pts, d[:, None, :].expand(-1, samples, -1).reshape(-1, 3).contiguous())
    out = {}
    for spec in configs.split(","):
        feat, level, dir_level, single = parse_spec(spec)
        cfg = fused_nerf.FusedNeRFConfig(coord_encode_level=level, dir_encode_level=dir_level, feat_dim=feat,
                                         compute_dtype=torch.float32 if single else torch.bfloat16)
        params = init_nerf_params(torch.Generator(device=dev).manual_seed(0), cfg.pos_enc_dim, cfg.dir_enc_dim,
                                  feat, device=dev)
        up = torch.float64 if single else torch.float32
        rounded = {n: {k: v.to(cfg.compute_dtype).to(up) for k, v in p.items()} for n, p in params.items()}
        ref_cfg = dataclasses.replace(cfg, compute_dtype=up)
        w = fused_nerf.prepare(params, cfg)
        row = {"route": w.route}
        for name, (pts, dirs) in chunks.items():
            got = fused_nerf.fused_nerf_apply(w, pts, dirs, cfg)
            ref = fused_nerf.fused_nerf_apply_reference(rounded, pts.to(up), dirs.to(up), ref_cfg)
            row[f"{name}_max_abs_err"] = max((a - b).abs().max().item() for a, b in zip(got, ref))
            row[f"{name}_ms"] = event_ms(lambda: fused_nerf.fused_nerf_apply(w, pts, dirs, cfg), 20)
        out[spec] = row
    print(json.dumps(out), flush=True)


def main(argv=None) -> dict:
    from torch_nerf_tpu_torch.runners.timing import nvidia_smi, quartiles  # noqa: PLC0415

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other-root", required=True, help="the other checkout's root (e.g. from git archive)")
    parser.add_argument("--config", action="append", help="FEAT:LEVEL[:DIR_LEVEL] (bf16) or FEAT:LEVEL[:DIR_LEVEL]:f32 "
                                                          "(default: 96:10 and 512:12)")
    parser.add_argument("--route", action="append", choices=tuple(ROUTE_SPECS),
                        help="the config of the route's path (train_profile.ROUTE_FIELDS)")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    specs = (args.config or []) + [ROUTE_SPECS[r] for r in args.route or []]
    configs = ",".join(specs or ["96:10", "512:12"])
    roots = {"other": str(Path(args.other_root).resolve()), "repo": str(REPO_ROOT)}
    results = {side: {} for side in roots}
    for r in range(args.rounds):
        for side in (("other", "repo") if r % 2 == 0 else ("repo", "other")):
            proc = subprocess.run([sys.executable, "-c", _TURN, str(Path(__file__).resolve()), roots[side], configs],
                                  capture_output=True, text=True, cwd=roots[side])
            if proc.returncode != 0:
                raise RuntimeError(f"the {side} side's turn failed:\n{proc.stdout}\n{proc.stderr}")
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            for spec, values in row.items():
                for k, v in values.items():
                    if k != "route":
                        results[side].setdefault(f"{spec}/{k}", []).append(v)
            print(json.dumps({"round": r, "side": side, **row,
                              "sm_clock_temp_power": nvidia_smi("clocks.sm,temperature.gpu,power.draw")}), flush=True)
    summary = {side: {k: quartiles(v) for k, v in res.items()} for side, res in results.items()}
    print(json.dumps({"kernel": "fused_nerf_fwd", "summary": summary, "card": nvidia_smi("name,power.limit")}),
          flush=True)
    return summary


if __name__ == "__main__":
    main()
