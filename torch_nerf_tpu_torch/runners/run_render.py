"""Rendering CLI: load a trained run, render novel views or test poses.

Counterpart of ``torch_nerf_tpu/runners/run_render.py`` with the same flags
plus ``--device`` (default: the CUDA card). Needs a ``--log-dir`` holding
``config.yaml`` (YAML or JSON) and ``ckpt/ckpt_<step>.pt``; renders the
dataset's novel-view orbit, or its test poses with ``--render-test-views``,
into numbered PNGs.

    python -m torch_nerf_tpu_torch.runners.run_render --log-dir RUN \
        --render-test-views --num-views 2 [--device cpu] [key=value ...]

A multi-scene run's checkpoint holds every scene: ``--scene N`` (default
0) renders scene N's parameters on scene N's test split
(``session.build_multiscene_dataset``). A scene out of range raises, as
``--scene`` other than 0 on a single-scene run does. Data-parallel
rendering comes with the parallelism slice and raises here.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from torch_nerf_tpu_torch import checkpoints, config as cfg_mod, multiscene, session
from torch_nerf_tpu_torch.device import resolve_device
from torch_nerf_tpu_torch.logging_utils import save_png
from torch_nerf_tpu_torch.renderer import render_image


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Render a trained NeRF.")
    parser.add_argument("--log-dir", required=True, help="training run directory")
    parser.add_argument("--out-dir", default=None, help="output PNG directory")
    parser.add_argument(
        "--render-test-views",
        action="store_true",
        help="render the dataset's poses instead of the novel-view path",
    )
    parser.add_argument("--num-views", type=int, default=None, help="cap rendered views")
    parser.add_argument(
        "--scene",
        type=int,
        default=0,
        help="for multi-scene runs (data.num_scenes > 1): which scene's parameters and test split to render",
    )
    parser.add_argument(
        "--device", default=None, help="cuda (default, the card) or cpu"
    )
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    log_dir = Path(args.log_dir)
    stored = log_dir / "config.yaml"
    if not stored.exists():
        raise FileNotFoundError(f"No stored config at {stored}; train first.")
    cfg = cfg_mod.load_config(stored)
    cfg_mod.apply_overrides(cfg, args.overrides)
    device = resolve_device(args.device or cfg.device.platform)

    if cfg.parallel.data_axis_size not in (-1, 1):
        raise NotImplementedError("data-parallel rendering comes with the port's parallel slice")
    num_scenes = cfg.data.num_scenes
    if not 0 <= args.scene < num_scenes:
        raise ValueError(f"--scene {args.scene} out of range for a {num_scenes}-scene run.")

    # like the reference render CLI, the TEST split at full resolution;
    # --render-test-views only switches which poses are rendered
    if num_scenes > 1:
        dataset = session.build_multiscene_dataset(cfg, args.scene, split="test", device=device)
    else:
        dataset = session.build_dataset(cfg, split="test", device=device)
    settings = session.build_render_settings(cfg, dataset)
    field = session.build_field(cfg)

    state = checkpoints.restore_latest(log_dir, device=device)
    if state is None:
        raise FileNotFoundError(f"No checkpoint found under {log_dir}/ckpt.")
    params = state["params"]
    if num_scenes > 1:
        if state.get("num_scenes") != num_scenes:
            raise ValueError(f"the checkpoint holds {state.get('num_scenes', 1)} scenes, "
                             f"not data.num_scenes={num_scenes}")
        params = multiscene.slice_scene(params, args.scene)
        print(f"Loaded scene {args.scene} of a {num_scenes}-scene checkpoint at step {state['step']}.")
    else:
        print(f"Loaded checkpoint at step {state['step']}.")

    poses = dataset.poses if args.render_test_views else dataset.render_poses
    if args.num_views is not None:
        poses = poses[: args.num_views]

    out_dir = Path(args.out_dir or (log_dir / "render"))
    out_dir.mkdir(parents=True, exist_ok=True)

    for i, pose in enumerate(poses):
        img = render_image(
            field,
            params["coarse"],
            params.get("fine"),
            dataset.camera,
            torch.as_tensor(pose, device=device),
            i,
            settings,
            chunk_size=cfg.renderer.num_pixels,
        )
        save_png(out_dir / f"{i:04d}.png", img.cpu().numpy())
        print(f"rendered view {i + 1}/{len(poses)}")

    print(f"Wrote {len(poses)} frames to {out_dir}.")


if __name__ == "__main__":
    main()
