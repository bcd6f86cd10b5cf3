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
``--scene`` other than 0 on a single-scene run does.

``--distributed`` renders each frame data-parallel under torchrun (the
JAX CLI's sharded render): every rank renders its rows of each chunk
(``parallel.steps.make_sharded_render``), the frame is gathered, and rank
0 writes the PNGs, the same frames ``render_image`` gives.

    python -m torch.distributed.run --standalone --nproc_per_node=2 \\
        -m torch_nerf_tpu_torch.runners.run_render --distributed --log-dir RUN ...
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from pathlib import Path

import torch

from torch_nerf_tpu_torch import checkpoints, config as cfg_mod, multiscene, session
from torch_nerf_tpu_torch.device import resolve_device
from torch_nerf_tpu_torch.logging_utils import save_png
from torch_nerf_tpu_torch.parallel import mesh as pmesh
from torch_nerf_tpu_torch.parallel.steps import make_sharded_render
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
    parser.add_argument("--distributed", action="store_true",
                        help="one process per rank under torchrun: each frame's rays sharded over the ranks")
    parser.add_argument("--dist-backend", choices=pmesh.BACKENDS, default=None,
                        help="the process group's backend (default: nccl on the card, gloo on the CPU)")
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
    mesh = None
    if args.distributed:
        mesh = pmesh.init_mesh_from_env(backend=args.dist_backend, device=args.device or cfg.device.platform)
    pmesh.check_parallel(cfg, mesh)
    main_rank = mesh is None or mesh.rank == 0
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(sys.stdout if main_rank else quiet):
        _render(args, cfg, log_dir, mesh)
    pmesh.destroy_mesh()


def _render(args, cfg, log_dir: Path, mesh) -> None:
    device = mesh.device if mesh is not None else resolve_device(args.device or cfg.device.platform)
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
    main_rank = mesh is None or mesh.rank == 0
    if main_rank:
        out_dir.mkdir(parents=True, exist_ok=True)
    sharded = None
    if mesh is not None:
        sharded = make_sharded_render(field, settings, mesh, dataset.camera, cfg.renderer.num_pixels)
        print(f"Rendering data-parallel over {mesh.world_size} ranks ({mesh.backend}).")

    for i, pose in enumerate(poses):
        pose = torch.as_tensor(pose, device=device)
        if sharded is not None:
            img = sharded(params["coarse"], params.get("fine"), pose, i)
        else:
            img = render_image(field, params["coarse"], params.get("fine"), dataset.camera, pose, i, settings,
                               chunk_size=cfg.renderer.num_pixels)
        if main_rank:
            save_png(out_dir / f"{i:04d}.png", img.cpu().numpy())
        print(f"rendered view {i + 1}/{len(poses)}")

    print(f"Wrote {len(poses)} frames to {out_dir}.")


if __name__ == "__main__":
    main()
