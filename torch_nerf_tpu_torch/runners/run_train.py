"""Training CLI.

Counterpart of ``torch_nerf_tpu/runners/run_train.py``, with the same
flags plus ``--device`` (default: the CUDA card):

    python -m torch_nerf_tpu_torch.runners.run_train \\
        [--config default|path.yaml] [--log-dir DIR] [--max-steps N] \\
        [--profile-steps N] [--device cpu] [key=value overrides ...]

Epochs of ``num_views`` optimizer steps, center-crop pixel sampling for the
first 10 epochs; validation (PSNR/SSIM on the val split at full
resolution), a checkpoint and a visualisation every so many epochs, and a
checkpoint at the end; resume from the stored config and the latest
checkpoint in ``--log-dir`` (parameters, Adam's state and the schedule).
With ``occupancy.enabled=true`` the occupancy grid threads through every
step and is saved beside every checkpoint; a resume restores it from that
sidecar, or, where there is none, rebuilds it from the restored field by 8
sweeps with the seeds ``seed + 2 + sweep``.

``data.num_scenes`` > 1 trains that many scenes in one run
(``multiscene.py``: gaussian_blobs scenes seeded ``seed * 1000 + s``, or
the comma-separated Blender scenes of ``data.scene_name``): epochs of the
views a scene holds, the stacked state checkpointed at the single-scene
cadence, each scene's val view 0 scored as ``val/psnr_scene{s}``. On one
card the scenes train one after another within a step.

``--profile-steps N`` traces steps ``start + 10`` to ``start + 10 + N``
with ``torch.profiler`` into ``<log_dir>/profile/trace.json`` (a Chrome
trace, the port's spans among its events) and writes the port's spans of
those steps (``tracing``: name, parent, unit, thread, start and end in
Unix ns, each step's counters) to ``<log_dir>/profile/spans.jsonl``.

``--distributed`` runs one process per rank under torchrun (the
counterpart of the JAX CLI's ``jax.distributed.initialize()``):

    python -m torch.distributed.run --standalone --nproc_per_node=2 \\
        -m torch_nerf_tpu_torch.runners.run_train --distributed \\
        [--dist-backend nccl|gloo] [--device cpu] ...

A single-scene run trains data-parallel over the ranks
(``parallel.data_axis_size`` -1 or the world size;
``parallel.steps.make_sharded_image_train_step``); a multi-scene run trains
its scenes over the ranks (``make_multiscene_shard_step``), ``S %
ranks`` scenes left over raising. Rank r uses ``cuda:LOCAL_RANK %
device_count``; the backend defaults to ``nccl`` on the card and ``gloo``
on the CPU, and NCCL refuses ranks that share a card (``gloo`` takes them).
Validation and visualisation frames are rendered sharded over the ranks;
only rank 0 prints, logs, writes images and checkpoints (the whole state,
the file a single-process run writes and resumes). The model axis is not
trained by this CLI, as by the JAX one: ``parallel.model_axis_size`` other
than 1 raises.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from torch_nerf_tpu_torch import checkpoints, config as cfg_mod, lpips, metrics as metrics_mod
from torch_nerf_tpu_torch import multiscene, occupancy, session, tracing, train
from torch_nerf_tpu_torch.device import resolve_device
from torch_nerf_tpu_torch.logging_utils import MetricsLogger, StepTimer, save_png
from torch_nerf_tpu_torch.parallel import collectives, mesh as pmesh, steps as psteps
from torch_nerf_tpu_torch.renderer import render_image


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a NeRF or an Instant-NGP on one card.")
    parser.add_argument("--config", default="default", help="preset name or YAML/JSON path")
    parser.add_argument("--log-dir", default=None, help="output/resume directory")
    parser.add_argument("--max-steps", type=int, default=None, help="cap total steps (debug)")
    parser.add_argument("--profile-steps", type=int, default=0,
                        help="trace this many steps after the first 10 with torch.profiler into <log-dir>/profile")
    parser.add_argument("--distributed", action="store_true",
                        help="one process per rank under torchrun: data-parallel rays, or scenes over ranks")
    parser.add_argument("--dist-backend", choices=pmesh.BACKENDS, default=None,
                        help="the process group's backend (default: nccl on the card, gloo on the CPU)")
    parser.add_argument("--device", default=None, help="cuda (default, the card) or cpu")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    return parser.parse_args(argv)


def start_mesh(args, cfg):
    """The mesh of a ``--distributed`` run from torchrun's environment,
    else None."""
    if not args.distributed:
        return None
    return pmesh.init_mesh_from_env(backend=args.dist_backend, device=args.device or cfg.device.platform)


class _NullLogger:
    """The metrics logger of a rank that does not write."""

    def log_scalars(self, step, scalars) -> None:
        pass

    def log_image(self, step, tag, image) -> None:
        pass

    def close(self) -> None:
        pass


def main(argv=None) -> dict:
    """Train; returns ``{"step", "losses", "log_dir", "metrics"}``,
    ``losses`` the total loss of every step this call ran and ``metrics``
    the last step's (its loss terms: ``coarse_loss``, ``fine_loss``,
    ``aux_loss`` where the run has them), as floats. A multi-scene run's
    ``losses`` are the scenes' mean, its ``metrics`` hold a list of the
    scenes' values a term, and ``"scene_losses"`` holds each scene's total
    loss of every step."""
    args = parse_args(argv)
    log_dir = Path(args.log_dir or f"outputs/{time.strftime('%Y-%m-%d/%H-%M-%S')}")
    stored_cfg = log_dir / "config.yaml"
    if stored_cfg.exists():
        # resume: reload the run's own stored config
        cfg = cfg_mod.load_config(stored_cfg)
        cfg_mod.apply_overrides(cfg, args.overrides)
    else:
        cfg = cfg_mod.resolve(args.config, args.overrides)
    # every rank has read the stored config once the group has formed,
    # before rank 0 writes it
    mesh = start_mesh(args, cfg)
    pmesh.check_parallel(cfg, mesh)
    device = mesh.device if mesh is not None else resolve_device(args.device or cfg.device.platform)
    # a config the card's training kernels cannot take fails here, before
    # the run directory is written and any data loads
    session.check_trainable(cfg, device)
    cfg.log_dir = str(log_dir)
    main_rank = mesh is None or mesh.rank == 0
    if main_rank:
        log_dir.mkdir(parents=True, exist_ok=True)
        cfg_mod.save_config(cfg, stored_cfg)
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(sys.stdout if main_rank else quiet):
        run = _run_multiscene if cfg.data.num_scenes > 1 else _run_single
        result = run(cfg, args, log_dir, device, mesh)
    pmesh.destroy_mesh()
    return result


def _run_single(cfg, args, log_dir: Path, device, mesh) -> dict:
    dataset = session.build_dataset(cfg, split=cfg.data.data_type, device=device)
    settings = session.build_render_settings(cfg, dataset)
    field = session.build_field(cfg)
    optim_cfg = session.build_optim_config(cfg)
    aux_loss_fn = session.build_aux_loss(cfg)
    occ_cfg = session.build_occupancy_cfg(cfg)

    state = train.create_train_state(
        torch.Generator(device=device).manual_seed(cfg.seed), field, settings, optim_cfg, device
    )
    ckpt_path = checkpoints.latest_checkpoint(log_dir)
    restored = checkpoints.load_checkpoint(ckpt_path, device) if ckpt_path else None
    if restored is not None:
        _restore(state, restored)
    if mesh is not None:
        state = pmesh.place_state(mesh, state, optim_cfg)
        print(f"Data-parallel training over {mesh.world_size} ranks ({mesh.backend}).")

    grid = None
    if occ_cfg is not None:
        grid = occupancy.init_grid(occ_cfg, device)
        if restored is not None and state.step > 0:
            saved_grid = checkpoints.load_occupancy_grid(ckpt_path, device)
            if saved_grid is not None:
                grid = saved_grid
            else:
                # a checkpoint without the sidecar: sweeps of the restored
                # field, so that a resume past warmup never prunes by an
                # empty grid
                density = occupancy.make_density_fn(field)
                for sweep in range(8):
                    gen = torch.Generator(device=device).manual_seed(cfg.seed + 2 + sweep)
                    grid = occupancy.update_grid(grid, density, state.params, occupancy.draw_jitter(gen, occ_cfg),
                                                 occ_cfg)

    camera = dataset.camera
    images = torch.as_tensor(dataset.flat_images(), device=device)
    poses = torch.as_tensor(dataset.poses, device=device)
    steps_per_epoch = max(1, dataset.num_views)
    num_epochs = max(1, optim_cfg.num_iter // steps_per_epoch)
    total_steps = num_epochs * steps_per_epoch
    if args.max_steps is not None:
        total_steps = min(total_steps, args.max_steps)

    if mesh is None:
        steps = {precrop: train.make_image_train_step(field, settings, optim_cfg, camera, cfg.renderer.num_pixels,
                                                      precrop=precrop, aux_loss_fn=aux_loss_fn,
                                                      occupancy_cfg=occ_cfg)
                 for precrop in (True, False)}
    else:
        steps = {precrop: psteps.make_sharded_image_train_step(field, settings, optim_cfg, camera, mesh,
                                                               cfg.renderer.num_pixels, precrop=precrop,
                                                               aux_loss_fn=aux_loss_fn, occupancy_cfg=occ_cfg)
                 for precrop in (True, False)}
    render = _frame_renderer(field, settings, cfg, mesh)
    main_rank = mesh is None or mesh.rank == 0
    logger = MetricsLogger(log_dir) if main_rank else _NullLogger()
    timer = StepTimer(
        rays_per_step=cfg.renderer.num_pixels,
        flops_per_step=session.estimate_flops_per_step(cfg),
        device=device,
    )
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    val_cfg = cfg.train_params.validation
    log_cfg = cfg.train_params.log

    # validation on the val split at full resolution, like the reference
    val_dataset = None
    if val_cfg.validate_every > 0:
        try:
            val_dataset = session.build_dataset(cfg, split="val", device=device)
        except (FileNotFoundError, ValueError) as exc:
            print(f"validation disabled: no val split ({exc})")

    profiler = StepProfiler(log_dir, state.step, args.profile_steps if main_rank else 0, device)
    losses, metrics = [], {}
    for step_idx in range(state.step, total_steps):
        epoch = step_idx // steps_per_epoch
        profiler.before(step_idx)
        if grid is not None:
            state, grid, metrics = steps[epoch < 10](state, grid, images, poses, generator)
        else:
            state, metrics = steps[epoch < 10](state, images, poses, generator)
        profiler.after(step_idx)
        losses.append(metrics["loss"])
        _log_progress(logger, timer, step_idx + 1, total_steps,
                      lambda: {f"train/{k}": float(v) for k, v in metrics.items()})

        if (step_idx + 1) % steps_per_epoch == 0:
            epoch_done = (step_idx + 1) // steps_per_epoch
            if epoch_done % log_cfg.epoch_btw_ckpt == 0:
                _save(log_dir, state, grid, mesh=mesh)
            if val_dataset is not None and epoch_done % val_cfg.validate_every == 0:
                _validate(cfg, render, state, val_dataset, logger, step_idx + 1, device, main_rank)
            if epoch_done % log_cfg.epoch_btw_vis == 0:
                _visualize(render, state, camera, dataset, log_dir, epoch_done, device, main_rank)

    profiler.close()
    _save(log_dir, state, grid, mesh=mesh)
    logger.close()
    print(f"Training complete at step {state.step}. Logs in {log_dir}.")
    return {"step": state.step, "losses": [float(v) for v in losses], "log_dir": str(log_dir),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _log_progress(logger, timer, step: int, total_steps: int, scalars_fn) -> None:
    """After a step: every 100th, ``scalars_fn()`` (read then, so that no
    other step waits for the card) with the timer's rates, logged and
    printed; else the rates alone, where the timer's window ends."""
    perf = timer.tick()
    if step % 100 == 0:
        scalars = scalars_fn()
        if perf:
            scalars.update(perf)
        logger.log_scalars(step, scalars)
        print(f"step {step}/{total_steps} " + " ".join(f"{k.split('/')[-1]}={v:.5f}" for k, v in scalars.items()))
    elif perf:
        logger.log_scalars(step, perf)


class StepProfiler:
    """``--profile-steps N``: ``torch.profiler`` (CPU activity, and CUDA on
    the card) over the steps ``start + 10`` to ``start + 10 + N``, the JAX
    CLI's window after compilation and warm-up, its Chrome trace written to
    ``<log_dir>/profile/trace.json`` and the port's spans of the window
    (``tracing``, on while the profiler records) to
    ``<log_dir>/profile/spans.jsonl`` when the window ends (or the run
    does, inside it). Does nothing for N = 0."""

    def __init__(self, log_dir, start_step: int, num_steps: int, device: torch.device):
        self.dir = Path(log_dir) / "profile"
        self.first = start_step + 10 if num_steps > 0 else -1
        self.last = self.first + num_steps - 1
        self.device = device
        self.prof = None

    def before(self, step_idx: int) -> None:
        if step_idx == self.first:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            tracing.clear()
            self.prof.start()

    def after(self, step_idx: int) -> None:
        if step_idx == self.last:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.dir / "trace.json"))
        tracing.dump(self.dir / "spans.jsonl")
        self.prof = None
        print(f"profiler trace written to {self.dir}")


def _restore(state: train.TrainState, restored: dict) -> None:
    """Load a checkpoint into ``state``: its params, Adam's state and the
    schedule's where saved, and its step."""
    with torch.no_grad():
        for leaf, saved in zip(train.parameter_list(state.params), train.parameter_list(restored["params"])):
            leaf.copy_(saved)
    if "optimizer" in restored:
        state.optimizer.load_state_dict(restored["optimizer"])
        state.scheduler.load_state_dict(restored["scheduler"])
    state.step = restored["step"]
    print(f"Resumed from step {state.step}.")


def _save(log_dir, state: train.TrainState, grid, num_scenes=None, mesh=None) -> None:
    """Checkpoint the state; a sharded state gathered whole first, written
    by rank 0 (scenes over ranks: along the scene axis of every leaf)."""
    params, optimizer = state.params, state.optimizer
    if mesh is not None:
        spec = pmesh.scene_spec(params) if num_scenes is not None else None
        params, optimizer = pmesh.gather_state(mesh, state, spec, "data" if num_scenes is not None else "model")
        if mesh.rank != 0:
            return
    checkpoints.save_checkpoint(log_dir, state.step, params, optimizer, state.scheduler, occ_grid=grid,
                                num_scenes=num_scenes)


def _frame_renderer(field, settings, cfg, mesh):
    """``render(params, camera, pose, seed) -> (H, W, 3)``: ``render_image``,
    or under ``--distributed`` the frame sharded over the ranks (every rank
    calls it)."""
    chunk = cfg.renderer.num_pixels
    if mesh is None:
        return lambda params, camera, pose, seed: render_image(field, params["coarse"], params.get("fine"), camera,
                                                               pose, seed, settings, chunk_size=chunk)

    def render(params, camera, pose, seed):
        frame = psteps.make_sharded_render(field, settings, mesh, camera, chunk)
        return frame(params["coarse"], params.get("fine"), pose, seed)

    return render


def _validate(cfg, render, state, dataset, logger, step, device, main_rank=True) -> None:
    """Full-image validation on the val split at full resolution:
    PSNR/SSIM, and LPIPS where calibrated weights are found; view 0's
    prediction beside its ground truth as the ``val/pred_vs_gt`` image."""
    num_batch = min(cfg.train_params.validation.num_batch, dataset.num_views)
    lpips_weights = lpips.load_weights()
    psnrs, ssims, lpipss = [], [], []
    for view in range(num_batch):
        img = render(state.params, dataset.camera, torch.as_tensor(dataset.poses[view], device=device), view)
        if not main_rank:
            continue
        pred = np.clip(img.cpu().numpy(), 0.0, 1.0)
        gt = dataset.images[view]
        psnrs.append(metrics_mod.psnr(pred, gt, device=device))
        ssims.append(metrics_mod.ssim(pred, gt, device=device))
        if lpips_weights is not None:
            lpipss.append(lpips.lpips_alex(pred, gt, lpips_weights, device=device))
        if view == 0:
            # pred | gt side by side, as the reference logs to TensorBoard
            logger.log_image(step, "val/pred_vs_gt", np.concatenate([pred, gt], axis=1))
    if not main_rank:
        return
    scalars = {"val/psnr": float(np.mean(psnrs)), "val/ssim": float(np.mean(ssims))}
    if lpipss:
        scalars["val/lpips"] = float(np.mean(lpipss))
    logger.log_scalars(step, scalars)
    print(f"validation @ step {step}: " + " ".join(f"{k.split('/')[-1]}={v:.4f}" for k, v in scalars.items()))


def _visualize(render, state, camera, dataset, log_dir, epoch, device, main_rank=True) -> None:
    """Render one novel view into ``vis/epoch_N/pred_imgs/``."""
    img = render(state.params, camera, torch.as_tensor(dataset.render_poses[0], device=device), 0)
    if main_rank:
        vis_dir = Path(log_dir) / "vis" / f"epoch_{epoch}" / "pred_imgs"
        vis_dir.mkdir(parents=True, exist_ok=True)
        save_png(vis_dir / "view_000.png", img.cpu().numpy())


def _multiscene_split(cfg, split: str, device, scenes=None):
    """The ``split`` of every scene in ``scenes`` (default: all) stacked:
    ``(images (S, V, H*W, 3), poses (S, V, 4, 4))`` on ``device``, and the
    camera the scenes share."""
    scenes = range(cfg.data.num_scenes) if scenes is None else scenes
    sets = [session.build_multiscene_dataset(cfg, s, split, device=device) for s in scenes]
    camera = sets[0].camera
    for d in sets[1:]:
        if d.camera != camera:
            raise ValueError(
                "Multi-scene batching stacks scene pools into one array, so all scenes must share camera "
                f"intrinsics; got {d.camera} vs {camera}."
            )
        if d.images.shape != sets[0].images.shape:
            raise ValueError(
                f"All scenes must have equal view counts/resolutions to stack; got {d.images.shape} vs "
                f"{sets[0].images.shape}."
            )
    images = torch.as_tensor(np.stack([d.flat_images() for d in sets]), device=device)
    poses = torch.as_tensor(np.stack([d.poses for d in sets]), device=device)
    return images, poses, camera


def _run_multiscene(cfg, args, log_dir: Path, device, mesh=None) -> dict:
    """``data.num_scenes`` scenes in one run (``multiscene.py``), after the
    JAX CLI's ``_run_multiscene``: both splits stacked, epochs of the views
    a scene holds with the center crop for the first 10, ``train/loss_scene{s}``
    every 100 steps, the stacked state checkpointed at the single-scene
    cadence, per-scene validation. Scene s's parameters are drawn from
    ``scene_seed(seed, s)`` and its batches from ``scene_seed(seed + 1, s)``.
    As in the JAX package, no aux loss and no occupancy grid is threaded.
    Under ``--distributed`` each rank loads and trains its share of the
    scenes (``parallel.steps.local_scenes``) and validates them."""
    num_scenes = cfg.data.num_scenes
    unused = [key for key, on in (("objective.encode_smoothness_weight", cfg.objective.encode_smoothness_weight > 0),
                                  ("occupancy.enabled", cfg.occupancy.enabled)) if on]
    if unused:
        print(f"{' and '.join(unused)}: not used by a multi-scene run")
    scenes = range(num_scenes) if mesh is None else psteps.local_scenes(mesh, num_scenes)
    images, poses, camera = _multiscene_split(cfg, "train", device, scenes)
    val_cfg = cfg.train_params.validation
    val = _multiscene_split(cfg, "val", device, scenes) if val_cfg.validate_every > 0 else None

    settings = session.build_render_settings(cfg)
    field = session.build_field(cfg)
    optim_cfg = session.build_optim_config(cfg)
    state = multiscene.create_multiscene_state(multiscene.scene_generators(cfg.seed, num_scenes, device), field,
                                               settings, optim_cfg, num_scenes, device)
    restored = checkpoints.restore_latest(log_dir, device)
    if restored is not None:
        if restored.get("num_scenes") != num_scenes:
            raise ValueError(f"the checkpoint in {log_dir} holds {restored.get('num_scenes', 1)} scenes, "
                             f"not data.num_scenes={num_scenes}")
        _restore(state, restored)
    generators = multiscene.scene_generators(cfg.seed + 1, num_scenes, device)[scenes.start:scenes.stop]
    if mesh is None:
        steps = {precrop: multiscene.make_multiscene_train_step(field, settings, optim_cfg, camera, num_scenes,
                                                                cfg.renderer.num_pixels, precrop=precrop)
                 for precrop in (True, False)}
    else:
        state = pmesh.place_state(mesh, state, optim_cfg, pmesh.scene_spec(state.params), "data")
        steps = {precrop: psteps.make_multiscene_shard_step(field, settings, optim_cfg, camera, num_scenes, mesh,
                                                            cfg.renderer.num_pixels, precrop=precrop)
                 for precrop in (True, False)}
        print(f"Training {num_scenes} scenes over {mesh.world_size} ranks ({mesh.backend}).")
    main_rank = mesh is None or mesh.rank == 0
    logger = MetricsLogger(log_dir) if main_rank else _NullLogger()
    timer = StepTimer(rays_per_step=cfg.renderer.num_pixels * num_scenes, device=device)
    log_cfg = cfg.train_params.log
    steps_per_epoch = max(1, images.shape[1])  # views per scene
    total_steps = max(1, optim_cfg.num_iter // steps_per_epoch) * steps_per_epoch
    if args.max_steps is not None:
        total_steps = min(total_steps, args.max_steps)

    profiler = StepProfiler(log_dir, state.step, args.profile_steps if main_rank else 0, device)
    losses, scene_losses, metrics = [], [], {}
    for step_idx in range(state.step, total_steps):
        epoch = step_idx // steps_per_epoch
        profiler.before(step_idx)
        state, metrics = steps[epoch < 10](state, images, poses, generators)
        profiler.after(step_idx)
        losses.append(metrics["loss"])
        scene_losses.append(sum(metrics[k] for k in ("coarse_loss", "fine_loss") if k in metrics))
        _log_progress(logger, timer, step_idx + 1, total_steps, lambda: {
            "train/loss": float(metrics["loss"]),
            **{f"train/loss_scene{s}": v for s, v in enumerate(metrics["coarse_loss"].tolist())}})

        if (step_idx + 1) % steps_per_epoch == 0:
            epoch_done = (step_idx + 1) // steps_per_epoch
            if epoch_done % log_cfg.epoch_btw_ckpt == 0:
                _save(log_dir, state, None, num_scenes, mesh)
            if val is not None and epoch_done % val_cfg.validate_every == 0:
                _validate_multiscene(cfg, field, state, *val, settings, logger, step_idx + 1, device, scenes, mesh)

    profiler.close()
    _save(log_dir, state, None, num_scenes, mesh)
    logger.close()
    print(f"Training complete at step {state.step}. Logs in {log_dir}.")
    per_scene = torch.stack(scene_losses).T.tolist() if scene_losses else [[] for _ in range(num_scenes)]
    return {"step": state.step, "losses": [float(v) for v in losses], "scene_losses": per_scene,
            "log_dir": str(log_dir), "metrics": {k: v.tolist() for k, v in metrics.items()}}


def _validate_multiscene(cfg, field, state, val_images, val_poses, camera, settings, logger, step, device,
                         scenes, mesh=None) -> None:
    """Each scene's val view 0 at full resolution, rendered with seed s
    (under ``--distributed`` by the rank that trains it):
    ``val/psnr_scene{s}`` and their mean ``val/psnr``."""
    psnrs = []
    for i, s in enumerate(scenes):
        params = multiscene.scene_params(state, i)
        img = render_image(field, params["coarse"], params.get("fine"), camera, val_poses[i, 0], s, settings,
                           chunk_size=cfg.renderer.num_pixels)
        pred = np.clip(img.cpu().numpy(), 0.0, 1.0)
        gt = val_images[i, 0].reshape(pred.shape)
        psnrs.append(metrics_mod.psnr(pred, gt, device=device))
    if mesh is not None:
        psnrs = collectives.all_gather(torch.tensor(psnrs, dtype=torch.float64, device=device),
                                       mesh.data_group).tolist()
    scalars = {f"val/psnr_scene{s}": v for s, v in enumerate(psnrs)}
    scalars["val/psnr"] = float(np.mean(psnrs))
    logger.log_scalars(step, scalars)
    print(f"validation @ step {step}: " + " ".join(f"{k.split('/')[-1]}={v:.3f}" for k, v in scalars.items()))


if __name__ == "__main__":
    main()
