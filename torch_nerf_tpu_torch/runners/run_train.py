"""Training CLI.

Counterpart of ``torch_nerf_tpu/runners/run_train.py:56-238`` for one
scene, with the same flags plus ``--device`` (default: the CUDA card):

    python -m torch_nerf_tpu_torch.runners.run_train \\
        [--config default|path.yaml] [--log-dir DIR] [--max-steps N] \\
        [--device cpu] [key=value overrides ...]

Epochs of ``num_views`` optimizer steps, center-crop pixel sampling for the
first 10 epochs; validation (PSNR/SSIM on the val split at full
resolution), a checkpoint and a visualisation every so many epochs, and a
checkpoint at the end; resume from the stored config and the latest
checkpoint in ``--log-dir`` (parameters, Adam's state and the schedule).
Multi-scene runs, data-parallel training, ``--distributed`` and
``--profile-steps`` come with later slices and raise here.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from torch_nerf_tpu_torch import checkpoints, config as cfg_mod, metrics as metrics_mod
from torch_nerf_tpu_torch import session, train
from torch_nerf_tpu_torch.device import resolve_device
from torch_nerf_tpu_torch.logging_utils import MetricsLogger, StepTimer, save_png
from torch_nerf_tpu_torch.renderer import render_image


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a NeRF or an Instant-NGP on one card.")
    parser.add_argument("--config", default="default", help="preset name or YAML/JSON path")
    parser.add_argument("--log-dir", default=None, help="output/resume directory")
    parser.add_argument("--max-steps", type=int, default=None, help="cap total steps (debug)")
    parser.add_argument("--profile-steps", type=int, default=0, help="not in this slice")
    parser.add_argument("--distributed", action="store_true", help="not in this slice")
    parser.add_argument("--device", default=None, help="cuda (default, the card) or cpu")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    return parser.parse_args(argv)


def _check_supported(cfg, args) -> None:
    if args.distributed:
        raise NotImplementedError("--distributed comes with the port's parallelism slice")
    if args.profile_steps > 0:
        raise NotImplementedError("--profile-steps comes with the port's profiling work (a later slice)")
    if cfg.data.num_scenes > 1:
        raise NotImplementedError("multi-scene training comes with the port's multi-scene slice")
    if cfg.parallel.data_axis_size not in (-1, 1):
        raise NotImplementedError("data-parallel training comes with the port's parallelism slice")
    if cfg.occupancy.enabled:
        raise NotImplementedError("occupancy pruning comes with the port's occupancy slice")


def main(argv=None) -> dict:
    """Train; returns ``{"step", "losses", "log_dir"}``, ``losses`` the
    total loss of every step this call ran."""
    args = parse_args(argv)
    log_dir = Path(args.log_dir or f"outputs/{time.strftime('%Y-%m-%d/%H-%M-%S')}")
    stored_cfg = log_dir / "config.yaml"
    if stored_cfg.exists():
        # resume: reload the run's own stored config
        cfg = cfg_mod.load_config(stored_cfg)
        cfg_mod.apply_overrides(cfg, args.overrides)
    else:
        cfg = cfg_mod.resolve(args.config, args.overrides)
    _check_supported(cfg, args)
    device = resolve_device(args.device or cfg.device.platform)
    cfg.log_dir = str(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    cfg_mod.save_config(cfg, stored_cfg)

    dataset = session.build_dataset(cfg, split=cfg.data.data_type, device=device)
    settings = session.build_render_settings(cfg, dataset)
    field = session.build_field(cfg)
    optim_cfg = session.build_optim_config(cfg)
    aux_loss_fn = session.build_aux_loss(cfg)

    state = train.create_train_state(
        torch.Generator(device=device).manual_seed(cfg.seed), field, settings, optim_cfg, device
    )
    restored = checkpoints.restore_latest(log_dir, device=device)
    if restored is not None:
        with torch.no_grad():
            for leaf, saved in zip(train.parameter_list(state.params), train.parameter_list(restored["params"])):
                leaf.copy_(saved)
        if "optimizer" in restored:
            state.optimizer.load_state_dict(restored["optimizer"])
            state.scheduler.load_state_dict(restored["scheduler"])
        state.step = restored["step"]
        print(f"Resumed from step {state.step}.")

    camera = dataset.camera
    images = torch.as_tensor(dataset.flat_images(), device=device)
    poses = torch.as_tensor(dataset.poses, device=device)
    steps_per_epoch = max(1, dataset.num_views)
    num_epochs = max(1, optim_cfg.num_iter // steps_per_epoch)
    total_steps = num_epochs * steps_per_epoch
    if args.max_steps is not None:
        total_steps = min(total_steps, args.max_steps)

    steps = {
        precrop: train.make_image_train_step(
            field, settings, optim_cfg, camera, cfg.renderer.num_pixels, precrop=precrop,
            aux_loss_fn=aux_loss_fn,
        )
        for precrop in (True, False)
    }
    logger = MetricsLogger(log_dir)
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

    losses = []
    for step_idx in range(state.step, total_steps):
        epoch = step_idx // steps_per_epoch
        state, metrics = steps[epoch < 10](state, images, poses, generator)
        losses.append(metrics["loss"])

        perf = timer.tick()
        if (step_idx + 1) % 100 == 0:
            scalars = {f"train/{k}": float(v) for k, v in metrics.items()}
            if perf:
                scalars.update(perf)
            logger.log_scalars(step_idx + 1, scalars)
            print(
                f"step {step_idx + 1}/{total_steps} "
                + " ".join(f"{k.split('/')[-1]}={v:.5f}" for k, v in scalars.items())
            )
        elif perf:
            logger.log_scalars(step_idx + 1, perf)

        if (step_idx + 1) % steps_per_epoch == 0:
            epoch_done = (step_idx + 1) // steps_per_epoch
            if epoch_done % log_cfg.epoch_btw_ckpt == 0:
                _save(log_dir, state)
            if val_dataset is not None and epoch_done % val_cfg.validate_every == 0:
                _validate(cfg, field, state, val_dataset, settings, logger, step_idx + 1, device)
            if epoch_done % log_cfg.epoch_btw_vis == 0:
                _visualize(cfg, field, state, camera, dataset, settings, log_dir, epoch_done, device)

    _save(log_dir, state)
    logger.close()
    print(f"Training complete at step {state.step}. Logs in {log_dir}.")
    return {"step": state.step, "losses": [float(v) for v in losses], "log_dir": str(log_dir)}


def _save(log_dir, state: train.TrainState) -> None:
    checkpoints.save_checkpoint(log_dir, state.step, state.params, state.optimizer, state.scheduler)


def _validate(cfg, field, state, dataset, settings, logger, step, device) -> None:
    """Full-image validation on the val split at full resolution:
    PSNR/SSIM (LPIPS needs pretrained weights the repository does not
    hold)."""
    num_batch = min(cfg.train_params.validation.num_batch, dataset.num_views)
    psnrs, ssims = [], []
    for view in range(num_batch):
        img = render_image(
            field, state.params["coarse"], state.params.get("fine"), dataset.camera,
            torch.as_tensor(dataset.poses[view], device=device), view, settings,
            chunk_size=cfg.renderer.num_pixels,
        )
        pred = np.clip(img.cpu().numpy(), 0.0, 1.0)
        gt = dataset.images[view]
        psnrs.append(metrics_mod.psnr(pred, gt, device=device))
        ssims.append(metrics_mod.ssim(pred, gt, device=device))
    scalars = {"val/psnr": float(np.mean(psnrs)), "val/ssim": float(np.mean(ssims))}
    logger.log_scalars(step, scalars)
    print(f"validation @ step {step}: " + " ".join(f"{k.split('/')[-1]}={v:.4f}" for k, v in scalars.items()))


def _visualize(cfg, field, state, camera, dataset, settings, log_dir, epoch, device) -> None:
    """Render one novel view into ``vis/epoch_N/pred_imgs/``."""
    vis_dir = Path(log_dir) / "vis" / f"epoch_{epoch}" / "pred_imgs"
    vis_dir.mkdir(parents=True, exist_ok=True)
    img = render_image(
        field, state.params["coarse"], state.params.get("fine"), camera,
        torch.as_tensor(dataset.render_poses[0], device=device), 0, settings,
        chunk_size=cfg.renderer.num_pixels,
    )
    save_png(vis_dir / "view_000.png", img.cpu().numpy())


if __name__ == "__main__":
    main()
