"""Training: optimizer, schedule, loss and the train steps.

Counterpart of ``torch_nerf_tpu/train.py:35-231`` and ``:405-623``, without
the occupancy-pruned and auxiliary-loss branches (later slices). Adam with
``lr(t) = init_lr * (end_lr / init_lr)^(t / num_iter)``, stepped once per
iteration (``ExponentialLR``), and L2 weight decay on hash tables where
asked for; the loss is coarse MSE + fine MSE summed before one backward.

A field with a ``fused_cfg`` trains through the fused train pass
(``ops/fused_train.py``: each render pass with its loss gradient in one
kernel call); ``force_generic=True`` or a field without one trains by
autograd through ``field.apply`` (for the fused field, the forward and
backward kernels of ``ops/fused_nerf.py``).

Randomness is explicit: every draw of a step comes from a
``torch.Generator`` through a ``*_from_uniforms`` core, or is handed in, so
the tests feed the port and the JAX package the same numbers. A step updates
the :class:`TrainState` in place (parameters, Adam moments, schedule) and
returns it with the step's metrics as tensors on the device; reading them
is the caller's synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torch_nerf_tpu_torch import cameras
from torch_nerf_tpu_torch.fields import Field
from torch_nerf_tpu_torch.models.nerf import Params
from torch_nerf_tpu_torch.ops import sampling
from torch_nerf_tpu_torch.ops.fused_train import fused_train_pass
from torch_nerf_tpu_torch.renderer import RayUniforms, RenderSettings, draw_uniforms, render_rays


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Mirrors ``configs/train_params/nerf.yaml:1-8``. ``table_weight_decay``
    (no reference counterpart, 0 by default) adds ``wd * p`` to the
    gradient of every leaf under a ``"tables"`` key before Adam."""

    num_iter: int = 300_000
    init_lr: float = 5.0e-4
    end_lr: float = 5.0e-5
    eps: float = 1.0e-8
    table_weight_decay: float = 0.0


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, Params]  # {"coarse": tree} or {"coarse": ..., "fine": ...}
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler


def parameter_list(params: Dict[str, Any]) -> list:
    """The leaves of a parameter tree in a fixed order (sorted keys), the
    order the optimizer's state is saved and restored in."""
    if isinstance(params, dict):
        return [leaf for key in sorted(params) for leaf in parameter_list(params[key])]
    return [params]


def table_flags(params: Dict[str, Any], is_table: bool = False) -> list:
    """For each leaf in :func:`parameter_list` order, whether it lies under
    a ``"tables"`` key."""
    if isinstance(params, dict):
        return [f for key in sorted(params) for f in table_flags(params[key], is_table or key == "tables")]
    return [is_table]


def make_optimizer(params: Dict[str, Any], cfg: OptimConfig) -> torch.optim.Adam:
    """Adam (betas 0.9/0.999, eps outside the sqrt, bias correction), as
    ``optax.adam`` and the reference's ``torch.optim.Adam``. With
    ``table_weight_decay`` > 0, Adam's ``weight_decay`` (``wd * p`` added to
    the gradient before the moments: optax's ``chain(masked(
    add_decayed_weights), adam)``) on the hash-table leaves only, in
    parameter groups of consecutive leaves that keep
    :func:`parameter_list`'s order, and with it the optimizer state's."""
    leaves = parameter_list(params)
    if cfg.table_weight_decay <= 0.0:
        return torch.optim.Adam(leaves, lr=cfg.init_lr, eps=cfg.eps)
    groups = []
    for leaf, is_table in zip(leaves, table_flags(params)):
        decay = cfg.table_weight_decay if is_table else 0.0
        if not groups or groups[-1]["weight_decay"] != decay:
            groups.append({"params": [], "weight_decay": decay})
        groups[-1]["params"].append(leaf)
    return torch.optim.Adam(groups, lr=cfg.init_lr, eps=cfg.eps)


def lr_schedule(optimizer: torch.optim.Optimizer, cfg: OptimConfig) -> torch.optim.lr_scheduler.ExponentialLR:
    """Exponential decay from init_lr to end_lr over num_iter steps: torch
    ``ExponentialLR(gamma=(end/init)^(1/num_iter))`` stepped once per
    optimizer step (``train.py:58-67``)."""
    gamma = (cfg.end_lr / cfg.init_lr) ** (1.0 / cfg.num_iter)
    return torch.optim.lr_scheduler.ExponentialLR(optimizer, gamma=gamma)


def create_train_state(
    generator: torch.Generator,
    field: Field,
    settings: RenderSettings,
    optim_cfg: OptimConfig,
    device: Optional[torch.device] = None,
) -> TrainState:
    """Coarse (and, if hierarchical, fine) params drawn from ``generator``
    in that order, which must live on ``device``; Adam and its schedule."""
    params: Dict[str, Params] = {"coarse": field.init(generator, device)}
    if settings.hierarchical:
        params["fine"] = field.init(generator, device)
    for leaf in parameter_list(params):
        leaf.requires_grad_(True)
    optimizer = make_optimizer(params, optim_cfg)
    return TrainState(step=0, params=params, optimizer=optimizer, scheduler=lr_schedule(optimizer, optim_cfg))


def ray_loss_fn(
    field: Field,
    params: Dict[str, Params],
    ray_origin: torch.Tensor,
    ray_dir: torch.Tensor,
    rgb_gt: torch.Tensor,
    uniforms: RayUniforms,
    settings: RenderSettings,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Photometric loss on a ray batch: coarse MSE + fine MSE."""
    out = render_rays(field, params["coarse"], params.get("fine"), ray_origin, ray_dir, None,
                      settings, uniforms)
    coarse_loss = torch.mean((out["rgb_coarse"] - rgb_gt) ** 2)
    loss = coarse_loss
    metrics = {"coarse_loss": coarse_loss}
    if settings.hierarchical:
        fine_loss = torch.mean((out["rgb_fine"] - rgb_gt) ** 2)
        loss = loss + fine_loss
        metrics["fine_loss"] = fine_loss
    metrics["loss"] = loss
    return loss, metrics


def draw_train_randomness(generator: torch.Generator, num_rays: int, settings: RenderSettings) -> RayUniforms:
    """All uniform draws one train step's render consumes."""
    return draw_uniforms(generator, num_rays, settings)


def fused_loss_and_grad(
    field: Field,
    params: Dict[str, Params],
    ray_origin: torch.Tensor,
    ray_dir: torch.Tensor,
    rgb_gt: torch.Tensor,
    rand: RayUniforms,
    settings: RenderSettings,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Params]]:
    """Loss metrics + gradients through the fused train pass, one call for
    the coarse pass and one for the fine pass; the same sampling and loss as
    autograd of :func:`ray_loss_fn` on the same draws."""
    num_rays = ray_origin.shape[0]
    cfg = field.fused_cfg
    with torch.no_grad():
        t_coarse = sampling.stratified_t_samples_from_uniforms(rand.coarse, settings.t_near, settings.t_far)
        rgb_c, weights_c, grads_c = fused_train_pass(
            params["coarse"], ray_origin, ray_dir, t_coarse, sampling.t_deltas(t_coarse), rgb_gt, cfg, num_rays
        )
        coarse_loss = torch.mean((rgb_c - rgb_gt) ** 2)
        metrics = {"coarse_loss": coarse_loss, "loss": coarse_loss}
        grads: Dict[str, Params] = {"coarse": grads_c}
        if settings.hierarchical:
            t_fine = sampling.hierarchical_t_samples_from_uniforms(
                weights_c, settings.t_near, settings.t_far, rand.fine_coarse, rand.u, rand.fine
            )
            rgb_f, _, grads_f = fused_train_pass(
                params["fine"], ray_origin, ray_dir, t_fine, sampling.t_deltas(t_fine), rgb_gt, cfg, num_rays
            )
            fine_loss = torch.mean((rgb_f - rgb_gt) ** 2)
            metrics["fine_loss"] = fine_loss
            metrics["loss"] = coarse_loss + fine_loss
            grads["fine"] = grads_f
    return metrics, grads


def _apply_grads(state: TrainState, grads: list) -> None:
    """One Adam step and one schedule step with ``grads`` in
    :func:`parameter_list` order."""
    for leaf, grad in zip(parameter_list(state.params), grads):
        leaf.grad = grad
    state.optimizer.step()
    state.scheduler.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1


def make_ray_train_step(
    field: Field,
    settings: RenderSettings,
    optim_cfg: OptimConfig,
    force_generic: bool = False,
    aux_loss_fn: Optional[Callable] = None,
    occupancy_cfg: Optional[Any] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Train step over a ray batch: ``step(state, ray_origin (N, 3),
    ray_dir (N, 3), rgb_gt (N, 3), rand) -> (state, metrics)`` with ``rand``
    the step's :class:`RayUniforms`. ``optim_cfg`` is the one the state's
    optimizer was made with."""
    if occupancy_cfg is not None:
        raise NotImplementedError("occupancy pruning comes with the port's occupancy slice")
    if aux_loss_fn is not None:
        raise NotImplementedError(
            "auxiliary losses (the packed layouts' smoothness penalty) come with the port's "
            "packed-layout slice"
        )
    use_fused = field.fused_cfg is not None and not force_generic

    def step_fn(state: TrainState, ray_origin, ray_dir, rgb_gt, rand: RayUniforms):
        if use_fused:
            metrics, grads = fused_loss_and_grad(field, state.params, ray_origin, ray_dir, rgb_gt, rand, settings)
            grads = parameter_list(grads)
        else:
            loss, metrics = ray_loss_fn(field, state.params, ray_origin, ray_dir, rgb_gt, rand, settings)
            grads = list(torch.autograd.grad(loss, parameter_list(state.params)))
            metrics = {k: v.detach() for k, v in metrics.items()}
        _apply_grads(state, grads)
        return state, metrics

    return step_fn


def precrop_pixel_indices(img_height: int, img_width: int) -> np.ndarray:
    """Flat indices of the center-crop region sampled in early epochs: rows
    and columns within ``center +- center // 2``, ``center = (dim - 1) //
    2`` (``runners/train.py:150-169`` of the reference)."""
    ci = (img_height - 1) // 2
    cj = (img_width - 1) // 2
    rows = np.arange(ci - ci // 2, ci + ci // 2)
    cols = np.arange(cj - cj // 2, cj + cj // 2)
    return (rows[:, None] * img_width + cols[None, :]).reshape(-1).astype(np.int64)


def sample_pixels_without_replacement_from_uniforms(u: torch.Tensor, num_pixels: int) -> torch.Tensor:
    """``num_pixels`` distinct indices: the top-k of the i.i.d. uniforms
    ``u (num_candidates,)``, largest first."""
    return torch.topk(u, num_pixels).indices


def sample_pixels_without_replacement(
    generator: torch.Generator, num_candidates: int, num_pixels: int
) -> torch.Tensor:
    u = torch.rand((num_candidates,), generator=generator, device=generator.device)
    return sample_pixels_without_replacement_from_uniforms(u, num_pixels)


class ImageDraws(NamedTuple):
    """The draws of one image train step: which image (an int, or a 0-d
    tensor on the images' device so that no step waits for the card), the
    uniforms whose top-k picks its pixels, and the render's
    :class:`RayUniforms`."""

    image_index: Any
    pixel_u: torch.Tensor
    rays: RayUniforms


def make_image_train_step(
    field: Field,
    settings: RenderSettings,
    optim_cfg: OptimConfig,
    camera: cameras.CameraParams,
    num_pixels: int = 4096,
    precrop: bool = False,
    force_generic: bool = False,
    aux_loss_fn: Optional[Callable] = None,
    occupancy_cfg: Optional[Any] = None,
):
    """Full train step from the on-device image and pose pool:
    ``step(state, images (B, H*W, 3), poses (B, 4, 4), generator, draws=None)
    -> (state, metrics)``. Picks an image, samples ``num_pixels`` distinct
    pixels (center-cropped when ``precrop``), makes their rays and applies
    the ray train step. ``draws`` (:class:`ImageDraws`) replaces the draws
    from ``generator``; ``step.draw(generator, num_images)`` makes them."""
    ray_step = make_ray_train_step(field, settings, optim_cfg, force_generic, aux_loss_fn, occupancy_cfg)
    num_total = camera.img_height * camera.img_width
    crop = precrop_pixel_indices(camera.img_height, camera.img_width) if precrop else None
    if crop is not None:
        # the reference's randperm-then-slice keeps at most the crop region
        num_pixels = min(num_pixels, crop.shape[0])
    num_candidates = crop.shape[0] if crop is not None else num_total
    crop_cache: Dict[torch.device, torch.Tensor] = {}

    def draw(generator: torch.Generator, num_images: int) -> ImageDraws:
        dev = generator.device
        idx = torch.randint(0, num_images, (), generator=generator, device=dev)
        u = torch.rand((num_candidates,), generator=generator, device=dev)
        return ImageDraws(idx, u, draw_train_randomness(generator, num_pixels, settings))

    def step_fn(state: TrainState, images, poses, generator=None, draws: Optional[ImageDraws] = None):
        if draws is None:
            draws = draw(generator, images.shape[0])
        pixel_idx = sample_pixels_without_replacement_from_uniforms(draws.pixel_u, num_pixels)
        if crop is not None:
            dev = images.device
            if dev not in crop_cache:
                crop_cache[dev] = torch.as_tensor(crop, device=dev)
            pixel_idx = crop_cache[dev][pixel_idx]
        # a gather by a device tensor: indexing by a 0-d tensor would read it
        # back to the host and wait for the card
        sel = torch.as_tensor(draws.image_index, device=images.device).reshape(1)
        pose = poses.index_select(0, sel)[0]
        ray_o, ray_d = cameras.rays_for_pixels(
            pixel_idx, camera, pose, use_ndc=settings.project_to_ndc, ndc_z_near=settings.ndc_z_near
        )
        rgb_gt = images.index_select(0, sel)[0][pixel_idx]
        return ray_step(state, ray_o, ray_d, rgb_gt, draws.rays)

    step_fn.draw = draw
    step_fn.num_pixels = num_pixels
    return step_fn
