"""Training: optimizer, schedule, loss and the train steps.

Counterpart of ``torch_nerf_tpu/train.py``, the occupancy-pruned steps
included. Adam with ``lr(t) = init_lr
* (end_lr / init_lr)^(t / num_iter)``, stepped once per iteration
(``ExponentialLR``), and L2 weight decay on hash tables where asked for;
the loss is coarse MSE + fine MSE, plus an auxiliary loss where one is
given (the packed layouts' smoothness penalty), summed before one
backward.

A field with a ``fused_cfg`` trains through the fused train pass
(``ops/fused_train.py``: each render pass with its loss gradient in one
kernel call); ``force_generic=True`` or a field without one trains by
autograd through ``field.apply`` (for the fused field, the forward and
backward kernels of ``ops/fused_nerf.py``). With an
:class:`~torch_nerf_tpu_torch.occupancy.OccupancyConfig` the step threads the
occupancy grid, sweeps it every ``update_every`` steps and renders only the
kept samples of each pass (``occupancy.prune_t_samples``); the fused field
then runs the fused train pass on the pruned ``(t, delta)`` planes.

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

from torch_nerf_tpu_torch import cameras, occupancy, tracing
from torch_nerf_tpu_torch.fields import Field
from torch_nerf_tpu_torch.models.nerf import Params
from torch_nerf_tpu_torch.ops import integration, sampling
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
    with tracing.span("train.render"):
        out = render_rays(field, params["coarse"], params.get("fine"), ray_origin, ray_dir, None,
                          settings, uniforms)
    with tracing.span("train.loss"):
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
        with tracing.span("sample.coarse"):
            t_coarse = sampling.stratified_t_samples_from_uniforms(rand.coarse, settings.t_near, settings.t_far)
        rgb_c, weights_c, grads_c = fused_train_pass(
            params["coarse"], ray_origin, ray_dir, t_coarse, sampling.t_deltas(t_coarse), rgb_gt, cfg, num_rays
        )
        coarse_loss = torch.mean((rgb_c - rgb_gt) ** 2)
        metrics = {"coarse_loss": coarse_loss, "loss": coarse_loss}
        grads: Dict[str, Params] = {"coarse": grads_c}
        if settings.hierarchical:
            with tracing.span("sample.fine"):
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


def _pruned_pass(field, params, grid, occ_cfg, ray_origin, ray_dir, t_dense, step, keep):
    """One pruned render pass through ``field.apply``: (rgb, weights, t_sel)."""
    t_sel, delta_sel = occupancy.prune_t_samples(grid, occ_cfg, ray_origin, ray_dir, t_dense, step, keep=keep)
    pts = sampling.points_along_rays(ray_origin, ray_dir, t_sel)
    sigma, radiance = field.apply(params, pts, ray_dir[:, None, :].expand_as(pts))
    rgb, weights = integration.composite(sigma, radiance, delta_sel)
    return rgb, weights, t_sel


def pruned_ray_loss_fn(
    field: Field,
    params: Dict[str, Params],
    grid: torch.Tensor,
    occ_cfg: occupancy.OccupancyConfig,
    ray_origin: torch.Tensor,
    ray_dir: torch.Tensor,
    rgb_gt: torch.Tensor,
    rand: RayUniforms,
    settings: RenderSettings,
    step: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The photometric loss of a single-pass model on the ``keep_samples``
    kept of its ``num_samples_coarse`` stratified candidates (jitter
    ``rand.coarse``), each composited over its covered span."""
    t_dense = sampling.stratified_t_samples_from_uniforms(rand.coarse, settings.t_near, settings.t_far)
    rgb, _, _ = _pruned_pass(field, params["coarse"], grid, occ_cfg, ray_origin, ray_dir, t_dense, step,
                             occ_cfg.keep_samples)
    loss = torch.mean((rgb - rgb_gt) ** 2)
    return loss, {"coarse_loss": loss, "loss": loss}


def pruned_hierarchical_loss_fn(
    field: Field,
    params: Dict[str, Params],
    grid: torch.Tensor,
    occ_cfg: occupancy.OccupancyConfig,
    ray_origin: torch.Tensor,
    ray_dir: torch.Tensor,
    rgb_gt: torch.Tensor,
    rand: RayUniforms,
    settings: RenderSettings,
    step: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The hierarchical loss with both passes pruned: the coarse pass keeps
    ``keep_samples`` of its candidates; its detached weights go back onto
    the uniform coarse bins (``occupancy.scatter_weights_to_bins``), the
    fine pass merges a fresh stratification with inverse-CDF draws from
    them, and the merged set is pruned to ``keep_samples_fine`` (to its
    whole size when that is 0)."""
    s_c = settings.num_samples_coarse
    t_dense = sampling.stratified_t_samples_from_uniforms(rand.coarse, settings.t_near, settings.t_far)
    rgb_c, weights_c, t_c = _pruned_pass(field, params["coarse"], grid, occ_cfg, ray_origin, ray_dir, t_dense,
                                         step, occ_cfg.keep_samples)
    coarse_loss = torch.mean((rgb_c - rgb_gt) ** 2)
    w_dense = occupancy.scatter_weights_to_bins(t_c, weights_c.detach(), settings.t_near, settings.t_far, s_c)
    t_merged = sampling.hierarchical_t_samples_from_uniforms(
        w_dense, settings.t_near, settings.t_far, rand.fine_coarse, rand.u, rand.fine
    )
    keep_fine = occ_cfg.keep_samples_fine or t_merged.shape[-1]
    rgb_f, _, _ = _pruned_pass(field, params["fine"], grid, occ_cfg, ray_origin, ray_dir, t_merged, step,
                               keep_fine)
    fine_loss = torch.mean((rgb_f - rgb_gt) ** 2)
    loss = coarse_loss + fine_loss
    return loss, {"coarse_loss": coarse_loss, "fine_loss": fine_loss, "loss": loss}


def fused_pruned_loss_and_grad(
    field: Field,
    params: Dict[str, Params],
    grid: torch.Tensor,
    occ_cfg: occupancy.OccupancyConfig,
    ray_origin: torch.Tensor,
    ray_dir: torch.Tensor,
    rgb_gt: torch.Tensor,
    rand: RayUniforms,
    settings: RenderSettings,
    step: int,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Params]]:
    """The pruned losses' metrics and gradients through the fused train
    pass: the same sampling as :func:`pruned_ray_loss_fn` and
    :func:`pruned_hierarchical_loss_fn`, the pruning done on the ``(N, S)``
    depths before each pass, which sees ``K`` samples a ray and their
    covered spans. The fine pass keeps ``keep_samples_fine`` of the merged
    set, or all of it, unpruned, when that is 0."""
    num_rays = ray_origin.shape[0]
    cfg = field.fused_cfg
    s_c = settings.num_samples_coarse
    with torch.no_grad():
        t_dense = sampling.stratified_t_samples_from_uniforms(rand.coarse, settings.t_near, settings.t_far)
        t_c, delta_c = occupancy.prune_t_samples(grid, occ_cfg, ray_origin, ray_dir, t_dense, step)
        rgb_c, weights_c, grads_c = fused_train_pass(params["coarse"], ray_origin, ray_dir, t_c, delta_c, rgb_gt,
                                                     cfg, num_rays)
        coarse_loss = torch.mean((rgb_c - rgb_gt) ** 2)
        metrics = {"coarse_loss": coarse_loss, "loss": coarse_loss}
        grads: Dict[str, Params] = {"coarse": grads_c}
        if settings.hierarchical:
            w_dense = occupancy.scatter_weights_to_bins(t_c, weights_c, settings.t_near, settings.t_far, s_c)
            t_merged = sampling.hierarchical_t_samples_from_uniforms(
                w_dense, settings.t_near, settings.t_far, rand.fine_coarse, rand.u, rand.fine
            )
            if occ_cfg.keep_samples_fine > 0:
                t_f, delta_f = occupancy.prune_t_samples(grid, occ_cfg, ray_origin, ray_dir, t_merged, step,
                                                         keep=occ_cfg.keep_samples_fine)
            else:
                t_f, delta_f = t_merged, sampling.t_deltas(t_merged)
            rgb_f, _, grads_f = fused_train_pass(params["fine"], ray_origin, ray_dir, t_f, delta_f, rgb_gt, cfg,
                                                 num_rays)
            fine_loss = torch.mean((rgb_f - rgb_gt) ** 2)
            metrics["fine_loss"] = fine_loss
            metrics["loss"] = coarse_loss + fine_loss
            grads["fine"] = grads_f
    return metrics, grads


def _apply_grads(state: TrainState, grads: list) -> None:
    """One Adam step and one schedule step with ``grads`` in
    :func:`parameter_list` order."""
    with tracing.span("train.adam"):
        for leaf, grad in zip(parameter_list(state.params), grads):
            leaf.grad = grad
        state.optimizer.step()
        state.scheduler.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1


def _generic_grads(loss_fn, params, aux_loss_fn, aux_draws):
    """Autograd of ``loss_fn(params)`` (plus the aux loss where given) with
    respect to ``params``' leaves: ``(metrics, grads)``."""
    loss, metrics = loss_fn(params)
    if aux_loss_fn is not None:
        if aux_draws is None:
            raise ValueError("a step with an aux loss needs its aux_draws")
        aux = aux_loss_fn(params, aux_draws)
        metrics["aux_loss"] = aux
        loss = loss + aux
        metrics["loss"] = loss
    with tracing.span("train.backward", handoff=True):
        grads = list(torch.autograd.grad(loss, parameter_list(params)))
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_ray_grad_fn(
    field: Field,
    settings: RenderSettings,
    force_generic: bool = False,
    aux_loss_fn: Optional[Callable] = None,
) -> Callable[..., Tuple]:
    """The loss and gradients of one ray batch, without the optimizer step:
    ``grads(params, ray_origin, ray_dir, rgb_gt, rand, aux_draws=None) ->
    (metrics, grads)``, ``grads`` in :func:`parameter_list` order. Through
    the fused train pass when the field has a ``fused_cfg`` and neither
    ``force_generic`` nor an aux loss is given, else by autograd of
    :func:`ray_loss_fn` (plus the aux loss), for which ``params``' leaves
    must require grad. The single-scene step and the multi-scene step
    (``multiscene.py``) both take their gradients from it."""
    use_fused = field.fused_cfg is not None and not force_generic
    if use_fused and aux_loss_fn is not None:
        raise ValueError("aux_loss_fn requires the generic autodiff path.")

    def grad_fn(params, ray_origin, ray_dir, rgb_gt, rand: RayUniforms, aux_draws=None):
        if use_fused:
            metrics, grads = fused_loss_and_grad(field, params, ray_origin, ray_dir, rgb_gt, rand, settings)
            return metrics, parameter_list(grads)
        return _generic_grads(
            lambda p: ray_loss_fn(field, p, ray_origin, ray_dir, rgb_gt, rand, settings),
            params, aux_loss_fn, aux_draws,
        )

    return grad_fn


def make_ray_train_step(
    field: Field,
    settings: RenderSettings,
    optim_cfg: OptimConfig,
    force_generic: bool = False,
    aux_loss_fn: Optional[Callable] = None,
    occupancy_cfg: Optional[occupancy.OccupancyConfig] = None,
    data_parallel: Optional[Any] = None,
) -> Callable[..., Tuple]:
    """Train step over a ray batch: ``step(state, ray_origin (N, 3),
    ray_dir (N, 3), rgb_gt (N, 3), rand, aux_draws=None) -> (state,
    metrics)`` with ``rand`` the step's :class:`RayUniforms`. ``optim_cfg``
    is the one the state's optimizer was made with.

    ``aux_loss_fn(params, aux_draws) -> scalar`` (optional; its
    ``.draw(generator)`` makes ``aux_draws``) is added to the photometric
    loss, as ``metrics["aux_loss"]``, on the generic autograd path only.

    With ``occupancy_cfg`` the step is ``step(state, grid, ray_origin,
    ray_dir, rgb_gt, rand, aux_draws=None, occ_jitter=None) -> (state, grid,
    metrics)``: on a step whose ``state.step`` is a multiple of
    ``update_every`` it first sweeps the grid at the ``(R^3, 3)`` jitter
    ``occ_jitter`` (the coarse network's density), then renders the pruned
    passes from ``rand`` (``rand.coarse`` the stratified candidates' jitter,
    the other three the fine pass's, as in the dense step); fused when the
    field has a ``fused_cfg`` and no aux loss is given.

    ``data_parallel`` (``parallel.steps.DataParallel``) shards the step
    over ranks: every rank is handed the whole batch and its draws, takes
    its rows of them (``.rows``), and averages its metrics and gradients
    with the other ranks' (``.mean``) before the same optimizer step; a
    sweep evaluates each rank's share of the cells
    (``.density_fn``)."""
    grad_fn = make_ray_grad_fn(field, settings, force_generic, aux_loss_fn)
    use_fused = field.fused_cfg is not None and not force_generic
    dp = data_parallel

    if occupancy_cfg is not None:
        if occupancy_cfg.keep_samples > settings.num_samples_coarse:
            raise ValueError("keep_samples must be <= num_samples_coarse.")
        if occupancy_cfg.keep_samples_fine > settings.num_samples_coarse + settings.num_samples_fine:
            raise ValueError(
                "keep_samples_fine must be <= num_samples_coarse + num_samples_fine (the merged fine candidate count)."
            )
        density_fn = occupancy.make_density_fn(field)
        if dp is not None:
            density_fn = dp.density_fn(density_fn)
        pruned_loss = pruned_hierarchical_loss_fn if settings.hierarchical else pruned_ray_loss_fn

        def occ_step_fn(state: TrainState, grid, ray_origin, ray_dir, rgb_gt, rand: RayUniforms, aux_draws=None,
                        occ_jitter=None):
            grid = occupancy.maybe_update_grid(grid, density_fn, state.params, occ_jitter, state.step,
                                               occupancy_cfg)
            if dp is not None:
                ray_origin, ray_dir, rgb_gt, rand = dp.rows(ray_origin, ray_dir, rgb_gt, rand)
            args = (grid, occupancy_cfg, ray_origin, ray_dir, rgb_gt, rand, settings, state.step)
            if use_fused:
                metrics, grads = fused_pruned_loss_and_grad(field, state.params, *args)
                grads = parameter_list(grads)
            else:
                metrics, grads = _generic_grads(lambda params: pruned_loss(field, params, *args), state.params,
                                                aux_loss_fn, aux_draws)
            if dp is not None:
                metrics, grads = dp.mean(metrics, grads)
            _apply_grads(state, grads)
            return state, grid, metrics

        return occ_step_fn

    def step_fn(state: TrainState, ray_origin, ray_dir, rgb_gt, rand: RayUniforms, aux_draws=None):
        if dp is not None:
            ray_origin, ray_dir, rgb_gt, rand = dp.rows(ray_origin, ray_dir, rgb_gt, rand)
        metrics, grads = grad_fn(state.params, ray_origin, ray_dir, rgb_gt, rand, aux_draws)
        if dp is not None:
            metrics, grads = dp.mean(metrics, grads)
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
    uniforms whose top-k picks its pixels, the render's
    :class:`RayUniforms`, the aux loss's draws (None without one) and, on
    an occupancy step that sweeps the grid, the sweep's ``(R^3, 3)`` jitter
    (else None), drawn in that order."""

    image_index: Any
    pixel_u: torch.Tensor
    rays: RayUniforms
    aux: Any = None
    occ_jitter: Optional[torch.Tensor] = None


def make_image_train_step(
    field: Field,
    settings: RenderSettings,
    optim_cfg: OptimConfig,
    camera: cameras.CameraParams,
    num_pixels: int = 4096,
    precrop: bool = False,
    force_generic: bool = False,
    aux_loss_fn: Optional[Callable] = None,
    occupancy_cfg: Optional[occupancy.OccupancyConfig] = None,
    data_parallel: Optional[Any] = None,
):
    """Full train step from the on-device image and pose pool:
    ``step(state, images (B, H*W, 3), poses (B, 4, 4), generator, draws=None)
    -> (state, metrics)``. Picks an image, samples ``num_pixels`` distinct
    pixels (center-cropped when ``precrop``), makes their rays and applies
    the ray train step. ``draws`` (:class:`ImageDraws`) replaces the draws
    from ``generator``; ``step.draw(generator, num_images, step)`` makes
    them, and ``step.ray_batch(images, poses, draws)`` gives their
    ``(ray_origin, ray_dir, rgb_gt)``. With ``occupancy_cfg`` the grid threads through: ``step(state,
    grid, images, poses, generator, draws=None) -> (state, grid,
    metrics)``. With ``data_parallel`` every rank draws and gathers the
    whole batch, and the ray step shards it (:func:`make_ray_train_step`)."""
    ray_step = make_ray_train_step(field, settings, optim_cfg, force_generic, aux_loss_fn, occupancy_cfg,
                                   data_parallel)
    num_total = camera.img_height * camera.img_width
    crop = precrop_pixel_indices(camera.img_height, camera.img_width) if precrop else None
    if crop is not None:
        # the reference's randperm-then-slice keeps at most the crop region
        num_pixels = min(num_pixels, crop.shape[0])
    num_candidates = crop.shape[0] if crop is not None else num_total
    crop_cache: Dict[torch.device, torch.Tensor] = {}

    def draw(generator: torch.Generator, num_images: int, step: Optional[int] = None) -> ImageDraws:
        """The step's draws; the sweep's jitter when ``step`` (the state's
        step) sweeps the grid, or is None."""
        dev = generator.device
        idx = torch.randint(0, num_images, (), generator=generator, device=dev)
        u = torch.rand((num_candidates,), generator=generator, device=dev)
        rays = draw_train_randomness(generator, num_pixels, settings)
        aux = aux_loss_fn.draw(generator) if aux_loss_fn is not None else None
        jitter = None
        if occupancy_cfg is not None and (step is None or occupancy.is_update_step(step, occupancy_cfg)):
            jitter = occupancy.draw_jitter(generator, occupancy_cfg)
        return ImageDraws(idx, u, rays, aux, jitter)

    def ray_batch(images, poses, draws: ImageDraws):
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
        return ray_o, ray_d, images.index_select(0, sel)[0][pixel_idx]

    if occupancy_cfg is not None:

        def occ_step_fn(state: TrainState, grid, images, poses, generator=None, draws: Optional[ImageDraws] = None):
            with tracing.unit("train.step", step=state.step):
                if draws is None:
                    draws = draw(generator, images.shape[0], state.step)
                with tracing.span("train.ray_batch"):
                    batch = ray_batch(images, poses, draws)
                return ray_step(state, grid, *batch, draws.rays, draws.aux, draws.occ_jitter)

        step_fn = occ_step_fn
    else:

        def step_fn(state: TrainState, images, poses, generator=None, draws: Optional[ImageDraws] = None):
            with tracing.unit("train.step", step=state.step):
                if draws is None:
                    draws = draw(generator, images.shape[0])
                with tracing.span("train.ray_batch"):
                    batch = ray_batch(images, poses, draws)
                return ray_step(state, *batch, draws.rays, draws.aux)

    step_fn.draw = draw
    step_fn.ray_batch = ray_batch
    step_fn.num_pixels = num_pixels
    return step_fn
