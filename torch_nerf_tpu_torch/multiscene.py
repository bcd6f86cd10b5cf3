"""Multi-scene training: N independent scenes trained in one step.

Counterpart of ``torch_nerf_tpu/multiscene.py``. Every parameter leaf is
stacked with a leading scene axis ``(S, ...)``, and one Adam with one
exponential schedule runs over the stacked leaves: Adam and its weight
decay act element by element, so one Adam over the stack equals S Adams,
one a scene (the layout of the JAX package's ``vmap``-ped optimizer state
and of its checkpoints).

On one card the step is a loop over the scenes. Each scene's ray batch and
gradients come from the single-scene path (``train.make_image_train_step``'s
``ray_batch`` and ``train.make_ray_grad_fn``), on the views ``leaf[s]`` of
its parameters, so the fused train pass (kernel 3) and the hash-grid
kernels run unchanged, once a scene; the JAX package's ``shard_map`` builder
runs its unbatched per-scene step in the same way. The stacked gradients
then take one optimizer and one schedule step. Neither an aux loss nor an
occupancy grid is threaded, as in both JAX builders.

Randomness is explicit: scene s draws from its own ``torch.Generator``,
seeded by :func:`scene_seed` from ``(seed, s)``, so its stream does not
depend on how many scenes train beside it (the property JAX gets from
``fold_in(key, s)``), and ``step.draw`` makes the per-scene
:class:`~torch_nerf_tpu_torch.train.ImageDraws` that the tests hand over.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence

import torch

from torch_nerf_tpu_torch import cameras, train
from torch_nerf_tpu_torch.fields import Field
from torch_nerf_tpu_torch.renderer import RenderSettings
from torch_nerf_tpu_torch.train import ImageDraws, OptimConfig, TrainState

__all__ = [
    "create_multiscene_state",
    "make_multiscene_train_step",
    "scene_generators",
    "scene_params",
    "scene_seed",
    "slice_scene",
]


def scene_seed(seed: int, scene: int) -> int:
    """The generator seed of scene ``scene`` in a run seeded ``seed``: the
    first 63 bits of blake2b of ``"scene:<seed>:<scene>"``."""
    digest = hashlib.blake2b(f"scene:{seed}:{scene}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def scene_generators(seed: int, num_scenes: int, device: Optional[torch.device] = None) -> List[torch.Generator]:
    """One generator a scene on ``device``, scene s's seeded by
    ``scene_seed(seed, s)``."""
    return [torch.Generator(device=device).manual_seed(scene_seed(seed, s)) for s in range(num_scenes)]


def _stack_trees(trees: Sequence[Any]) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def slice_scene(tree: Any, scene: int) -> Any:
    """The views ``leaf[scene]`` of a stacked parameter tree, detached
    (contiguous, as the kernels need)."""
    if isinstance(tree, dict):
        return {k: slice_scene(v, scene) for k, v in tree.items()}
    return tree[scene].detach()


def _requiring_grad(tree: Any) -> Any:
    """``tree``'s detached leaves set to require grad, so that the generic
    path's autograd differentiates with respect to them."""
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    return tree.requires_grad_(True)


def scene_params(state: TrainState, scene: int) -> Dict[str, Any]:
    """One scene's parameter tree out of the stacked state: views of it."""
    return slice_scene(state.params, scene)


def create_multiscene_state(
    generators: Sequence[torch.Generator],
    field: Field,
    settings: RenderSettings,
    optim_cfg: OptimConfig,
    num_scenes: int,
    device: Optional[torch.device] = None,
) -> TrainState:
    """The stacked train state: scene s's coarse (and, if hierarchical,
    fine) params drawn from ``generators[s]`` as
    :func:`train.create_train_state` draws them, every leaf stacked
    ``(S, ...)``; one Adam (``train.make_optimizer``: the table weight decay
    on the tables only) and one schedule over the stacked leaves."""
    if len(generators) != num_scenes:
        raise ValueError(f"{num_scenes} scenes need {num_scenes} generators; got {len(generators)}.")
    trees = []
    for gen in generators:
        params = {"coarse": field.init(gen, device)}
        if settings.hierarchical:
            params["fine"] = field.init(gen, device)
        trees.append(params)
    params = _stack_trees(trees)
    for leaf in train.parameter_list(params):
        leaf.requires_grad_(True)
    optimizer = train.make_optimizer(params, optim_cfg)
    return TrainState(step=0, params=params, optimizer=optimizer, scheduler=train.lr_schedule(optimizer, optim_cfg))


def make_multiscene_train_step(
    field: Field,
    settings: RenderSettings,
    optim_cfg: OptimConfig,
    camera: cameras.CameraParams,
    num_scenes: int,
    num_pixels: int = 4096,
    precrop: bool = False,
):
    """One step training ``num_scenes`` scenes: ``step(state, images (S, V,
    H*W, 3), poses (S, V, 4, 4), generators, draws=None) -> (state,
    metrics)``. For each scene in order: its image, pixels and rays from its
    :class:`ImageDraws` (``draws[s]``, or drawn from ``generators[s]``), its
    loss and gradients on the single-scene path; then the gradients, stacked,
    take one optimizer and one schedule step. Each metric is an ``(S,)``
    tensor of the scenes' values, but ``loss``, their mean.
    ``step.draw(generators, num_views)`` makes the list of draws."""
    image_step = train.make_image_train_step(field, settings, optim_cfg, camera, num_pixels, precrop=precrop)
    grad_fn = train.make_ray_grad_fn(field, settings)

    def draw(generators: Sequence[torch.Generator], num_views: int) -> List[ImageDraws]:
        return [image_step.draw(gen, num_views) for gen in generators]

    def step_fn(state: TrainState, images, poses, generators=None, draws: Optional[Sequence[ImageDraws]] = None):
        if draws is None:
            draws = draw(generators, images.shape[1])
        if len(draws) != num_scenes or images.shape[0] != num_scenes:
            raise ValueError(f"a {num_scenes}-scene step needs {num_scenes} image pools and draws.")
        scene_metrics, scene_grads = [], []
        for s in range(num_scenes):
            params = _requiring_grad(scene_params(state, s))
            batch = image_step.ray_batch(images[s], poses[s], draws[s])
            metrics, grads = grad_fn(params, *batch, draws[s].rays)
            scene_metrics.append(metrics)
            scene_grads.append(grads)
        train._apply_grads(state, [torch.stack(g) for g in zip(*scene_grads)])
        metrics = {k: torch.stack([m[k] for m in scene_metrics]) for k in scene_metrics[0]}
        metrics["loss"] = metrics["loss"].mean()
        return state, metrics

    step_fn.draw = draw
    step_fn.num_pixels = image_step.num_pixels
    return step_fn
