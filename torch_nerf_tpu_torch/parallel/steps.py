"""Sharded train steps, the sharded render and scenes over ranks.

Counterpart of ``torch_nerf_tpu/parallel/mesh.py:150-462`` and of
``torch_nerf_tpu/multiscene.py::make_multiscene_shardmap_step`` (:112), one
process per rank (:class:`~torch_nerf_tpu_torch.parallel.mesh.Mesh`).

Data parallelism (:class:`DataParallel`) shards the rays of a step: every
rank draws the whole batch's randomness from the same seeded generator
(never a generator a rank) and takes its rows ``[r N / W, (r + 1) N / W)``
of the rays and the draws, runs the single-process gradient path on them
(the fused train pass, kernel 3, or autograd through the field, kernels 1
and 2, or the occupancy-pruned passes), then averages the metrics and the
gradients over the ``data`` group and takes the same Adam step. Kernel 3's
loss gradient divides by its own call's ray count, so the mean of the
ranks' gradients is the batch's only for equal shards: ``N % W != 0``
raises, as it does in the JAX package. An occupancy sweep draws its jitter
whole, each rank evaluates its ``R^3 / W`` cells, and the densities are
gathered, so the grid is the same on every rank and the single process's.

Tensor parallelism (``model`` > 1) trains the classic field through
``tp_nerf.make_tp_field`` by autograd, the slices placed by
``mesh.place_state``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from torch_nerf_tpu_torch import cameras, multiscene, occupancy, train
from torch_nerf_tpu_torch.fields import Field
from torch_nerf_tpu_torch.parallel import collectives, tp_nerf
from torch_nerf_tpu_torch.parallel.mesh import Mesh
from torch_nerf_tpu_torch.renderer import RayUniforms, RenderSettings, chunk_seed, draw_uniforms, render_rays


def take_rows(x, lo: int, count: int):
    """Rows ``[lo, lo + count)`` of an ``(N, ...)`` tensor or of each of a
    RayUniforms' draws."""
    if isinstance(x, RayUniforms):
        return RayUniforms(*(u[lo:lo + count] for u in x))
    return x[lo:lo + count]


class DataParallel:
    """The ``data_parallel`` hook of ``train.make_ray_train_step`` over
    ``mesh``'s data group."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def share(self, total: int, what: str = "ray batch") -> slice:
        """This rank's rows of ``total``; raises unless they divide evenly."""
        size = self.mesh.data_size
        if total % size != 0:
            raise ValueError(f"{what} {total} must divide over {size} 'data' shards")
        count = total // size
        return slice(self.mesh.data_rank * count, (self.mesh.data_rank + 1) * count)

    def rows(self, *xs):
        """This rank's rows of each ``(N, ...)`` tensor or RayUniforms."""
        share = self.share(xs[0].shape[0])
        return tuple(take_rows(x, share.start, share.stop - share.start) for x in xs)

    def mean(self, metrics: Dict[str, torch.Tensor], grads: List[torch.Tensor]):
        return collectives.data_mean(metrics, grads, self.mesh.data_group)

    def density_fn(self, density_fn: Callable) -> Callable:
        """``density_fn`` on this rank's share of the points, the shares
        gathered whole."""

        def sharded(params, pts):
            share = self.share(pts.shape[0], "occupancy grid")
            return collectives.all_gather(density_fn(params, pts[share]), self.mesh.data_group)

        return sharded


def step_field(field: Field, mesh: Mesh) -> Field:
    """The field a sharded step trains: ``field`` itself, or with a model
    axis the classic field's TP counterpart (``tp_nerf.make_tp_field``)."""
    if mesh.model_size == 1:
        return field
    if field.fused_cfg is None:
        raise ValueError("tensor parallelism takes the classic NeRF field (make_nerf_field with its kernel "
                         "config); this field has none")
    return tp_nerf.make_tp_field(field.fused_cfg, mesh)


def make_sharded_train_step(field: Field, settings: RenderSettings, optim_cfg: train.OptimConfig, mesh: Mesh,
                            force_generic: bool = False) -> Callable:
    """The ray train step sharded over ``mesh``: ``step(state, ray_origin,
    ray_dir, rgb_gt, rand) -> (state, metrics)`` with the whole batch and
    its draws on every rank and ``state`` placed by ``mesh.place_state``.
    Data-parallel through the fused train pass where the field has one and
    ``force_generic`` is not set, else by autograd; with a model axis the
    classic field's width is sharded (``tp_nerf``), by autograd."""
    return train.make_ray_train_step(step_field(field, mesh), settings, optim_cfg, force_generic,
                                     data_parallel=DataParallel(mesh))


def make_sharded_image_train_step(field: Field, settings: RenderSettings, optim_cfg: train.OptimConfig,
                                  camera: cameras.CameraParams, mesh: Mesh, num_pixels: int = 4096,
                                  precrop: bool = False, force_generic: bool = False,
                                  aux_loss_fn: Optional[Callable] = None,
                                  occupancy_cfg: Optional[occupancy.OccupancyConfig] = None):
    """``train.make_image_train_step`` sharded over ``mesh``: the image and
    pixel draws whole on every rank, then the rays sharded. An aux loss is
    computed alike on every rank and added to each rank's loss, so after
    the mean its gradient counts once; the occupancy grid stays whole on
    every rank. ``num_pixels`` must divide over the data axis."""
    dp = DataParallel(mesh)
    step = train.make_image_train_step(step_field(field, mesh), settings, optim_cfg, camera, num_pixels, precrop,
                                       force_generic, aux_loss_fn, occupancy_cfg, dp)
    dp.share(step.num_pixels, "num_pixels")
    return step


def make_sharded_render(field: Field, settings: RenderSettings, mesh: Mesh, camera: cameras.CameraParams,
                        chunk_size: int = 4096,
                        uniforms_for_chunk: Optional[Callable[[int, int], RayUniforms]] = None) -> Callable:
    """``renderer.render_image`` over ``mesh``'s data group:
    ``render(params_coarse, params_fine, extrinsic, seed) -> (H, W, 3)`` on
    every rank. Each chunk's draws come whole from ``chunk_seed(seed,
    first pixel)``, or from ``uniforms_for_chunk(first_pixel, chunk_size)``
    as ``render_image`` takes it; each rank renders its rows of every chunk
    and the frame is gathered once. A chunk size that does not divide over
    the ranks is rounded up to one that does, as in the JAX package; with a
    chunk size that does, every ray sees what it sees in
    ``render_image``."""
    size = mesh.data_size
    chunk_size = -(-chunk_size // size) * size
    rows = chunk_size // size
    lo = mesh.data_rank * rows
    h, w = camera.img_height, camera.img_width
    num_pixels = h * w
    num_chunks = -(-num_pixels // chunk_size)

    def render(params_coarse, params_fine, extrinsic: torch.Tensor, seed: int) -> torch.Tensor:
        device = extrinsic.device
        pixel_idx = torch.arange(num_chunks * chunk_size, device=device).clamp_max(num_pixels - 1)
        pixel_idx = pixel_idx.reshape(num_chunks, chunk_size)[:, lo:lo + rows].reshape(-1)
        origins, dirs = cameras.rays_for_pixels(pixel_idx, camera, extrinsic, use_ndc=settings.project_to_ndc,
                                                ndc_z_near=settings.ndc_z_near)
        pc = field.prepare(params_coarse)
        pf = field.prepare(params_fine) if params_fine is not None else None
        out = []
        with torch.inference_mode():
            for c in range(num_chunks):
                if uniforms_for_chunk is not None:
                    uniforms = uniforms_for_chunk(c * chunk_size, chunk_size)
                else:
                    gen = torch.Generator(device=device).manual_seed(chunk_seed(seed, c * chunk_size))
                    uniforms = draw_uniforms(gen, chunk_size, settings)
                uniforms = take_rows(uniforms, lo, rows)
                sl = slice(c * rows, (c + 1) * rows)
                res = render_rays(field, pc, pf, origins[sl], dirs[sl], None, settings, uniforms)
                out.append(res["rgb_fine"] if settings.hierarchical else res["rgb_coarse"])
            local = torch.stack(out)  # (chunks, rows, 3)
        frame = collectives.all_gather(local, mesh.data_group, dim=1)
        return frame.reshape(-1, 3)[:num_pixels].reshape(h, w, 3)

    return render


def local_scenes(mesh: Mesh, num_scenes: int) -> range:
    """The scenes rank ``data_rank`` trains: ``[r S / W, (r + 1) S / W)``."""
    return range(*DataParallel(mesh).share(num_scenes, "num_scenes").indices(num_scenes))


def create_scene_state(mesh: Mesh, seed: int, field: Field, settings: RenderSettings,
                       optim_cfg: train.OptimConfig, num_scenes: int) -> train.TrainState:
    """This rank's stacked state of its scenes, each drawn from
    ``multiscene.scene_generators(seed, num_scenes)`` at its global index:
    the ``(S / W, ...)`` slice of the whole stacked state."""
    scenes = local_scenes(mesh, num_scenes)
    gens = multiscene.scene_generators(seed, num_scenes, mesh.device)[scenes.start:scenes.stop]
    return multiscene.create_multiscene_state(gens, field, settings, optim_cfg, len(scenes), mesh.device)


def make_multiscene_shard_step(field: Field, settings: RenderSettings, optim_cfg: train.OptimConfig,
                               camera: cameras.CameraParams, num_scenes: int, mesh: Mesh, num_pixels: int = 4096,
                               precrop: bool = False):
    """Scenes over the data group (the JAX package's
    ``make_multiscene_shardmap_step``): rank r trains its scenes
    (:func:`local_scenes`) on ``multiscene.make_multiscene_train_step``,
    owning the ``(S / W, ...)`` slice of every stacked leaf
    (:func:`create_scene_state`) with one Adam over it.
    ``step(state, images, poses, generators=None, draws=None) -> (state,
    metrics)`` takes the rank's scenes' pools ``(S / W, V, H*W, 3)``, ``(S
    / W, V, 4, 4)`` and their generators (``multiscene.scene_generators``
    at their global indices, so scene s's stream does not depend on the
    split) or draws. The metrics are gathered: each an ``(S,)`` tensor, but
    ``loss``, the scenes' mean. ``S % W != 0`` raises."""
    scenes = local_scenes(mesh, num_scenes)
    step = multiscene.make_multiscene_train_step(field, settings, optim_cfg, camera, len(scenes), num_pixels,
                                                 precrop)

    def step_fn(state: train.TrainState, images, poses, generators=None, draws: Optional[Sequence] = None):
        state, metrics = step(state, images, poses, generators, draws)
        keys = sorted(k for k in metrics if k != "loss")
        per_scene = collectives.all_gather(torch.stack([metrics[k] for k in keys]), mesh.data_group, dim=1)
        out: Dict[str, Any] = dict(zip(keys, per_scene))
        out["loss"] = collectives.all_reduce(metrics["loss"], mesh.data_group) / mesh.data_size
        return state, out

    step_fn.draw = step.draw
    step_fn.num_pixels = step.num_pixels
    step_fn.scenes = scenes
    return step_fn
