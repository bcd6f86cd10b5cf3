"""Volume renderer: coarse/fine ray rendering and chunked full images.

Counterpart of ``torch_nerf_tpu/renderer.py:27-174``. ``render_image`` is a
Python loop over fixed-size ray chunks; the last chunk is padded by
repeating the last pixel, as the JAX package pads its ``lax.map``. Each
chunk's random numbers come from a generator seeded by ``(seed, first pixel
of the chunk)``, not by its place in a sequence of draws, so the image
depends on the seed and the chunking only.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from torch_nerf_tpu_torch import cameras, tracing
from torch_nerf_tpu_torch.fields import Field
from torch_nerf_tpu_torch.ops import integration, sampling


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    num_samples_coarse: int = 64
    num_samples_fine: int = 128
    t_near: float = 2.0
    t_far: float = 6.0
    project_to_ndc: bool = False
    # z_near of the NDC projection itself (official-NeRF convention)
    ndc_z_near: float = 1.0

    @property
    def hierarchical(self) -> bool:
        return self.num_samples_fine > 0


class RayUniforms(NamedTuple):
    """The four uniform draws of one batch of rays, in draw order: the
    coarse pass's jitter (N, S_c); the fine pass's own fresh coarse jitter
    (N, S_c); the inverse-CDF ``u`` (N, S_f); the fine jitter (N, S_f)."""

    coarse: torch.Tensor
    fine_coarse: torch.Tensor
    u: torch.Tensor
    fine: torch.Tensor


def draw_uniforms(
    generator: torch.Generator, num_rays: int, settings: RenderSettings
) -> RayUniforms:
    sc, sf, dev = settings.num_samples_coarse, settings.num_samples_fine, generator.device
    return RayUniforms(
        coarse=torch.rand((num_rays, sc), generator=generator, device=dev),
        fine_coarse=torch.rand((num_rays, sc), generator=generator, device=dev),
        u=torch.rand((num_rays, sf), generator=generator, device=dev),
        fine=torch.rand((num_rays, sf), generator=generator, device=dev),
    )


def render_rays(
    field: Field,
    params_coarse: Any,
    params_fine: Optional[Any],
    ray_origin: torch.Tensor,
    ray_dir: torch.Tensor,
    generator: Optional[torch.Generator],
    settings: RenderSettings,
    uniforms: Optional[RayUniforms] = None,
) -> Dict[str, torch.Tensor]:
    """Render a batch of rays: the stratified coarse pass, then (if
    ``num_samples_fine > 0``) the fine pass on coarse + inverse-CDF samples
    of the detached coarse weights. Draws from ``generator`` unless
    ``uniforms`` are given. The params are the public trees (differentiable)
    or ``field.prepare`` handles (forward only)."""
    if uniforms is None:
        uniforms = draw_uniforms(generator, ray_origin.shape[0], settings)
    with tracing.span("sample.coarse"):
        t_coarse = sampling.stratified_t_samples_from_uniforms(
            uniforms.coarse, settings.t_near, settings.t_far
        )
    out = _render_pass(field, params_coarse, ray_origin, ray_dir, t_coarse)
    result = {"rgb_coarse": out["rgb"], "weights_coarse": out["weights"], "t_coarse": t_coarse}

    if settings.hierarchical:
        if params_fine is None:
            raise ValueError("Hierarchical rendering requires fine-network params.")
        with tracing.span("sample.fine"):
            t_fine = sampling.hierarchical_t_samples_from_uniforms(
                out["weights"].detach(),
                settings.t_near,
                settings.t_far,
                uniforms.fine_coarse,
                uniforms.u,
                uniforms.fine,
            )
        fine_out = _render_pass(field, params_fine, ray_origin, ray_dir, t_fine)
        result.update(rgb_fine=fine_out["rgb"], weights_fine=fine_out["weights"], t_fine=t_fine)
    return result


def _render_pass(
    field: Field,
    params: Any,
    ray_origin: torch.Tensor,
    ray_dir: torch.Tensor,
    t_samples: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """One network evaluation + compositing for given t samples."""
    pts = sampling.points_along_rays(ray_origin, ray_dir, t_samples)
    dirs = ray_dir[:, None, :].expand_as(pts)
    sigma, radiance = field.apply(params, pts, dirs)
    with tracing.span("render.composite"):
        delta = sampling.t_deltas(t_samples)
        rgb, weights = integration.composite(sigma, radiance, delta)
    return {"rgb": rgb, "weights": weights}


def chunk_seed(seed: int, first_pixel: int) -> int:
    """Generator seed of the chunk that starts at ``first_pixel``."""
    digest = hashlib.blake2b(f"{seed}:{first_pixel}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def render_image(
    field: Field,
    params_coarse: Any,
    params_fine: Optional[Any],
    camera: cameras.CameraParams,
    extrinsic: torch.Tensor,
    seed: int,
    settings: RenderSettings,
    chunk_size: int = 4096,
    uniforms_for_chunk: Optional[Callable[[int, int], RayUniforms]] = None,
) -> torch.Tensor:
    """Render a full image -> ``(H, W, 3)`` on ``extrinsic``'s device.

    ``uniforms_for_chunk(first_pixel, chunk_size)`` may supply each chunk's
    draws; by default they come from a generator seeded by
    :func:`chunk_seed`.
    """
    with tracing.unit("render.frame", seed=seed) as frame:
        device = extrinsic.device
        h, w = camera.img_height, camera.img_width
        num_pixels = h * w
        num_chunks = -(-num_pixels // chunk_size)
        with tracing.span("render.rays"):
            pixel_idx = torch.arange(num_chunks * chunk_size, device=device).clamp_max(num_pixels - 1)
            origins, dirs = cameras.rays_for_pixels(
                pixel_idx, camera, extrinsic,
                use_ndc=settings.project_to_ndc, ndc_z_near=settings.ndc_z_near,
            )
        with tracing.span("field.prepare"):
            pc = field.prepare(params_coarse)
            pf = field.prepare(params_fine) if params_fine is not None else None

        out = []
        with torch.inference_mode():
            for c in range(num_chunks):
                first = c * chunk_size
                with tracing.unit("render.chunk", frame=frame.id if frame else None, first=first):
                    with tracing.span("render.uniforms"):
                        if uniforms_for_chunk is not None:
                            uniforms = uniforms_for_chunk(first, chunk_size)
                        else:
                            gen = torch.Generator(device=device).manual_seed(chunk_seed(seed, first))
                            uniforms = draw_uniforms(gen, chunk_size, settings)
                    rows = slice(first, first + chunk_size)
                    res = render_rays(field, pc, pf, origins[rows], dirs[rows], None, settings, uniforms)
                    out.append(res["rgb_fine"] if settings.hierarchical else res["rgb_coarse"])
        with tracing.span("render.gather"):
            rgb = torch.cat(out, dim=0)[:num_pixels]
            return rgb.reshape(h, w, 3)
