"""Every input of a run, made from ``--seed``: weights, the scene's images
and poses, and the uniform draws of each step and render chunk.

The same seed gives the same inputs, on the device they are made on. Each
purpose takes a seed of its own, hashed from the run's seed and the
purpose's name, so an input does not change when another is added. The
weights are drawn on the device in one call and cut into leaves; the
images are a procedural scene of seeded Gaussian blobs rendered by
midpoint quadrature on the device; the poses look at the origin from the
upper hemisphere, as Blender's views do.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from nerfbench.reference import volume
from torch_nerf_tpu_torch import cameras
from torch_nerf_tpu_torch.renderer import RayUniforms
from torch_nerf_tpu_torch.train import ImageDraws


def subseed(seed: int, *purpose) -> int:
    """A 63-bit seed for ``purpose`` of run ``seed``."""
    text = ":".join(str(p) for p in (seed, *purpose)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, purpose))


# ---------------------------------------------------------------------------
# weights


def weights(layout, seed: int, device, mlp_gain: float, table_bound: float) -> Dict:
    """A parameter tree of ``layout`` (``(path, shape, kind, fan_in)``):
    linear leaves ``U(-g / sqrt(fan_in), g / sqrt(fan_in))`` with ``g =
    mlp_gain`` (1 is PyTorch's default init, sqrt(6) He's), tables
    ``U(-table_bound, table_bound)``."""
    sizes = [math.prod(shape) for _, shape, _, _ in layout]
    u = torch.rand(sum(sizes), generator=generator(seed, "weights", device), device=device)
    tree: Dict = {}
    start = 0
    for (path, shape, kind, fan_in), size in zip(layout, sizes):
        bound = table_bound if kind == "table" else mlp_gain / math.sqrt(fan_in)
        leaf = (2.0 * u[start:start + size] - 1.0).mul_(bound).reshape(shape)
        start += size
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.detach().clone()


# ---------------------------------------------------------------------------
# the scene


def focal(size: int, camera_angle_x: float) -> float:
    return 0.5 * size / math.tan(0.5 * camera_angle_x)


def camera(size: int, camera_angle_x: float) -> cameras.CameraParams:
    f = focal(size, camera_angle_x)
    return cameras.CameraParams(focal_x=f, focal_y=f, img_width=size, img_height=size)


def look_at_origin(theta: float, phi: float, radius: float) -> np.ndarray:
    """Camera-to-world (4, 4) at azimuth ``theta`` and elevation ``phi``
    (radians) on a sphere of ``radius``, looking at the origin, z up."""
    eye = radius * np.array([math.cos(phi) * math.cos(theta), math.cos(phi) * math.sin(theta), math.sin(phi)])
    back = eye / np.linalg.norm(eye)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, up, back, eye
    return pose.astype(np.float32)


def poses(seed: int, split: str, count: int, radius: float, device) -> torch.Tensor:
    """``(count, 4, 4)`` poses on the upper hemisphere, 10-80 degrees up."""
    rng = np.random.default_rng(subseed(seed, "poses", split))
    thetas = rng.uniform(-math.pi, math.pi, count)
    phis = rng.uniform(math.radians(10.0), math.radians(80.0), count)
    return torch.as_tensor(np.stack([look_at_origin(t, p, radius) for t, p in zip(thetas, phis)]), device=device)


def blob_scene(seed: int, num_blobs: int = 6) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(subseed(seed, "scene"))
    return {
        "centers": rng.uniform(-0.8, 0.8, (num_blobs, 3)),
        "scales": rng.uniform(0.15, 0.5, num_blobs),
        "amplitudes": rng.uniform(4.0, 12.0, num_blobs),
        "colors": rng.uniform(0.05, 1.0, (num_blobs, 3)),
    }


def render_blobs(scene: Dict[str, np.ndarray], cam: cameras.CameraParams, pose_stack: torch.Tensor, near: float,
                 far: float, samples: int, rays_per_call: int = 1 << 20) -> torch.Tensor:
    """``(V, H * W, 3)`` images of the blob scene, midpoint quadrature of
    ``samples`` points a ray, in batches of rays."""
    dev = pose_stack.device
    mu, s, a, c = (torch.as_tensor(scene[k], dtype=torch.float32, device=dev)
                   for k in ("centers", "scales", "amplitudes", "colors"))
    h, w = cam.img_height, cam.img_width
    pixels = torch.arange(h * w, device=dev)
    t = near + (far - near) * (torch.arange(samples, dtype=torch.float32, device=dev) + 0.5) / samples
    delta = (far - near) / samples
    images = []
    for pose in pose_stack:
        o, d = volume.pixel_rays(pixels, h, w, cam.focal_x, pose)
        rows = []
        for a0 in range(0, h * w, max(1, rays_per_call // samples)):
            sl = slice(a0, a0 + max(1, rays_per_call // samples))
            pts = o[sl, None, :] + t[None, :, None] * d[sl, None, :]
            per = a * torch.exp(-torch.sum((pts[..., None, :] - mu) ** 2, dim=-1) / (2.0 * s**2))
            sigma = per.sum(-1)
            rgb = (per / (sigma[..., None] + 1e-8)) @ c
            alpha = 1.0 - torch.exp(-sigma * delta)
            trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1] + 1e-10], -1), -1)
            rows.append(torch.sum((trans * alpha)[..., None] * rgb, dim=1))
        images.append(torch.cat(rows))
    return torch.stack(images)


def train_scene(scene_cfg: Dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor, cameras.CameraParams]:
    """``(images (V, H * W, 3), poses (V, 4, 4), camera)`` of the train
    split."""
    cam = camera(scene_cfg["train_size"], scene_cfg["camera_angle_x"])
    pose_stack = poses(seed, "train", scene_cfg["train_views"], scene_cfg["radius"], device)
    images = render_blobs(blob_scene(seed), cam, pose_stack, scene_cfg["near"], scene_cfg["far"],
                          scene_cfg["image_samples"])
    return images, pose_stack, cam


# ---------------------------------------------------------------------------
# draws


def brightness_ranks(num_rays: int) -> torch.Tensor:
    """For each position of a step's batch, the brightness rank (0 the
    brightest) of the pixel that it holds: the first half holds the
    brighter half, its even positions the brightest quarter and its odd
    ones the second; the second half the other two quarters alike. So any
    natural half of the batch (first or second, even or odd positions)
    differs from the whole, and a step that leaves one out reads so."""
    if num_rays % 4:
        raise ValueError(f"a batch of {num_rays} rays is not four equal quarters")
    q = num_rays // 4
    k = torch.arange(num_rays // 2)
    first = k // 2 + (k % 2) * q
    return torch.cat([first, first + 2 * q])


def image_draws(gen: torch.Generator, num_images: int, num_pixels: int, num_rays: int, coarse: int,
                fine: int) -> ImageDraws:
    """One image train step's draws, in the layout of the port's
    ``ImageDraws``: the image, the uniforms whose top ``num_rays`` pick its
    pixels, and the render's four uniform draws."""
    dev = gen.device
    idx = torch.randint(0, num_images, (), generator=gen, device=dev)
    pixel_u = torch.rand((num_pixels,), generator=gen, device=dev)
    return ImageDraws(idx, pixel_u, ray_uniforms(gen, num_rays, coarse, fine))


def by_brightness(draws: ImageDraws, luma: torch.Tensor, num_rays: int) -> ImageDraws:
    """The same draws with the picked pixels' uniforms dealt out again
    among themselves, so that the top-k's order puts each pixel at the
    position that :func:`brightness_ranks` gives its brightness rank in
    ``luma (V, H * W)``: the same pixels and ray draws, in another order."""
    top = torch.topk(draws.pixel_u, num_rays)
    bright = luma[int(draws.image_index)][top.indices]
    by_rank = torch.argsort(bright, descending=True, stable=True)
    pos_of_rank = torch.argsort(brightness_ranks(num_rays)).to(top.values.device)
    pixel_u = draws.pixel_u.clone()
    pixel_u[top.indices[by_rank]] = top.values[pos_of_rank]
    return draws._replace(pixel_u=pixel_u)


def ray_uniforms(gen: torch.Generator, num_rays: int, coarse: int, fine: int) -> RayUniforms:
    dev = gen.device
    return RayUniforms(
        coarse=torch.rand((num_rays, coarse), generator=gen, device=dev),
        fine_coarse=torch.rand((num_rays, coarse), generator=gen, device=dev),
        u=torch.rand((num_rays, fine), generator=gen, device=dev),
        fine=torch.rand((num_rays, fine), generator=gen, device=dev),
    )


def chunk_uniforms(seed: int, frame: int, first: int, size: int, coarse: int, fine: int, device) -> RayUniforms:
    """The draws of the render chunk of frame ``frame`` that starts at
    pixel ``first``."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "chunk", frame, first))
    return ray_uniforms(gen, size, coarse, fine)


def sample(seed: int, purpose: str, population: int, count: int) -> List[int]:
    """``count`` distinct indices of ``range(population)`` (all of them when
    fewer), sorted."""
    rng = np.random.default_rng(subseed(seed, purpose))
    return sorted(rng.choice(population, size=min(count, population), replace=False).tolist())
