"""Procedural analytic scene: dataset-free ground truth.

Counterpart of ``torch_nerf_tpu/datasets/synthetic.py:29-197``: a sum of
coloured Gaussian density blobs rendered with midpoint quadrature, orbital
Blender-style poses, and disjoint train/val/test camera sets.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from torch_nerf_tpu_torch import cameras
from torch_nerf_tpu_torch.ops import integration


@dataclasses.dataclass(frozen=True)
class GaussianBlobScene:
    """sigma(x) = sum_k amp_k exp(-||x - mu_k||^2 / (2 s_k^2)); radiance is
    the density-weighted mix of the blob colours (view independent)."""

    centers: Tuple[Tuple[float, float, float], ...] = (
        (0.0, 0.0, 0.0),
        (0.6, 0.3, -0.2),
        (-0.5, -0.2, 0.4),
    )
    scales: Tuple[float, ...] = (0.45, 0.3, 0.25)
    amplitudes: Tuple[float, ...] = (8.0, 10.0, 10.0)
    colors: Tuple[Tuple[float, float, float], ...] = (
        (0.9, 0.2, 0.2),
        (0.2, 0.9, 0.3),
        (0.25, 0.35, 0.95),
    )

    @classmethod
    def random(cls, seed: int, num_blobs: int = 4) -> "GaussianBlobScene":
        """A seeded scene instance (same draws as the JAX package's)."""
        rng = np.random.default_rng(seed)
        centers = tuple(
            tuple(float(x) for x in rng.uniform(-0.8, 0.8, 3)) for _ in range(num_blobs)
        )
        scales = tuple(float(x) for x in rng.uniform(0.2, 0.5, num_blobs))
        amplitudes = tuple(float(x) for x in rng.uniform(6.0, 12.0, num_blobs))
        colors = []
        for _ in range(num_blobs):
            c = rng.uniform(0.1, 1.0, 3)
            c = c / c.max()
            colors.append(tuple(float(x) for x in c))
        return cls(centers=centers, scales=scales, amplitudes=amplitudes, colors=tuple(colors))

    def field(self, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sigma, rgb) of the analytic field at points (..., 3)."""
        kw = dict(dtype=torch.float32, device=pts.device)
        mu = torch.tensor(self.centers, **kw)
        s = torch.tensor(self.scales, **kw)
        a = torch.tensor(self.amplitudes, **kw)
        c = torch.tensor(self.colors, **kw)
        d2 = torch.sum((pts[..., None, :] - mu) ** 2, dim=-1)
        per_blob = a * torch.exp(-d2 / (2.0 * s**2))
        sigma = torch.sum(per_blob, dim=-1)
        weight = per_blob / (sigma[..., None] + 1e-8)
        return sigma, weight @ c


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Blender-style orbital camera-to-world pose (4, 4)."""
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius

    phi = np.deg2rad(phi_deg)
    rot_x = np.eye(4, dtype=np.float32)
    rot_x[1, 1], rot_x[1, 2] = np.cos(phi), -np.sin(phi)
    rot_x[2, 1], rot_x[2, 2] = np.sin(phi), np.cos(phi)

    theta = np.deg2rad(theta_deg)
    rot_y = np.eye(4, dtype=np.float32)
    rot_y[0, 0], rot_y[0, 2] = np.cos(theta), -np.sin(theta)
    rot_y[2, 0], rot_y[2, 2] = np.sin(theta), np.cos(theta)

    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
    )
    return flip @ rot_y @ rot_x @ trans


def orbit_poses(num_views: int, phi_deg: float = -30.0, radius: float = 4.0) -> np.ndarray:
    """(num_views, 4, 4) poses evenly spaced in azimuth."""
    thetas = np.linspace(-180.0, 180.0, num_views + 1)[:-1]
    return np.stack([pose_spherical(t, phi_deg, radius) for t in thetas])


def render_ground_truth(
    scene: GaussianBlobScene,
    camera: cameras.CameraParams,
    extrinsic: torch.Tensor,
    t_near: float = 2.0,
    t_far: float = 6.0,
    num_samples: int = 256,
) -> torch.Tensor:
    """Midpoint-quadrature render of the analytic scene -> (H, W, 3) on
    ``extrinsic``'s device."""
    device = extrinsic.device
    h, w = camera.img_height, camera.img_width
    num_pixels = h * w
    chunk = 8192  # bounds the (rays, S, 3) sample tensor
    pixel_idx = torch.arange(num_pixels, device=device)
    o, d = cameras.rays_for_pixels(pixel_idx, camera, extrinsic)
    mids = (torch.arange(num_samples, dtype=torch.float32, device=device) + 0.5) / num_samples
    ts = t_near + (t_far - t_near) * mids
    out = []
    for start in range(0, num_pixels, chunk):
        oc, dc = o[start : start + chunk], d[start : start + chunk]
        pts = oc[:, None, :] + ts[None, :, None] * dc[:, None, :]
        sigma, rgb = scene.field(pts)
        delta = torch.full_like(sigma, (t_far - t_near) / num_samples)
        pixel_rgb, _ = integration.composite(sigma, rgb, delta)
        out.append(pixel_rgb)
    return torch.cat(out).reshape(h, w, 3)


# per split: azimuth offset (fraction of the view spacing) and elevation
_SPLIT_VIEWS = {"train": (0.0, -30.0), "val": (1.0 / 3.0, -26.0), "test": (2.0 / 3.0, -34.0)}


def split_poses(num_views: int, split: str, radius: float = 4.0) -> np.ndarray:
    """(num_views, 4, 4) orbital poses for a named split (disjoint sets)."""
    offset_frac, phi = _SPLIT_VIEWS[split]
    spacing = 360.0 / num_views
    thetas = -180.0 + spacing * (np.arange(num_views) + offset_frac)
    return np.stack([pose_spherical(t, phi, radius) for t in thetas])


def make_dataset(
    num_views: int = 8,
    img_size: int = 64,
    focal: Optional[float] = None,
    scene: Optional[GaussianBlobScene] = None,
    t_near: float = 2.0,
    t_far: float = 6.0,
    split: str = "train",
    device: Optional[torch.device] = None,
) -> Tuple[np.ndarray, np.ndarray, cameras.CameraParams, GaussianBlobScene]:
    """``(images (V, H*W, 3) float32 numpy, poses (V, 4, 4), camera,
    scene)``; the ground truth is rendered on ``device``."""
    scene = scene or GaussianBlobScene()
    focal = focal if focal is not None else 1.2 * img_size
    camera = cameras.CameraParams(focal_x=focal, focal_y=focal, img_width=img_size, img_height=img_size)
    poses = split_poses(num_views, split)
    images = np.stack(
        [
            render_ground_truth(scene, camera, torch.as_tensor(p, device=device), t_near, t_far)
            .cpu()
            .numpy()
            for p in poses
        ]
    )
    return images.reshape(num_views, -1, 3), poses, camera, scene
