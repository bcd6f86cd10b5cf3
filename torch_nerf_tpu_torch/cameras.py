"""Camera model and ray generation on tensors.

Counterpart of ``torch_nerf_tpu/cameras.py:31-178``, with the same
conventions: pixel ``p`` of a row-major ``(H, W)`` image has screen
``x = p % W``, ``y = (H - 1) - p // W``; camera-frame directions are
``((x - cx) / fx, (y - cy) / fy, -1)``, not normalized; world rays are
``d_w = R @ d_c``, ``o_w = t`` for the camera-to-world ``[R | t]``; NDC follows
the official NeRF supplementary applied to world-frame rays.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class CameraParams(NamedTuple):
    """Static pinhole camera description."""

    focal_x: float
    focal_y: float
    img_width: int
    img_height: int

    @property
    def cx(self) -> float:
        return self.img_width / 2.0

    @property
    def cy(self) -> float:
        return self.img_height / 2.0


def generate_screen_coords(img_height: int, img_width: int, device=None) -> torch.Tensor:
    """Screen (x, y) ``(H * W, 2)`` float32 of every pixel, row-major: pixel
    ``p`` has ``x = p % W``, ``y = (H - 1) - p // W`` (the table that
    :func:`screen_coords_from_indices` computes for any subset)."""
    ys = torch.arange(img_height, dtype=torch.float32, device=device)
    xs = torch.arange(img_width, dtype=torch.float32, device=device)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([grid_x, (img_height - 1) - grid_y], dim=-1).reshape(img_height * img_width, 2)


def screen_coords_from_indices(
    pixel_indices: torch.Tensor, img_height: int, img_width: int
) -> torch.Tensor:
    """Screen (x, y) ``(N, 2)`` float32 of flat pixel indices ``(N,)``."""
    idx = pixel_indices.to(torch.int64)
    x = (idx % img_width).to(torch.float32)
    y = ((img_height - 1) - idx // img_width).to(torch.float32)
    return torch.stack([x, y], dim=-1)


def camera_ray_directions(screen_coords: torch.Tensor, camera: CameraParams) -> torch.Tensor:
    """Camera-frame, un-normalized ray directions ``(N, 3)``."""
    x = (screen_coords[:, 0] - camera.cx) / camera.focal_x
    y = (screen_coords[:, 1] - camera.cy) / camera.focal_y
    return torch.stack([x, y, -torch.ones_like(x)], dim=-1)


def rays_from_screen(
    screen_coords: torch.Tensor, camera: CameraParams, extrinsic: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-frame ``(origins, directions)`` for screen coords; ``extrinsic``
    is the 4x4 (or 3x4) camera-to-world matrix."""
    d_cam = camera_ray_directions(screen_coords, camera)
    rot = extrinsic[:3, :3].to(d_cam)
    trans = extrinsic[:3, 3].to(d_cam)
    d_world = d_cam @ rot.T
    return trans.expand_as(d_world), d_world


def ndc_rays(
    ray_origin: torch.Tensor,
    ray_dir: torch.Tensor,
    focal: float,
    z_near: float,
    img_height: int,
    img_width: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project world-frame rays into NDC (forward-facing scenes), on the raw
    origins as the JAX package does."""
    ox, oy, oz = ray_origin.unbind(-1)
    dx, dy, dz = ray_dir.unbind(-1)
    sx = -(2.0 * focal / img_width)
    sy = -(2.0 * focal / img_height)
    origin = torch.stack([sx * (ox / oz), sy * (oy / oz), 1.0 + (2.0 * z_near / oz)], dim=-1)
    direction = torch.stack(
        [sx * ((dx / dz) - (ox / oz)), sy * ((dy / dz) - (oy / oz)), -(2.0 * z_near / oz)],
        dim=-1,
    )
    return origin, direction


def rays_for_pixels(
    pixel_indices: torch.Tensor,
    camera: CameraParams,
    extrinsic: torch.Tensor,
    use_ndc: bool = False,
    ndc_z_near: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat pixel indices -> world (or NDC, with ``focal_x``) rays."""
    coords = screen_coords_from_indices(pixel_indices, camera.img_height, camera.img_width)
    o, d = rays_from_screen(coords, camera, extrinsic)
    if use_ndc:
        o, d = ndc_rays(o, d, camera.focal_x, ndc_z_near, camera.img_height, camera.img_width)
    return o, d
