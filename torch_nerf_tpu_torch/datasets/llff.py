"""The LLFF (forward-facing) loader.

Counterpart of ``torch_nerf_tpu/datasets/llff.py:39-306``, in numpy as the
JAX loader is:

* ``poses_bounds.npy``: N rows of 17 floats, a 3x5 matrix ([R | t | (H, W,
  f)]) and the (near, far) depth bounds of the view;
* the LLFF -> NeRF column swap ([down, right, back] -> [right, up, back]);
* the ``bd_factor`` rescale, so that the least depth is about 1/bd_factor;
* recentring of every pose about the average pose, or spherification of a
  360 capture with its circular render path; else a spiral render path;
* the ``factor`` downscale by exact area pooling in numpy, cached under
  ``images_{factor}/`` (written to a temporary directory, then renamed; a
  cache holding fewer images than the source is stale and is rebuilt).
  The first load returns the pooled floats, later loads the cached 8-bit
  PNGs, as in the JAX loader;
* the holdout view (``llff_holdout_index``) and the t-bounds
  (``llff_t_bounds``).

Images are read with the port's PNG decoder; other formats need PIL.
"""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from torch_nerf_tpu_torch.cameras import CameraParams
from torch_nerf_tpu_torch.datasets.blender import PosedImages
from torch_nerf_tpu_torch.logging_utils import load_png, save_png

LLFF_SCENES = ("fern", "flower", "fortress", "horns", "leaves", "orchids", "room", "trex")

_IMG_EXTS = (".jpg", ".JPG", ".jpeg", ".png", ".PNG")


def _imread(path: Path) -> np.ndarray:
    """An image file -> (H, W, C) uint8: PNGs by the port's decoder, other
    formats through PIL where it is installed."""
    if path.suffix.lower() == ".png":
        return load_png(path)
    try:
        from PIL import Image  # noqa: PLC0415
    except ImportError as err:
        raise ValueError(f"{path.name}: only PNG images can be read without PIL") from err
    return np.asarray(Image.open(path))


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def _view_matrix(z_vec: np.ndarray, up: np.ndarray, position: np.ndarray) -> np.ndarray:
    """Camera-to-world 3x4 from the forward axis, an up hint and the position."""
    z = _normalize(z_vec)
    x = _normalize(np.cross(up, z))
    y = _normalize(np.cross(z, x))
    return np.stack([x, y, z, position], axis=1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """The central pose (3, 4): the mean position, the summed z-axes as
    forward, the summed y-axes as the up hint."""
    center = poses[:, :3, 3].mean(axis=0)
    z = _normalize(poses[:, :3, 2].sum(axis=0))
    up = poses[:, :3, 1].sum(axis=0)
    return _view_matrix(z, up, center)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Every pose relative to the average pose."""
    avg = np.eye(4, dtype=poses.dtype)
    avg[:3, :4] = average_pose(poses)
    bottom = np.broadcast_to(np.array([0, 0, 0, 1], dtype=poses.dtype), (poses.shape[0], 1, 4))
    homog = np.concatenate([poses[:, :3, :4], bottom], axis=1)
    recentered = np.linalg.inv(avg) @ homog
    out = poses.copy()
    out[:, :3, :4] = recentered[:, :3, :4]
    return out


def spiral_render_path(
    c2w: np.ndarray,
    up: np.ndarray,
    radii: np.ndarray,
    focus_depth: float,
    z_rate: float = 0.5,
    num_rotations: int = 2,
    num_keyframes: int = 120,
) -> np.ndarray:
    """A spiral of poses about the central camera, looking at the focus depth."""
    render_poses = []
    radii4 = np.asarray(list(radii) + [1.0])
    for theta in np.linspace(0.0, 2.0 * np.pi * num_rotations, num_keyframes + 1)[:-1]:
        offsets = np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * z_rate), 1.0]) * radii4
        position = c2w[:3, :4] @ offsets
        focus_point = c2w[:3, :4] @ np.array([0.0, 0.0, -focus_depth, 1.0])
        render_poses.append(_view_matrix(_normalize(position - focus_point), up, position))
    return np.stack(render_poses).astype(np.float32)


def spherify_poses(poses: np.ndarray, bounds: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Recentre a 360 capture on the point nearest every camera axis, scale
    it to the unit sphere and make a circular render path."""
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]
    a_i = np.eye(3) - rays_d * rays_d.transpose(0, 2, 1)
    b_i = -a_i @ rays_o
    center = np.squeeze(-np.linalg.inv((a_i.transpose(0, 2, 1) @ a_i).mean(0)) @ b_i.mean(0))

    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross(np.array([0.1, 0.2, 0.3]), vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    frame44 = np.eye(4)
    frame44[:3, :4] = np.stack([vec1, vec2, vec0, center], axis=1)
    bottom = np.broadcast_to(np.array([0, 0, 0, 1.0]), (poses.shape[0], 1, 4))
    homog = np.concatenate([poses[:, :3, :4], bottom], axis=1)
    poses_reset = (np.linalg.inv(frame44) @ homog)[:, :3, :4]

    radius = np.sqrt(np.mean(np.sum(poses_reset[:, :3, 3] ** 2, axis=-1)))
    scale = 1.0 / radius
    poses_reset[:, :3, 3] *= scale
    bounds = bounds * scale
    radius *= scale

    zh = poses_reset[:, :3, 3].mean(0)[2]
    circle_radius = np.sqrt(radius**2 - zh**2)
    new_poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi, 120):
        position = np.array([circle_radius * np.cos(theta), circle_radius * np.sin(theta), zh])
        z_vec = _normalize(position)
        x_vec = _normalize(np.cross(z_vec, np.array([0.0, 0.0, -1.0])))
        y_vec = _normalize(np.cross(z_vec, x_vec))
        new_poses.append(np.stack([x_vec, y_vec, z_vec, position], axis=1))
    render_poses = np.stack(new_poses).astype(np.float32)
    return poses_reset.astype(np.float32), render_poses, bounds.astype(np.float32)


def _area_downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Integer-factor area pooling -> float32 in the input's range."""
    h2, w2 = img.shape[0] // factor, img.shape[1] // factor
    img = img[: h2 * factor, : w2 * factor].astype(np.float32)
    return img.reshape(h2, factor, w2, factor, -1).mean(axis=(1, 3))


def _list_images(img_dir: Path):
    return sorted(p for p in img_dir.iterdir() if p.suffix in _IMG_EXTS)


def _load_images(base: Path, factor: int):
    """(images (V, H, W, 3) float32 in [0, 1], their files), downscaled by
    ``factor`` through the ``images_{factor}/`` cache."""
    img_dir = base / "images"
    if not factor or factor <= 1:
        files = _list_images(img_dir)
        return np.stack([_imread(f).astype(np.float32)[..., :3] / 255.0 for f in files]), files
    cache = base / f"images_{factor}"
    if cache.exists() and len(_list_images(cache)) == len(_list_images(img_dir)):
        files = _list_images(cache)
        return np.stack([_imread(f).astype(np.float32)[..., :3] / 255.0 for f in files]), files
    files = _list_images(img_dir)
    minified = [_area_downsample(_imread(f)[..., :3], factor) for f in files]
    # best effort: a read-only data root just pools again next time
    try:
        tmp_dir = Path(tempfile.mkdtemp(prefix=f".images_{factor}.", dir=base))
        for f, img in zip(files, minified):
            save_png(tmp_dir / f"{f.stem}.png", img / 255.0)
        if cache.exists():  # a stale cache
            shutil.rmtree(cache)
        tmp_dir.rename(cache)
    except OSError:
        pass
    return np.stack(minified).astype(np.float32) / 255.0, files


def load_llff(
    data_root: str | Path,
    scene_name: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: Optional[float] = 0.75,
    spherify: bool = False,
) -> PosedImages:
    """An LLFF scene -> :class:`PosedImages` with its ``z_bounds``; every
    view, the holdout included (see :func:`llff_holdout_index`)."""
    if scene_name not in LLFF_SCENES:
        raise ValueError(f"Unsupported scene '{scene_name}'. Expected one of {LLFF_SCENES}.")
    base = Path(data_root) / scene_name
    raw = np.load(base / "poses_bounds.npy")  # (N, 17)
    poses_raw = raw[:, :-2].reshape(-1, 3, 5)
    bounds = raw[:, -2:].astype(np.float32)
    poses = poses_raw[:, :, :4].astype(np.float32)
    hwf = poses_raw[:, :, 4].astype(np.float32)  # H, W, focal
    poses = np.concatenate([poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], axis=2)

    images, files = _load_images(base, factor)
    if images.shape[0] != poses.shape[0]:
        raise ValueError(f"Image/pose count mismatch: {images.shape[0]} vs {poses.shape[0]}.")
    img_height, img_width = images.shape[1:3]
    focal = float(hwf[0, 2]) * (img_height / float(hwf[0, 0]))

    scale = 1.0 if bd_factor is None else 1.0 / (bounds.min() * bd_factor)
    poses[:, :3, 3] *= scale
    bounds = bounds * scale
    if recenter:
        poses = recenter_poses(poses)
    if spherify:
        poses, render_poses, bounds = spherify_poses(poses, bounds)
    else:
        avg = average_pose(poses)
        up = _normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bounds.min() * 0.9, bounds.max() * 5.0
        dt = 0.75
        focus_depth = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        radii = np.percentile(np.abs(poses[:, :3, 3]), 90, axis=0)
        render_poses = spiral_render_path(avg, up, radii, focus_depth, z_rate=0.5, num_rotations=2,
                                          num_keyframes=120)

    def to44(p34: np.ndarray) -> np.ndarray:
        out = np.broadcast_to(np.eye(4, dtype=np.float32), (p34.shape[0], 4, 4)).copy()
        out[:, :3, :4] = p34[:, :3, :4]
        return out

    return PosedImages(
        images=np.ascontiguousarray(images.astype(np.float32)),
        poses=to44(poses),
        camera=CameraParams(focal, focal, int(img_width), int(img_height)),
        render_poses=to44(render_poses),
        image_names=[f.stem for f in files],
        z_bounds=bounds,
    )


def llff_holdout_index(poses: np.ndarray) -> int:
    """The view nearest the average pose."""
    avg = average_pose(poses[:, :3, :4])
    return int(np.argmin(np.sum((avg[:3, 3] - poses[:, :3, 3]) ** 2, axis=-1)))


def llff_t_bounds(z_bounds: np.ndarray, project_to_ndc: bool) -> Tuple[float, float]:
    """(t_near, t_far): (0, 1) under NDC, else (0.9 min z, max z)."""
    if project_to_ndc:
        return 0.0, 1.0
    return float(z_bounds.min() * 0.9), float(z_bounds.max() * 1.0)
