"""The posed-image container and the Blender ``nerf_synthetic`` loader.

Counterpart of ``torch_nerf_tpu/datasets/blender.py:35-167``, on numpy and
the port's own PNG decoder (the card's host has no PIL):

* ``transforms_{split}.json`` with ``camera_angle_x`` -> focal =
  ``0.5 * W / tan(0.5 * angle_x)``;
* RGBA images scaled to [0, 1]; white where alpha == 0 (the reference's
  hard mask, not alpha blending);
* ``half_res`` halves H, W and the focal, the images by a 2x2 area mean;
* every ``test_idx_skip``-th frame of a non-train split;
* 40 orbital render poses (theta in [-180, 180), phi -30, radius 4).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from torch_nerf_tpu_torch.cameras import CameraParams
from torch_nerf_tpu_torch.datasets.synthetic import orbit_poses
from torch_nerf_tpu_torch.logging_utils import load_png

BLENDER_SCENES = ("chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship")


@dataclasses.dataclass
class PosedImages:
    """``images``: (V, H, W, 3) float32 in [0, 1]; ``poses``: (V, 4, 4)
    camera-to-world; ``camera``: shared intrinsics; ``render_poses``:
    (R, 4, 4) novel-view trajectory."""

    images: np.ndarray
    poses: np.ndarray
    camera: CameraParams
    render_poses: np.ndarray
    image_names: List[str]
    # LLFF-only: per-scene depth bounds
    z_bounds: Optional[np.ndarray] = None

    @property
    def num_views(self) -> int:
        return self.images.shape[0]

    def flat_images(self) -> np.ndarray:
        """(V, H*W, 3) view for the on-device pixel pool."""
        v, h, w, c = self.images.shape
        return self.images.reshape(v, h * w, c)


def _area_downsample_half(img: np.ndarray) -> np.ndarray:
    """2x area downsample (cv2.INTER_AREA at factor 2)."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    img = img[: h2 * 2, : w2 * 2]
    return img.reshape(h2, 2, w2, 2, -1).mean(axis=(1, 3))


def load_blender(
    data_root: str | Path,
    scene_name: str,
    split: str = "train",
    half_res: bool = True,
    white_bg: bool = True,
    test_idx_skip: int = 1,
) -> PosedImages:
    """Load one split of a Blender synthetic scene."""
    if split not in ("train", "val", "test"):
        raise ValueError(f"Unsupported split '{split}'.")
    if (
        scene_name not in BLENDER_SCENES
        and not (Path(data_root) / scene_name / f"transforms_{split}.json").exists()
    ):
        raise ValueError(
            f"Unsupported scene '{scene_name}'. Expected one of {BLENDER_SCENES} or a directory "
            f"under {data_root} holding transforms_{split}.json."
        )
    base = Path(data_root) / scene_name
    meta = json.loads((base / f"transforms_{split}.json").read_text())
    skip = 1 if (split == "train" or test_idx_skip == 0) else test_idx_skip
    frames = meta["frames"][::skip]

    images, poses, names = [], [], []
    for frame in frames:
        img_path = base / f"{frame['file_path']}.png"
        images.append(load_png(img_path).astype(np.float32) / 255.0)
        poses.append(np.asarray(frame["transform_matrix"], dtype=np.float32))
        names.append(img_path.stem)
    imgs = np.stack(images)  # (V, H, W, 4)

    img_height, img_width = imgs.shape[1:3]
    focal = 0.5 * img_width / np.tan(0.5 * float(meta["camera_angle_x"]))
    if half_res:
        img_height //= 2
        img_width //= 2
        focal /= 2.0
        imgs = np.stack([_area_downsample_half(im) for im in imgs])

    if imgs.shape[-1] == 4:
        if white_bg:
            alpha = imgs[..., -1]
            imgs = imgs.copy()
            imgs[alpha == 0.0, :] = 1.0
        imgs = imgs[..., :3]

    return PosedImages(
        images=np.ascontiguousarray(imgs.astype(np.float32)),
        poses=np.stack(poses),
        camera=CameraParams(float(focal), float(focal), int(img_width), int(img_height)),
        render_poses=orbit_poses(40, phi_deg=-30.0, radius=4.0),
        image_names=names,
    )
