"""The posed-image container shared by the datasets.

Counterpart of ``torch_nerf_tpu/datasets/blender.py:36``. The Blender
``nerf_synthetic`` loader itself comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from torch_nerf_tpu_torch.cameras import CameraParams


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

