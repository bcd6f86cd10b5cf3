"""Datasets: the procedural test scene (Blender and LLFF loaders come with
the training slice)."""

from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.datasets.blender import PosedImages

__all__ = ["PosedImages", "synthetic"]
