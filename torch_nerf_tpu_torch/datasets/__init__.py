"""Datasets: the procedural test scene and the Blender loader (the LLFF
loader comes with its own slice)."""

from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.datasets.blender import PosedImages, load_blender

__all__ = ["PosedImages", "load_blender", "synthetic"]
