"""Datasets: the procedural test scene, the Blender and the LLFF loaders."""

from torch_nerf_tpu_torch.datasets import llff, synthetic
from torch_nerf_tpu_torch.datasets.blender import PosedImages, load_blender
from torch_nerf_tpu_torch.datasets.llff import llff_holdout_index, llff_t_bounds, load_llff

__all__ = ["PosedImages", "llff", "llff_holdout_index", "llff_t_bounds", "load_blender", "load_llff", "synthetic"]
