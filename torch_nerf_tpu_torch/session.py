"""Session factory: config -> dataset, render settings, field.

Counterpart of ``torch_nerf_tpu/session.py:26-199`` for the render slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from torch_nerf_tpu_torch import config as cfg_mod
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.datasets.blender import PosedImages
from torch_nerf_tpu_torch.fields import Field, make_nerf_field
from torch_nerf_tpu_torch.renderer import RenderSettings


def build_dataset(
    cfg: cfg_mod.ExperimentConfig, split: str = "train", device: Optional[torch.device] = None
) -> PosedImages:
    """The dataset named by the config. ``gaussian_blobs`` val/test splits
    are served at 2x the training size when ``data.half_res`` (the
    evaluate-at-full-resolution contract); the ground truth is rendered on
    ``device``."""
    data = cfg.data
    if data.dataset_type == "gaussian_blobs":
        size = data.img_size
        if split != "train" and data.half_res:
            size *= 2
        images, poses, camera, _ = synthetic.make_dataset(
            num_views=data.num_views, img_size=size, split=split, device=device
        )
        v = images.shape[0]
        return PosedImages(
            images=images.reshape(v, size, size, 3),
            poses=poses,
            camera=camera,
            render_poses=synthetic.orbit_poses(40),
            image_names=[f"blob_{split}_{i:03d}" for i in range(v)],
        )
    if data.dataset_type in ("nerf_synthetic", "nerf_llff"):
        raise NotImplementedError(
            f"dataset_type '{data.dataset_type}' comes with the port's training "
            "slice (Blender and LLFF loaders); use gaussian_blobs"
        )
    raise ValueError(f"Unsupported dataset_type '{data.dataset_type}'.")


def build_render_settings(
    cfg: cfg_mod.ExperimentConfig, dataset: Optional[PosedImages] = None
) -> RenderSettings:
    r = cfg.renderer
    if dataset is not None and dataset.z_bounds is not None:
        raise NotImplementedError("LLFF depth bounds come with the port's training slice")
    return RenderSettings(
        num_samples_coarse=r.num_samples_coarse,
        num_samples_fine=r.num_samples_fine,
        t_near=r.t_near,
        t_far=r.t_far,
        project_to_ndc=r.project_to_ndc,
    )


def build_field(cfg: cfg_mod.ExperimentConfig) -> Field:
    """Field from the network + signal_encoder groups. ``parallel.use_pallas``
    None or true takes the fused kernel, which decides by the tensors'
    device (and raises on the card for a compute_dtype other than bfloat16);
    false takes the plain version."""
    net = cfg.network
    enc = cfg.signal_encoder
    compute_dtype = getattr(torch, cfg.device.compute_dtype)
    if net.type != "nerf":
        raise NotImplementedError(
            f"network.type '{net.type}' comes with the port's Instant-NGP slice"
        )
    if enc.type != "pe":
        raise ValueError("The classic NeRF network expects positional encoding.")
    return make_nerf_field(
        pos_dim=net.pos_dim,
        view_dir_dim=net.view_dir_dim,
        coord_encode_level=enc.coord_encode_level,
        dir_encode_level=enc.dir_encode_level,
        include_input=enc.include_input,
        feat_dim=net.feat_dim,
        compute_dtype=compute_dtype,
        use_kernel=cfg.parallel.use_pallas,
    )
