"""Session factory: config -> dataset, render settings, field, optimizer
config, and the FLOP count of a train step.

Counterpart of ``torch_nerf_tpu/session.py`` for the classic NeRF and the
Instant-NGP field (``hash`` and ``bricked`` layouts): LLFF, multi-scene
datasets, occupancy and the packed layouts' smoothness loss come with later
slices and raise here.
"""

from __future__ import annotations

from typing import Optional

import torch

from torch_nerf_tpu_torch import config as cfg_mod
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.datasets.blender import PosedImages, load_blender
from torch_nerf_tpu_torch.encoders import positional_encoding_dim
from torch_nerf_tpu_torch.fields import Field, make_nerf_field
from torch_nerf_tpu_torch.fields_ngp import make_instant_ngp_field
from torch_nerf_tpu_torch.models.nerf import layer_dims
from torch_nerf_tpu_torch.renderer import RenderSettings
from torch_nerf_tpu_torch.train import OptimConfig


def build_dataset(
    cfg: cfg_mod.ExperimentConfig, split: str = "train", device: Optional[torch.device] = None
) -> PosedImages:
    """The dataset named by the config. Val and test splits are served at
    full resolution whatever ``data.half_res`` says (the reference loads them
    with ``half_res=False``); for ``gaussian_blobs`` that is 2x the training
    size when ``data.half_res``, its ground truth rendered on ``device``."""
    data = cfg.data
    if data.dataset_type == "nerf_synthetic":
        return load_blender(
            data.data_root,
            data.scene_name,
            split=split,
            half_res=data.half_res if split == "train" else False,
            white_bg=data.white_bg,
        )
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
    if data.dataset_type == "nerf_llff":
        raise NotImplementedError(
            "dataset_type 'nerf_llff' comes with the port's LLFF + NDC slice "
            "(ROADMAP Queue 1, the item after training)"
        )
    raise ValueError(f"Unsupported dataset_type '{data.dataset_type}'.")


def build_render_settings(
    cfg: cfg_mod.ExperimentConfig, dataset: Optional[PosedImages] = None
) -> RenderSettings:
    r = cfg.renderer
    if dataset is not None and dataset.z_bounds is not None:
        raise NotImplementedError("LLFF depth bounds come with the port's LLFF + NDC slice")
    return RenderSettings(
        num_samples_coarse=r.num_samples_coarse,
        num_samples_fine=r.num_samples_fine,
        t_near=r.t_near,
        t_far=r.t_far,
        project_to_ndc=r.project_to_ndc,
    )


def build_field(cfg: cfg_mod.ExperimentConfig) -> Field:
    """Field from the network + signal_encoder groups. ``parallel.use_pallas``
    None or true takes the kernels, which decide by the tensors' device (the
    fused NeRF kernel raises on the card for a compute_dtype other than
    bfloat16); false takes the plain versions."""
    net = cfg.network
    enc = cfg.signal_encoder
    compute_dtype = getattr(torch, cfg.device.compute_dtype)
    if net.type == "instant_nerf":
        return make_instant_ngp_field(
            num_level=net.num_level,
            log_max_entry_per_level=net.log_max_entry_per_level,
            table_feat_dim=net.table_feat_dim,
            min_res=net.min_res,
            max_res=net.max_res,
            sh_degree=enc.degree,
            compute_dtype=compute_dtype,
            table_layout=net.table_layout,
            use_kernel=cfg.parallel.use_pallas,
        )
    if net.type != "nerf":
        raise ValueError(f"Unsupported network type '{net.type}'.")
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


def build_aux_loss(cfg: cfg_mod.ExperimentConfig):
    """The objective group's regularizer: None, as
    ``objective.encode_smoothness_weight`` is 0 unless a packed layout asks
    for its voxel-face penalty, which comes with the port's packed-layout
    slice."""
    if cfg.objective.encode_smoothness_weight <= 0.0:
        return None
    net = cfg.network
    if net.type != "instant_nerf" or net.table_layout not in ("packed", "packed_dual"):
        raise ValueError(
            "encode_smoothness_weight applies to the packed instant-NGP layouts; got "
            f"network.type='{net.type}', table_layout='{net.table_layout}'."
        )
    raise NotImplementedError("the smoothness loss comes with the port's packed-layout slice")


def build_optim_config(cfg: cfg_mod.ExperimentConfig) -> OptimConfig:
    o = cfg.train_params.optim
    if o.optim_type != "adam" or o.scheduler_type != "exp":
        raise ValueError(f"Unsupported optimizer/scheduler '{o.optim_type}'/'{o.scheduler_type}'.")
    # the objective and scene groups mirror the reference's tree; one value
    # of each exists: reject anything else instead of ignoring it
    if cfg.objective.loss_type != "nerf_default":
        raise ValueError(f"Unsupported loss_type '{cfg.objective.loss_type}'.")
    if cfg.scene.type != "cube":
        raise ValueError(f"Unsupported scene type '{cfg.scene.type}'.")
    return OptimConfig(
        num_iter=o.num_iter,
        init_lr=o.init_lr,
        end_lr=o.end_lr,
        eps=o.eps,
        table_weight_decay=o.table_weight_decay,
    )


def estimate_flops_per_step(cfg: cfg_mod.ExperimentConfig) -> float:
    """Approximate train-step FLOPs (forward + backward = 3x forward) for
    the MFU gauge: the MLP's multiply-adds per sample point times the
    step's points (rays x (coarse + merged fine) samples)."""
    net, enc, r = cfg.network, cfg.signal_encoder, cfg.renderer
    if net.type == "nerf":
        pos_dim = positional_encoding_dim(net.pos_dim, enc.coord_encode_level, enc.include_input)
        dir_dim = positional_encoding_dim(net.view_dir_dim, enc.dir_encode_level, enc.include_input)
        macs = sum(i * o for i, o in layer_dims(pos_dim, dir_dim, net.feat_dim).values())
    else:  # instant_nerf: density (LF->64->16) + color (16+sh -> 64 -> 64 -> 3)
        lf = net.num_level * net.table_feat_dim
        if net.table_layout == "packed_dual":
            lf *= 2
        sh_dim = enc.degree**2 if enc.type == "sh" else 27
        macs = (lf * 64 + 64 * 64 + 64 * 16) + ((16 + sh_dim) * 64 + 64 * 64 + 64 * 3)
    coarse = r.num_samples_coarse
    fine = r.num_samples_coarse + r.num_samples_fine  # merged fine set
    if cfg.occupancy.enabled:
        coarse = min(cfg.occupancy.keep_samples, coarse)
        if cfg.occupancy.keep_samples_fine:
            fine = min(cfg.occupancy.keep_samples_fine, fine)
    samples = coarse + fine if r.num_samples_fine > 0 else coarse
    return 3.0 * 2.0 * macs * r.num_pixels * samples
