"""Session factory: config -> dataset, render settings, field, optimizer
config, and the FLOP count of a train step.

Counterpart of ``torch_nerf_tpu/session.py`` for the classic NeRF and the
Instant-NGP field (every table layout, and the packed layouts' smoothness
loss), the Blender, LLFF and procedural datasets, occupancy pruning, and
the scenes of a multi-scene run (:func:`build_multiscene_dataset`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from torch_nerf_tpu_torch import config as cfg_mod
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.datasets.blender import PosedImages, load_blender
from torch_nerf_tpu_torch.datasets.llff import llff_holdout_index, llff_t_bounds, load_llff
from torch_nerf_tpu_torch.encoders import positional_encoding_dim, sh_encoding_dim
from torch_nerf_tpu_torch.fields import Field, make_nerf_field
from torch_nerf_tpu_torch.fields_ngp import make_encode_smoothness_loss, make_instant_ngp_field
from torch_nerf_tpu_torch.models import instant_ngp
from torch_nerf_tpu_torch.models.nerf import layer_dims
from torch_nerf_tpu_torch.occupancy import OccupancyConfig
from torch_nerf_tpu_torch.ops import fused_nerf
from torch_nerf_tpu_torch.renderer import RenderSettings
from torch_nerf_tpu_torch.train import OptimConfig


def build_dataset(
    cfg: cfg_mod.ExperimentConfig, split: str = "train", device: Optional[torch.device] = None
) -> PosedImages:
    """The dataset named by the config. Val and test splits are served at
    full resolution whatever ``data.half_res`` says (the reference loads them
    with ``half_res=False``); for ``gaussian_blobs`` that is 2x the training
    size when ``data.half_res``, its ground truth rendered on ``device``.
    LLFF ships no split files: the view nearest the average pose is held
    out, ``train`` is every other view and ``val``/``test`` that one."""
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
        full = load_llff(data.data_root, data.scene_name, factor=data.factor, recenter=data.recenter,
                         bd_factor=data.bd_factor, spherify=data.spherify)
        holdout = llff_holdout_index(full.poses)
        keep = [i for i in range(full.num_views) if i != holdout] if split == "train" else [holdout]
        return dataclasses.replace(full, images=full.images[keep], poses=full.poses[keep],
                                   image_names=[full.image_names[i] for i in keep])
    raise ValueError(f"Unsupported dataset_type '{data.dataset_type}'.")


def multiscene_scene_names(cfg: cfg_mod.ExperimentConfig) -> list:
    """The per-scene names of a multi-scene run: ``data.scene_name`` as a
    comma-separated list (``scene_name=lego,ship`` with ``num_scenes=2``)."""
    names = [s.strip() for s in cfg.data.scene_name.split(",") if s.strip()]
    if len(names) != cfg.data.num_scenes:
        raise ValueError(
            f"data.num_scenes={cfg.data.num_scenes} needs that many "
            f"comma-separated names in data.scene_name; got {names}."
        )
    return names


def build_multiscene_dataset(
    cfg: cfg_mod.ExperimentConfig, scene_idx: int, split: str = "train", device: Optional[torch.device] = None
) -> PosedImages:
    """Scene ``scene_idx`` of a multi-scene run (the train CLI's pools,
    ``run_render --scene``). ``gaussian_blobs`` scene s is
    ``GaussianBlobScene.random(seed * 1000 + s)``, its ground truth rendered
    on ``device``, so render and evaluate rebuild scene s's exactly;
    ``nerf_synthetic`` scenes come from the comma-separated
    ``data.scene_name``. Val and test splits at full resolution, as in
    :func:`build_dataset`."""
    data = cfg.data
    if data.dataset_type == "gaussian_blobs":
        size = data.img_size
        if split != "train" and data.half_res:
            size *= 2
        scene = synthetic.GaussianBlobScene.random(cfg.seed * 1000 + scene_idx)
        images, poses, camera, _ = synthetic.make_dataset(
            num_views=data.num_views, img_size=size, scene=scene, split=split, device=device
        )
        v = images.shape[0]
        return PosedImages(
            images=images.reshape(v, size, size, 3),
            poses=poses,
            camera=camera,
            render_poses=synthetic.orbit_poses(40),
            image_names=[f"blob{scene_idx}_{split}_{i:03d}" for i in range(v)],
        )
    if data.dataset_type == "nerf_synthetic":
        return load_blender(
            data.data_root,
            multiscene_scene_names(cfg)[scene_idx],
            split=split,
            half_res=data.half_res if split == "train" else False,
            white_bg=data.white_bg,
        )
    raise ValueError(
        "Multi-scene training supports dataset_type gaussian_blobs or "
        f"nerf_synthetic; got '{data.dataset_type}'."
    )


def build_render_settings(
    cfg: cfg_mod.ExperimentConfig, dataset: Optional[PosedImages] = None
) -> RenderSettings:
    """RenderSettings from the config; a dataset with depth bounds (LLFF)
    rewrites the t-bounds through :func:`llff_t_bounds`."""
    r = cfg.renderer
    t_near, t_far = r.t_near, r.t_far
    if dataset is not None and dataset.z_bounds is not None:
        t_near, t_far = llff_t_bounds(dataset.z_bounds, r.project_to_ndc)
    return RenderSettings(
        num_samples_coarse=r.num_samples_coarse,
        num_samples_fine=r.num_samples_fine,
        t_near=t_near,
        t_far=t_far,
        project_to_ndc=r.project_to_ndc,
    )


def build_field(cfg: cfg_mod.ExperimentConfig) -> Field:
    """Field from the network + signal_encoder groups. ``parallel.use_pallas``
    None or true takes the kernels, which decide by the tensors' device (on
    the card the fused NeRF kernels take bfloat16 or float32 at any
    feat_dim up to 1024 with encodings up to 128 wide, on the route
    ``fused_nerf.forward_route`` picks, and raise past that); false takes
    the plain versions."""
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


def check_trainable(cfg: cfg_mod.ExperimentConfig, device: torch.device) -> None:
    """Raise, before any data loads, when training ``cfg`` on ``device``
    would reach the card's fused training kernels and they cannot take it:
    a classic NeRF (``network.type`` nerf) on a CUDA device with
    ``parallel.use_pallas`` not false trains through kernels 2 and 3, which
    take ``network.feat_dim`` up to 1024, encodings up to 128 wide
    (``signal_encoder.coord_encode_level`` and ``dir_encode_level`` <= 20)
    and ``device.compute_dtype`` bfloat16 or float32
    (``fused_nerf.train_route``: ``wgmma``, ``wgmma_general``, ``f32_wgmma``
    or ``f32``). The
    message names each offending key and that ``parallel.use_pallas=false``
    trains the config on the card through the plain path; nothing falls
    back to it unasked. Needs no card."""
    net, enc = cfg.network, cfg.signal_encoder
    if device.type != "cuda" or net.type != "nerf" or cfg.parallel.use_pallas is False:
        return
    fcfg = fused_nerf.FusedNeRFConfig(
        coord_encode_level=enc.coord_encode_level,
        dir_encode_level=enc.dir_encode_level,
        include_input=enc.include_input,
        feat_dim=net.feat_dim,
        compute_dtype=getattr(torch, cfg.device.compute_dtype),
    )
    try:
        fused_nerf.train_route(fcfg)
    except ValueError as err:
        bad = []
        if not 0 < net.feat_dim <= fused_nerf.MAX_FEAT:
            bad.append(f"network.feat_dim={net.feat_dim} (the kernels take up to {fused_nerf.MAX_FEAT})")
        for key, level, width in (("coord_encode_level", enc.coord_encode_level, fcfg.pos_enc_dim),
                                  ("dir_encode_level", enc.dir_encode_level, fcfg.dir_enc_dim)):
            if width > fused_nerf.MAX_ENC:
                bad.append(f"signal_encoder.{key}={level} (the kernels take <= 20, {width} encoded columns "
                           f"> {fused_nerf.MAX_ENC})")
        if fcfg.compute_dtype not in fused_nerf.DTYPES:
            bad.append(f"device.compute_dtype={cfg.device.compute_dtype} (the kernels take bfloat16 or float32)")
        raise ValueError(
            "the card's fused training kernels cannot train this config: " + "; ".join(bad or [str(err)])
            + ". Set parallel.use_pallas=false to train it on the card through the plain path."
        ) from err


def build_aux_loss(cfg: cfg_mod.ExperimentConfig):
    """The objective group's regularizer, ``session.py:202-235`` of the JAX
    package: None unless ``objective.encode_smoothness_weight`` > 0, else
    ``aux(params, draws) -> weight * loss(coarse) [+ weight * loss(fine)]``,
    the packed layouts' voxel-face penalty on each network, with
    ``aux.draw(generator)`` drawing one set of probes a network."""
    weight = cfg.objective.encode_smoothness_weight
    if weight <= 0.0:
        return None
    net = cfg.network
    if net.type != "instant_nerf" or net.table_layout not in ("packed", "packed_dual"):
        raise ValueError(
            "encode_smoothness_weight applies to the packed instant-NGP layouts; got "
            f"network.type='{net.type}', table_layout='{net.table_layout}'."
        )
    raw = make_encode_smoothness_loss(
        net.num_level,
        min_res=net.min_res,
        max_res=net.max_res,
        table_feat_dim=net.table_feat_dim,
        table_layout=net.table_layout,
        num_probes=cfg.objective.encode_smoothness_probes,
        use_kernel=cfg.parallel.use_pallas,
    )
    networks = 2 if cfg.renderer.num_samples_fine > 0 else 1

    def aux(params, draws):
        total = weight * raw(params["coarse"], draws[0])
        if "fine" in params:
            total = total + weight * raw(params["fine"], draws[1])
        return total

    aux.draw = lambda generator: tuple(raw.draw(generator) for _ in range(networks))
    return aux


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


def build_occupancy_cfg(cfg: cfg_mod.ExperimentConfig) -> Optional[OccupancyConfig]:
    """The occupancy group as an :class:`OccupancyConfig`, or None when
    disabled. A budget above its candidate count is clamped to it, with a
    printed line (``make_ray_train_step`` raises for it instead)."""
    o = cfg.occupancy
    if not o.enabled:
        return None
    coarse = cfg.renderer.num_samples_coarse
    if o.keep_samples > coarse:
        print(f"occupancy.keep_samples={o.keep_samples} clamped to renderer.num_samples_coarse={coarse}")
    max_fine = coarse + cfg.renderer.num_samples_fine
    if o.keep_samples_fine > max_fine:
        print(f"occupancy.keep_samples_fine={o.keep_samples_fine} clamped to the merged fine candidate "
              f"count {max_fine}")
    return OccupancyConfig(
        resolution=o.resolution,
        bound=o.bound,
        update_every=o.update_every,
        decay=o.decay,
        threshold=o.threshold,
        keep_samples=min(o.keep_samples, coarse),
        warmup_steps=o.warmup_steps,
        keep_samples_fine=min(o.keep_samples_fine, max_fine),
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
    else:  # instant_nerf: the two MLPs' layers as the model draws them
        sh_dim = sh_encoding_dim(enc.degree) if enc.type == "sh" else 27
        shapes = instant_ngp.mlp_shapes(sh_dim, net.num_level, net.table_feat_dim, table_layout=net.table_layout)
        macs = sum(i * o for layers in shapes.values() for i, o in layers.values())
    coarse = r.num_samples_coarse
    fine = r.num_samples_coarse + r.num_samples_fine  # merged fine set
    if cfg.occupancy.enabled:
        coarse = min(cfg.occupancy.keep_samples, coarse)
        if cfg.occupancy.keep_samples_fine:
            fine = min(cfg.occupancy.keep_samples_fine, fine)
    samples = coarse + fine if r.num_samples_fine > 0 else coarse
    return 3.0 * 2.0 * macs * r.num_pixels * samples
