"""Instant-NGP field: hash-grid encoding + SH view directions.

Counterpart of ``torch_nerf_tpu/fields_ngp.py::make_instant_ngp_field``:
raw positions go into the hash grid, the unnormalised ray directions into
the SH encoder. The field has no ``fused_cfg``, so training takes the
generic autograd branch of ``train.make_ray_train_step``: one forward and
one backward hash kernel a render pass. The voxel-face smoothness loss of
the packed layouts comes with the port's packed-layout slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from torch_nerf_tpu_torch import encoders
from torch_nerf_tpu_torch.fields import Field
from torch_nerf_tpu_torch.models import instant_ngp
from torch_nerf_tpu_torch.models.hash_math import level_resolutions


def make_instant_ngp_field(
    num_level: int = 16,
    log_max_entry_per_level: int = 19,
    table_feat_dim: int = 2,
    min_res: int = 16,
    max_res: int = 512,
    density_feat_dim: int = 64,
    color_feat_dim: int = 64,
    sh_degree: int = 4,
    is_hdr: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    table_layout: str = "hash",
    use_kernel: Optional[bool] = None,
) -> Field:
    """Defaults mirror the reference's ``instant_nerf`` network and SH
    encoder. ``table_layout`` "hash" hashes each of a voxel's 8 corners
    (reference parity); "bricked" reads one 4^3-site brick row a (point,
    level). ``use_kernel`` None or True takes the hash kernels on CUDA
    tensors and their plain versions on CPU tensors; False takes the plain
    versions on every device."""
    instant_ngp.check_layout(table_layout)
    res_np = level_resolutions(num_level, min_res, max_res)
    res_on: Dict[torch.device, torch.Tensor] = {}
    view_dir_dim = encoders.sh_encoding_dim(sh_degree)
    kernel = use_kernel is None or bool(use_kernel)

    def resolutions(device: torch.device) -> torch.Tensor:
        if device not in res_on:
            res_on[device] = torch.as_tensor(res_np, device=device)
        return res_on[device]

    def init(generator: torch.Generator, device: Optional[torch.device] = None):
        return instant_ngp.init_instant_ngp_params(
            generator,
            view_dir_dim=view_dir_dim,
            num_level=num_level,
            log_max_entry_per_level=log_max_entry_per_level,
            table_feat_dim=table_feat_dim,
            density_feat_dim=density_feat_dim,
            color_feat_dim=color_feat_dim,
            table_layout=table_layout,
            device=device,
        )

    def apply(params, pts: torch.Tensor, dirs: torch.Tensor):
        dir_enc = encoders.sh_encoding(dirs, sh_degree)
        return instant_ngp.instant_ngp_apply(
            params, pts, dir_enc, resolutions(pts.device), is_hdr=is_hdr,
            compute_dtype=compute_dtype, table_layout=table_layout, use_kernel=kernel,
        )

    return Field(init=init, apply=apply, name="instant_ngp" if kernel else "instant_ngp_plain")
