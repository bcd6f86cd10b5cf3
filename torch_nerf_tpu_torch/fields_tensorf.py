"""TensoRF-VM field: the VM-factorised density and appearance grids, the
appearance basis and the render MLP (:mod:`models.tensorf`).

The field has no ``fused_cfg``, so training takes the generic autograd
branch of ``train.make_ray_train_step``: one forward and one backward VM
kernel a pass (``ops/vm_grid.py``), ``basis_mat`` and the render MLP on
cuBLAS in ``compute_dtype``. ``prepare`` is the identity: the frame loop
applies the public tree.
"""

from __future__ import annotations

from typing import Optional

import torch

from torch_nerf_tpu_torch import tracing
from torch_nerf_tpu_torch.fields import Field
from torch_nerf_tpu_torch.models import tensorf


def make_tensorf_field(
    grid_res: int = 300,
    density_components: int = 16,
    app_components: int = 48,
    app_dim: int = 27,
    feature_c: int = 128,
    fea_pe: int = 2,
    view_pe: int = 2,
    bound: float = 1.5,
    density_shift: float = -10.0,
    distance_scale: float = 25.0,
    compute_dtype: torch.dtype = torch.float32,
    use_kernel: Optional[bool] = None,
) -> Field:
    """Defaults are TensoRF-VM-192's (``configs/lego.txt``) at its final
    grid. ``use_kernel`` None or True takes the VM kernels on CUDA tensors
    and their plain versions on CPU tensors; False takes the plain forward
    by autograd on every device."""
    kernel = use_kernel is None or bool(use_kernel)

    def init(generator: torch.Generator, device: Optional[torch.device] = None):
        return tensorf.init_tensorf_params(generator, grid_res, density_components, app_components, app_dim,
                                           feature_c, fea_pe, view_pe, device)

    def apply(params, pts: torch.Tensor, dirs: torch.Tensor):
        tracing.add("points", pts.numel() // 3)
        return tensorf.tensorf_apply(params, pts, dirs, bound=bound, density_shift=density_shift,
                                     distance_scale=distance_scale, fea_pe=fea_pe, view_pe=view_pe,
                                     compute_dtype=compute_dtype, use_kernel=kernel)

    return Field(init=init, apply=apply, name="tensorf" if kernel else "tensorf_plain")
