"""The classic NeRF MLP with its width sharded over a model group.

Counterpart of what the JAX package's TP step runs: its
``make_sharded_train_step`` with a model axis goes through the generic
autodiff step (``torch_nerf_tpu/parallel/mesh.py:233-237``), plain XLA
matmuls that GSPMD partitions by ``nerf_param_spec``. Here each rank holds
its slices (``mesh.place_state``) and :func:`tp_nerf_apply` runs
``models/nerf.py``'s layers on them with plain matmuls, the collectives of
``collectives.py`` written where GSPMD put them:

* a column-parallel layer (``w`` sharded by its output) takes a replicated
  input through :func:`~collectives.copy_to_group` and gives a sharded one;
* a row-parallel layer (``w`` sharded by its input) takes a sharded input
  and sums its partial products with :func:`~collectives.reduce_from_group`
  (in f32), giving a replicated one;
* a replicated layer, the skip concat and the heads need a replicated
  input: a sharded activation is gathered first. ``fc_5``, whose input is
  the concat of the encoding and ``fc_4``'s output (256 + 63 = 319
  columns), and ``fc_8`` (257 outputs) stay replicated, so ``fc_4``'s
  column-parallel output is gathered before the concat.

No kernel runs here, as no Pallas kernel runs in the JAX package's TP step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from torch_nerf_tpu_torch import encoders
from torch_nerf_tpu_torch.fields import Field
from torch_nerf_tpu_torch.models import nerf as nerf_model
from torch_nerf_tpu_torch.ops.fused_nerf import FusedNeRFConfig
from torch_nerf_tpu_torch.parallel import collectives
from torch_nerf_tpu_torch.parallel.mesh import Mesh, layer_spec

Spec = Dict[str, Dict[str, Optional[int]]]


def mlp_spec(cfg: FusedNeRFConfig, model_size: int) -> Spec:
    """``{layer: {"w": dim, "b": dim}}`` of one network at the model size."""
    dims = nerf_model.layer_dims(cfg.pos_enc_dim, cfg.dir_enc_dim, cfg.feat_dim)
    return {name: layer_spec(name, fan_in, fan_out, model_size) for name, (fan_in, fan_out) in dims.items()}


def tp_nerf_apply(params: nerf_model.Params, spec: Spec, pos: torch.Tensor, view_dir: torch.Tensor, group,
                  compute_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nerf_model.nerf_apply`` on one rank's slices ``params`` laid out by
    ``spec``: the encodings ``(..., pos_dim)``, ``(..., dir_dim)``, whole on
    every rank of ``group``, -> ``(sigma (...,), rgb (..., 3))``, whole on
    every rank."""

    def linear(name: str, x: torch.Tensor, sharded: bool) -> Tuple[torch.Tensor, bool]:
        """``(y, whether y is sharded)``."""
        p, w_dim = params[name], spec[name]["w"]
        w, b = p["w"].to(compute_dtype), p["b"].to(compute_dtype)
        if w_dim == 0:  # row-parallel: its fan-in is the width, so its input is sharded
            assert sharded, f"{name}'s input is replicated"
            partial = torch.matmul(x, w).float()
            return collectives.reduce_from_group(partial, group).to(compute_dtype) + b, False
        if sharded:
            x = collectives.gather_from_group(x, group)
        if w_dim == 1:  # column-parallel
            return torch.matmul(collectives.copy_to_group(x, group), w) + b, True
        return torch.matmul(x, w) + b, False

    def whole(x: torch.Tensor, sharded: bool) -> torch.Tensor:
        return collectives.gather_from_group(x, group) if sharded else x

    pos = pos.to(compute_dtype)
    view_dir = view_dir.to(compute_dtype)
    x, sharded = pos, False
    for name in ("fc_in", "fc_1", "fc_2", "fc_3", "fc_4"):
        x, sharded = linear(name, x, sharded)
        x = torch.relu(x)
    x = torch.cat([pos, whole(x, sharded)], dim=-1)
    sharded = False
    for name in ("fc_5", "fc_6", "fc_7"):
        x, sharded = linear(name, x, sharded)
        x = torch.relu(x)
    x, sharded = linear("fc_8", x, sharded)
    x = whole(x, sharded)
    sigma = torch.relu(x[..., 0]).float()
    x = torch.cat([x[..., 1:], view_dir], dim=-1)
    x, sharded = linear("fc_9", x, False)
    x = torch.relu(whole(x, sharded))
    x, sharded = linear("fc_out", x, False)
    rgb = torch.sigmoid(whole(x, sharded)).float()
    return sigma, rgb


def make_tp_field(cfg: FusedNeRFConfig, mesh: Mesh) -> Field:
    """The classic NeRF field of ``cfg`` (encodings, width, compute dtype)
    on ``mesh``'s model group: its ``apply`` takes one rank's slices. Every
    rank of the group must call it on the same points."""
    spec = mlp_spec(cfg, mesh.model_size)

    def init(generator: torch.Generator, device: Optional[torch.device] = None):
        return nerf_model.init_nerf_params(generator, cfg.pos_enc_dim, cfg.dir_enc_dim, cfg.feat_dim, device)

    def apply(params, pts: torch.Tensor, dirs: torch.Tensor):
        pos = encoders.positional_encoding(pts, cfg.coord_encode_level, cfg.include_input)
        view = encoders.positional_encoding(dirs, cfg.dir_encode_level, cfg.include_input)
        return tp_nerf_apply(params, spec, pos, view, mesh.model_group, cfg.compute_dtype)

    return Field(init=init, apply=apply, name="nerf_tp")
