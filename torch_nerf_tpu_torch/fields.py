"""Radiance field: encode inputs, query the network.

Counterpart of ``torch_nerf_tpu/fields.py:28-100``. A field bundles
``init(generator, device) -> params``, ``prepare(params) -> handle`` (the
kernel layout of the weights, built once per image when serving) and
``apply(params or handle, pts, dirs) -> (sigma, rgb)``; the public
parameter tree is differentiable through ``apply``. ``fused_cfg`` is set
when the field's loss can run through the fused train pass
(``ops/fused_train.py``), as the JAX field's is. :func:`make_scene_field`
bundles several primitives into one field that queries the active one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from torch_nerf_tpu_torch import encoders, tracing
from torch_nerf_tpu_torch.models import nerf as nerf_model
from torch_nerf_tpu_torch.ops import fused_nerf

# (params, pts (..., 3), dirs (..., 3)) -> (sigma (...), rgb (..., 3))
FieldApplyFn = Callable[[Any, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _identity(params):
    return params


@dataclasses.dataclass(frozen=True)
class Field:
    init: Callable[[torch.Generator, Optional[torch.device]], Any]
    apply: FieldApplyFn
    name: str = "field"
    prepare: Callable[[Any], Any] = _identity
    fused_cfg: Optional[fused_nerf.FusedNeRFConfig] = None


def make_nerf_field(
    pos_dim: int = 3,
    view_dir_dim: int = 3,
    coord_encode_level: int = 10,
    dir_encode_level: int = 4,
    include_input: bool = True,
    feat_dim: int = 256,
    compute_dtype: torch.dtype = torch.float32,
    use_kernel: Optional[bool] = None,
) -> Field:
    """Classic NeRF: positional encoding + the 11-layer MLP.

    ``use_kernel`` None or True routes through ``fused_nerf.fused_nerf_apply``
    (the kernel on a CUDA tensor, its plain version on a CPU tensor); False
    is the plain ``nerf_apply`` of the encodings on every device.
    """
    enc_pos_dim = encoders.positional_encoding_dim(pos_dim, coord_encode_level, include_input)
    enc_dir_dim = encoders.positional_encoding_dim(view_dir_dim, dir_encode_level, include_input)

    def init(generator: torch.Generator, device: Optional[torch.device] = None):
        return nerf_model.init_nerf_params(generator, enc_pos_dim, enc_dir_dim, feat_dim, device)

    if use_kernel is None or use_kernel:
        cfg = fused_nerf.FusedNeRFConfig(
            coord_encode_level=coord_encode_level,
            dir_encode_level=dir_encode_level,
            include_input=include_input,
            feat_dim=feat_dim,
            compute_dtype=compute_dtype,
        )

        def apply(params, pts: torch.Tensor, dirs: torch.Tensor):
            batch_shape = pts.shape[:-1]
            tracing.add("points", pts.numel() // 3)
            with tracing.span("field.forward"):
                sigma, rgb = fused_nerf.fused_nerf_apply(
                    params, pts.reshape(-1, 3).contiguous(), dirs.reshape(-1, 3).contiguous(), cfg
                )
                return sigma.reshape(batch_shape), rgb.reshape(*batch_shape, 3)

        return Field(
            init=init,
            apply=apply,
            name="nerf_fused",
            prepare=lambda params: fused_nerf.prepare(params, cfg),
            fused_cfg=cfg,
        )

    def apply(params, pts: torch.Tensor, dirs: torch.Tensor):
        tracing.add("points", pts.numel() // 3)
        pos_enc = encoders.positional_encoding(pts, coord_encode_level, include_input)
        dir_enc = encoders.positional_encoding(dirs, dir_encode_level, include_input)
        return nerf_model.nerf_apply(params, pos_enc, dir_enc, compute_dtype=compute_dtype)

    return Field(init=init, apply=apply, name="nerf")


def make_scene_field(primitives: Dict[str, Field], active: str) -> Field:
    """Several primitives -> one field (``torch_nerf_tpu/fields.py:103``):
    ``init`` draws every primitive's params, in sorted name order from the
    one generator, into a dict keyed by name (a checkpoint of the scene
    carries them all); ``apply`` and ``prepare`` take the ``active`` one's."""
    if active not in primitives:
        raise KeyError(f"active primitive '{active}' not among {sorted(primitives)}")

    def init(generator: torch.Generator, device: Optional[torch.device] = None):
        return {name: field.init(generator, device) for name, field in sorted(primitives.items())}

    def prepare(params):
        return {**params, active: primitives[active].prepare(params[active])}

    def apply(params, pts: torch.Tensor, dirs: torch.Tensor):
        return primitives[active].apply(params[active], pts, dirs)

    return Field(init=init, apply=apply, name=f"scene[{active}]", prepare=prepare)
