"""The classic NeRF MLP as a dictionary of tensors.

Counterpart of ``torch_nerf_tpu/models/nerf.py``. Parameters keep the JAX
package's public layout, ``{name: {"w": (in, out), "b": (out,)}}`` with
``x @ w + b``, so weights carry across unchanged (``params_from_jax`` /
``params_to_jax``); a reference PyTorch ``NeRF.state_dict()`` converts by
``params_from_torch_state_dict``. Init is PyTorch's ``nn.Linear`` default,
``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for weight and bias, drawn from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Dict[str, torch.Tensor]]

LAYER_NAMES = (
    "fc_in",
    "fc_1",
    "fc_2",
    "fc_3",
    "fc_4",
    "fc_5",
    "fc_6",
    "fc_7",
    "fc_8",
    "fc_9",
    "fc_out",
)


def layer_dims(pos_dim: int, view_dir_dim: int, feat_dim: int = 256) -> Dict[str, Tuple[int, int]]:
    """(in, out) sizes of every linear layer."""
    return {
        "fc_in": (pos_dim, feat_dim),
        "fc_1": (feat_dim, feat_dim),
        "fc_2": (feat_dim, feat_dim),
        "fc_3": (feat_dim, feat_dim),
        "fc_4": (feat_dim, feat_dim),
        "fc_5": (feat_dim + pos_dim, feat_dim),
        "fc_6": (feat_dim, feat_dim),
        "fc_7": (feat_dim, feat_dim),
        "fc_8": (feat_dim, feat_dim + 1),
        "fc_9": (feat_dim + view_dir_dim, feat_dim // 2),
        "fc_out": (feat_dim // 2, 3),
    }


def init_nerf_params(
    generator: torch.Generator,
    pos_dim: int,
    view_dir_dim: int,
    feat_dim: int = 256,
    device: Optional[torch.device] = None,
) -> Params:
    """PyTorch-default init of every layer, drawn in ``LAYER_NAMES`` order
    (weight then bias) from ``generator``, which must live on ``device``."""
    params: Params = {}
    for name, (fan_in, fan_out) in layer_dims(pos_dim, view_dir_dim, feat_dim).items():
        bound = 1.0 / math.sqrt(fan_in)
        w = torch.rand((fan_in, fan_out), generator=generator, device=device)
        b = torch.rand((fan_out,), generator=generator, device=device)
        params[name] = {"w": (2.0 * w - 1.0) * bound, "b": (2.0 * b - 1.0) * bound}
    return params


def _linear(p: Dict[str, torch.Tensor], x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # bf16 x bf16 -> f32-accumulated product rounded to ``dtype``, then the
    # bias added in ``dtype``: the roundings of models/nerf.py:84-87
    y = torch.matmul(x, p["w"].to(dtype))
    return y + p["b"].to(dtype)


def nerf_apply(
    params: Params,
    pos: torch.Tensor,
    view_dir: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass on encoded inputs ``(..., pos_dim)``, ``(..., dir_dim)``
    -> ``(sigma (...,), rgb (..., 3))`` in float32."""
    relu = torch.relu
    pos = pos.to(compute_dtype)
    view_dir = view_dir.to(compute_dtype)

    x = relu(_linear(params["fc_in"], pos, compute_dtype))
    x = relu(_linear(params["fc_1"], x, compute_dtype))
    x = relu(_linear(params["fc_2"], x, compute_dtype))
    x = relu(_linear(params["fc_3"], x, compute_dtype))
    x = relu(_linear(params["fc_4"], x, compute_dtype))

    x = torch.cat([pos, x], dim=-1)

    x = relu(_linear(params["fc_5"], x, compute_dtype))
    x = relu(_linear(params["fc_6"], x, compute_dtype))
    x = relu(_linear(params["fc_7"], x, compute_dtype))
    x = _linear(params["fc_8"], x, compute_dtype)

    sigma = relu(x[..., 0]).float()
    x = torch.cat([x[..., 1:], view_dir], dim=-1)

    x = relu(_linear(params["fc_9"], x, compute_dtype))
    rgb = torch.sigmoid(_linear(params["fc_out"], x, compute_dtype)).float()
    return sigma, rgb


def params_from_jax(tree: Any, device: Optional[torch.device] = None) -> Any:
    """JAX param tree (nested dicts of numpy arrays, e.g. ``{"coarse"|"fine":
    {name: {"w", "b"}}}``) -> the same tree of float32 tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def params_to_jax(tree: Any) -> Any:
    """Inverse of :func:`params_from_jax`: tensors -> numpy float32 arrays."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32).numpy()


def params_from_torch_state_dict(state_dict, device: Optional[torch.device] = None) -> Params:
    """A reference PyTorch ``NeRF.state_dict()`` (``{"<layer>.weight": (out,
    in), "<layer>.bias": (out,)}``, tensors or numpy arrays) -> the public
    tree, each weight transposed to (in, out), float32
    (``torch_nerf_tpu/models/nerf.py:128``)."""
    params: Params = {}
    for name in LAYER_NAMES:
        w = torch.as_tensor(np.asarray(state_dict[f"{name}.weight"]), dtype=torch.float32)
        b = torch.as_tensor(np.asarray(state_dict[f"{name}.bias"]), dtype=torch.float32)
        params[name] = {"w": w.t().contiguous().to(device), "b": b.to(device)}
    return params
