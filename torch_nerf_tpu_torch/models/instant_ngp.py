"""Instant-NGP: multiresolution hash encoding + two small MLPs.

Counterpart of ``torch_nerf_tpu/models/instant_ngp.py`` for the ``hash``
(reference-parity, per-corner hashing into (L, T, F) tables) and
``bricked`` (4^3-site bricks in (L, T_b, 128) tables, the production
preset's) layouts; ``packed`` and ``packed_dual`` come with the port's
packed-layout slice. The reference's quirks are kept: corners from
floor/ceil, so an integral scaled coordinate has all-zero weights and a
zero feature; density ``2 ** x`` with no ReLU; no activation after the MLPs'
``fc_in``; raw, possibly negative, world coordinates hashed.

Parameters keep the JAX package's tree, ``{"tables", "density_mlp":
{name: {"w", "b"}}, "color_mlp": ...}``, so ``models.nerf.params_from_jax``
carries them across. Init draws U(-1e-4, 1e-4) tables and PyTorch-default
linear layers from an explicit ``torch.Generator``, tables first.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from torch_nerf_tpu_torch.ops import hash_grid

Params = Dict[str, Any]

LAYOUTS = ("hash", "bricked")


def check_layout(table_layout: str) -> None:
    if table_layout in ("packed", "packed_dual"):
        raise NotImplementedError(
            f"table_layout '{table_layout}' comes with the port's packed-layout slice"
        )
    if table_layout not in LAYOUTS:
        raise ValueError(f"Unknown table_layout '{table_layout}'.")


def _uniform(generator, shape, low: float, high: float, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) * (high - low) + low


def init_hash_table(
    generator: torch.Generator, num_level: int, log_max_entry_per_level: int, feat_dim: int,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """(L, T, F) tables, U(-1e-4, 1e-4)."""
    return _uniform(generator, (num_level, 2**log_max_entry_per_level, feat_dim), -1e-4, 1e-4, device)


def init_bricked_hash_table(
    generator: torch.Generator, num_level: int, log_max_entry_per_level: int, feat_dim: int,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """(L, T_b, 128) brick tables, U(-1e-4, 1e-4), at the reference budget
    ``T_b * 128 = 2^log * F`` floats a level; F must be 2."""
    shape = (num_level, hash_grid.bricks_per_level(log_max_entry_per_level, feat_dim), hash_grid.LANES)
    hash_grid.check_brick_layout(shape, feat_dim)
    return _uniform(generator, shape, -1e-4, 1e-4, device)


def hash_encode(
    tables: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor, use_kernel: bool = True
) -> torch.Tensor:
    """Reference-parity per-corner encode of (L, T, F) tables -> (N, L*F),
    for any T: through kernels 6 and 7 (their plain versions on CPU tensors)
    when ``use_kernel``, else the plain version by autograd."""
    if use_kernel:
        return hash_grid.corner_encode(tables, coords, resolutions)
    return hash_grid.corner_encode_reference(tables, coords, resolutions)


def hash_encode_bricked(
    tables: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor, use_kernel: bool = True
) -> torch.Tensor:
    """Brick-shared encode of (L, T_b, 128) tables -> (N, L*2): through
    kernels 4 and 5 (their plain versions on CPU tensors) when
    ``use_kernel``, else the plain version by autograd."""
    if use_kernel:
        return hash_grid.brick_encode(tables, coords, resolutions)
    return hash_grid.brick_encode_reference(tables, coords, resolutions)


# ---------------------------------------------------------------------------
# small MLPs


def _init_linear(generator, fan_in: int, fan_out: int, device) -> Dict[str, torch.Tensor]:
    bound = 1.0 / math.sqrt(fan_in)
    w = _uniform(generator, (fan_in, fan_out), -bound, bound, device)
    return {"w": w, "b": _uniform(generator, (fan_out,), -bound, bound, device)}


def init_small_mlp(
    generator: torch.Generator, in_dim: int, out_dim: int, feat_dim: int, num_hidden_layer: int,
    device: Optional[torch.device] = None,
) -> Params:
    """fc_in, fc_hidden_0.., fc_out, each drawn weight then bias."""
    params = {"fc_in": _init_linear(generator, in_dim, feat_dim, device)}
    for i in range(num_hidden_layer):
        params[f"fc_hidden_{i}"] = _init_linear(generator, feat_dim, feat_dim, device)
    params["fc_out"] = _init_linear(generator, feat_dim, out_dim, device)
    return params


def small_mlp_apply(params: Params, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """fc_in (no activation) -> [relu(hidden)]* -> fc_out (no activation),
    in f32 out. Each product of ``compute_dtype`` operands is accumulated in
    f32 and rounded to ``compute_dtype``, then the bias is added in it: the
    roundings of the JAX package's ``small_mlp_apply``."""

    def linear(p, v):
        return torch.matmul(v, p["w"].to(compute_dtype)) + p["b"].to(compute_dtype)

    out = linear(params["fc_in"], x.to(compute_dtype))
    i = 0
    while f"fc_hidden_{i}" in params:
        out = torch.relu(linear(params[f"fc_hidden_{i}"], out))
        i += 1
    return linear(params["fc_out"], out).float()


# ---------------------------------------------------------------------------
# full model


def init_instant_ngp_params(
    generator: torch.Generator,
    view_dir_dim: int,
    num_level: int = 16,
    log_max_entry_per_level: int = 19,
    table_feat_dim: int = 2,
    density_feat_dim: int = 64,
    color_feat_dim: int = 64,
    table_layout: str = "hash",
    device: Optional[torch.device] = None,
) -> Params:
    """Hash tables + density MLP (L*F -> 64 -> 16, one hidden layer) +
    color MLP (16 + view_dir_dim -> 64 -> 64 -> 3, two hidden layers)."""
    check_layout(table_layout)
    init_table = init_hash_table if table_layout == "hash" else init_bricked_hash_table
    tables = init_table(generator, num_level, log_max_entry_per_level, table_feat_dim, device)
    density_out = 16
    return {
        "tables": tables,
        "density_mlp": init_small_mlp(
            generator, num_level * table_feat_dim, density_out, density_feat_dim, 1, device
        ),
        "color_mlp": init_small_mlp(generator, density_out + view_dir_dim, 3, color_feat_dim, 2, device),
    }


def instant_ngp_apply(
    params: Params,
    pos: torch.Tensor,
    view_dir_enc: torch.Tensor,
    resolutions: torch.Tensor,
    is_hdr: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    table_layout: str = "hash",
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma, rgb) at raw positions ``(..., 3)`` and encoded view
    directions ``(..., D)``: density ``2 ** out[..., 0]``, colour sigmoid
    (exp when ``is_hdr``). ``use_kernel`` routes the encode through the
    hash kernels (their plain versions on CPU tensors); False takes the plain
    versions by autograd on every device."""
    check_layout(table_layout)
    batch_shape = pos.shape[:-1]
    flat_pos = pos.reshape(-1, 3).contiguous()
    flat_dir = view_dir_enc.reshape(-1, view_dir_enc.shape[-1])
    encode = hash_encode_bricked if table_layout == "bricked" else hash_encode
    feats = encode(params["tables"], flat_pos, resolutions, use_kernel)
    density_out = small_mlp_apply(params["density_mlp"], feats, compute_dtype)
    sigma = torch.exp2(density_out[..., 0])
    color_in = torch.cat([density_out, flat_dir], dim=-1)
    color_out = small_mlp_apply(params["color_mlp"], color_in, compute_dtype)
    rgb = torch.exp(color_out) if is_hdr else torch.sigmoid(color_out)
    return sigma.reshape(batch_shape), rgb.reshape(*batch_shape, 3)
