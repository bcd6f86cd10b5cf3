"""Instant-NGP: multiresolution hash encoding + two small MLPs.

Counterpart of ``torch_nerf_tpu/models/instant_ngp.py`` for its four table
layouts: ``hash`` (reference-parity, per-corner hashing into (L, T, F)
tables), ``bricked`` (4^3-site bricks in (L, T_b, 128) tables, the
production preset's), ``packed`` (one hashed row of a voxel's 8 corners x F
a (point, level), in folded (L, rows/fold, 128) tables) and
``packed_dual`` (packed, plus a second grid a level staggered by half a
voxel: 2L table levels and a 2L*F-wide ``fc_in``). The reference's quirks
are kept: corners from floor/ceil, so an integral scaled coordinate has
all-zero weights and a zero feature; density ``2 ** x`` with no ReLU; no
activation after the MLPs' ``fc_in``; raw, possibly negative, world
coordinates hashed.

Parameters keep the JAX package's tree, ``{"tables", "density_mlp":
{name: {"w", "b"}}, "color_mlp": ...}``, so ``models.nerf.params_from_jax``
carries them across. Init draws U(-1e-4, 1e-4) tables and PyTorch-default
linear layers from an explicit ``torch.Generator``, tables first.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from torch_nerf_tpu_torch import tracing
from torch_nerf_tpu_torch.ops import hash_grid

Params = Dict[str, Any]

LAYOUTS = ("hash", "bricked", "packed", "packed_dual")
DENSITY_OUT = 16
DENSITY_HIDDEN, COLOR_HIDDEN = 1, 2


def check_layout(table_layout: str) -> None:
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


def init_packed_hash_table(
    generator: torch.Generator, num_level: int, log_max_entry_per_level: int, feat_dim: int,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """(L, rows/fold, 128) folded packed tables, U(-1e-4, 1e-4): ``2^log /
    8`` packed rows of 8 corners x F a level (the reference's parameter
    count), ``fold = 128 / (8F)`` of them a 128-float line."""
    fold = hash_grid.fold_factor(feat_dim)
    rows = 2**log_max_entry_per_level // 8
    if rows % fold != 0:
        raise ValueError(
            f"log_max_entry_per_level={log_max_entry_per_level} too small for "
            f"feat_dim={feat_dim} (need at least {fold} packed rows per line)"
        )
    return _uniform(generator, (num_level, rows // fold, hash_grid.LANES), -1e-4, 1e-4, device)


def unfold_packed_table(tables: torch.Tensor, feat_dim: int) -> torch.Tensor:
    """Folded (L, rows/fold, 128) -> the packed (L, rows, 8F) view."""
    num_level, t_fold, _ = tables.shape
    fold = hash_grid.fold_factor(feat_dim)
    return tables.reshape(num_level, t_fold * fold, 8 * feat_dim)


def dual_resolutions_offsets(resolutions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dual layout's (2L,) pseudo-level resolutions and offsets: levels
    [0, L) the base grids (offset 0), levels [L, 2L) the same resolutions
    with the scaled coordinate shifted by +0.5."""
    res2 = torch.cat([resolutions, resolutions])
    off2 = torch.cat([torch.zeros_like(resolutions), torch.full_like(resolutions, 0.5)])
    return res2, off2


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


def hash_encode_packed(
    tables: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor, feat_dim: int,
    offsets: Optional[torch.Tensor] = None, use_kernel: bool = True,
) -> torch.Tensor:
    """Voxel-packed encode of folded (L, rows/fold, 128) tables -> (N,
    L*F): through kernels 8 and 9 (their plain versions on CPU tensors) when
    ``use_kernel``, else the plain version by autograd. ``offsets`` (L,)
    shift the scaled coordinates (0 when None)."""
    if offsets is None:
        offsets = torch.zeros_like(resolutions)
    if use_kernel:
        return hash_grid.fold_encode(tables, coords, resolutions, offsets, feat_dim)
    return hash_grid.fold_encode_reference(tables, coords, resolutions, offsets, feat_dim)


def encode_features(
    tables: torch.Tensor, flat_pos: torch.Tensor, resolutions: torch.Tensor, table_layout: str, in_dim: int,
    use_kernel: bool = True,
) -> torch.Tensor:
    """The ``(N, in_dim)`` features of ``table_layout``'s encode at ``flat_pos
    (N, 3)``: ``in_dim`` is the density MLP's input width, from which the
    packed layouts take F (over 2L pseudo-levels when dual), as the JAX
    package does."""
    if table_layout in ("packed", "packed_dual"):
        feat_dim = in_dim // tables.shape[0]
        offsets = None
        if table_layout == "packed_dual":
            resolutions, offsets = dual_resolutions_offsets(resolutions)
        return hash_encode_packed(tables, flat_pos, resolutions, feat_dim, offsets, use_kernel)
    encode = hash_encode_bricked if table_layout == "bricked" else hash_encode
    return encode(tables, flat_pos, resolutions, use_kernel)


# ---------------------------------------------------------------------------
# small MLPs


def _init_linear(generator, fan_in: int, fan_out: int, device) -> Dict[str, torch.Tensor]:
    bound = 1.0 / math.sqrt(fan_in)
    w = _uniform(generator, (fan_in, fan_out), -bound, bound, device)
    return {"w": w, "b": _uniform(generator, (fan_out,), -bound, bound, device)}


def small_mlp_shapes(in_dim: int, out_dim: int, feat_dim: int, num_hidden_layer: int) -> Dict[str, Tuple[int, int]]:
    """``{layer: (fan_in, fan_out)}`` of a small MLP, in its layers' order."""
    shapes = {"fc_in": (in_dim, feat_dim)}
    for i in range(num_hidden_layer):
        shapes[f"fc_hidden_{i}"] = (feat_dim, feat_dim)
    shapes["fc_out"] = (feat_dim, out_dim)
    return shapes


def init_small_mlp(
    generator: torch.Generator, in_dim: int, out_dim: int, feat_dim: int, num_hidden_layer: int,
    device: Optional[torch.device] = None,
) -> Params:
    """fc_in, fc_hidden_0.., fc_out, each drawn weight then bias."""
    return {name: _init_linear(generator, fan_in, fan_out, device)
            for name, (fan_in, fan_out) in small_mlp_shapes(in_dim, out_dim, feat_dim, num_hidden_layer).items()}


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


def mlp_shapes(
    view_dir_dim: int,
    num_level: int = 16,
    table_feat_dim: int = 2,
    density_feat_dim: int = 64,
    color_feat_dim: int = 64,
    table_layout: str = "hash",
) -> Dict[str, Dict[str, Tuple[int, int]]]:
    """The two MLPs' layer shapes, ``{"density_mlp": small_mlp_shapes,
    "color_mlp": ...}``, as :func:`init_instant_ngp_params` draws them."""
    table_levels = 2 * num_level if table_layout == "packed_dual" else num_level
    return {
        "density_mlp": small_mlp_shapes(table_levels * table_feat_dim, DENSITY_OUT, density_feat_dim, DENSITY_HIDDEN),
        "color_mlp": small_mlp_shapes(DENSITY_OUT + view_dir_dim, 3, color_feat_dim, COLOR_HIDDEN),
    }


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
    color MLP (16 + view_dir_dim -> 64 -> 64 -> 3, two hidden layers),
    drawn in that order. ``packed_dual`` has 2L table levels and a
    2L*F-wide ``fc_in``."""
    check_layout(table_layout)
    table_levels = 2 * num_level if table_layout == "packed_dual" else num_level
    init_table = {"hash": init_hash_table, "bricked": init_bricked_hash_table}.get(
        table_layout, init_packed_hash_table
    )
    tables = init_table(generator, table_levels, log_max_entry_per_level, table_feat_dim, device)
    return {
        "tables": tables,
        "density_mlp": init_small_mlp(
            generator, table_levels * table_feat_dim, DENSITY_OUT, density_feat_dim, DENSITY_HIDDEN, device
        ),
        "color_mlp": init_small_mlp(generator, DENSITY_OUT + view_dir_dim, 3, color_feat_dim, COLOR_HIDDEN, device),
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
    versions by autograd on every device. While ``tracing`` records, the
    backward's spans between gradient hooks on the tensors at these
    boundaries name the colour MLP's, the colour input's and the density
    MLP's backward."""
    check_layout(table_layout)
    batch_shape = pos.shape[:-1]
    flat_pos = pos.reshape(-1, 3).contiguous()
    flat_dir = view_dir_enc.reshape(-1, view_dir_enc.shape[-1])
    tables = params["tables"]
    with tracing.span("field.encode"):
        feats = encode_features(tables, flat_pos, resolutions, table_layout,
                                params["density_mlp"]["fc_in"]["w"].shape[0], use_kernel)
    with tracing.span("field.density_mlp"):
        density_out = small_mlp_apply(params["density_mlp"], feats, compute_dtype)
        sigma = torch.exp2(density_out[..., 0])
    with tracing.span("field.color_in"):
        color_in = torch.cat([density_out, flat_dir], dim=-1)
    with tracing.span("field.color_mlp"):
        color_out = small_mlp_apply(params["color_mlp"], color_in, compute_dtype)
        rgb = torch.exp(color_out) if is_hdr else torch.sigmoid(color_out)
    tracing.backward_spans([(rgb, "field.color_mlp.bwd"), (color_in, "field.color_in.bwd"),
                            (density_out, "field.density_mlp.bwd"), (feats, None)])
    return sigma.reshape(batch_shape), rgb.reshape(*batch_shape, 3)
