"""Instant-NGP (Mueller et al., SIGGRAPH 2022, arXiv:2201.05989, section 4
and table 1) in plain PyTorch: the multiresolution hash encoding with
trilinear interpolation, degree-4 spherical harmonics of the view
direction, a density MLP and a colour MLP.

Frozen copies here: the spatial hash's primes (1, 2654435761, 805459861)
of the paper's equation 4, XOR of the wrapped 32-bit products, taken
modulo the table size T; the level resolutions ``floor(N_min * b^l)``,
``b = (N_max / N_min)^(1 / (L - 1))`` (equation 2 and 3); the corners of a
voxel from the floor and ceiling of the scaled position, each weighted by
the product over the axes of its distance to the opposite corner (so an
integral scaled coordinate weighs every corner 0, as the reference code
does); the real SH basis's constants and order. The density MLP is
``fc_in`` (no activation), one relu hidden layer and ``fc_out`` (16
outputs; density ``2 ** out[0]``); the colour MLP takes all 16 outputs and
the 16 SH components through ``fc_in`` (no activation), two relu hidden
layers and ``fc_out`` to a sigmoid. Raw positions are hashed, the ray
direction is encoded unnormalised.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from nerfbench.reference.lowp import Rounding, linear

PRIMES = (1, 2654435761, 805459861)
MASK32 = 0xFFFFFFFF
CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1))
MLP_WIDTH = 64
DENSITY_OUT = 16

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154, -0.4570457994644658,
         1.445305721320277, -0.5900435899266435)


def networks(cfg: Dict) -> List[str]:
    return ["coarse", "fine"] if cfg["renderer.num_samples_fine"] > 0 else ["coarse"]


def _mlp_table(cfg: Dict) -> Dict[str, Dict[str, Tuple[int, int]]]:
    lf = cfg["network.num_level"] * cfg["network.table_feat_dim"]
    sh = cfg["signal_encoder.degree"] ** 2
    w = MLP_WIDTH
    return {
        "density_mlp": {"fc_in": (lf, w), "fc_hidden_0": (w, w), "fc_out": (w, DENSITY_OUT)},
        "color_mlp": {"fc_in": (DENSITY_OUT + sh, w), "fc_hidden_0": (w, w), "fc_hidden_1": (w, w),
                      "fc_out": (w, 3)},
    }


def table_shape(cfg: Dict) -> Tuple[int, int, int]:
    return (cfg["network.num_level"], 2 ** cfg["network.log_max_entry_per_level"], cfg["network.table_feat_dim"])


def layout(cfg: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str, int]]:
    """Every leaf: ``(path, shape, kind, fan_in)``, kind ``table`` or
    ``linear``."""
    leaves = []
    for net in networks(cfg):
        leaves.append(((net, "tables"), table_shape(cfg), "table", 0))
        for mlp, layers in _mlp_table(cfg).items():
            for name, (i, o) in layers.items():
                leaves.append(((net, mlp, name, "w"), (i, o), "linear", i))
                leaves.append(((net, mlp, name, "b"), (o,), "linear", i))
    return leaves


def macs_per_point(cfg: Dict) -> int:
    return sum(i * o for layers in _mlp_table(cfg).values() for i, o in layers.values())


def encode_bytes(cfg: Dict, points: int, backward: bool) -> int:
    """Bytes the encode must move at least: points in, features out and
    the table read once; the backward reads the features' gradient and the
    points and writes the table's gradient once."""
    num_level, entries, f = table_shape(cfg)
    table = num_level * entries * f * 4
    fwd = points * 3 * 4 + table + points * num_level * f * 4
    bwd = points * num_level * f * 4 + points * 3 * 4 + table
    return fwd + (bwd if backward else 0)


def level_resolutions(cfg: Dict) -> np.ndarray:
    num_level, lo, hi = cfg["network.num_level"], cfg["network.min_res"], cfg["network.max_res"]
    if num_level == 1:
        return np.asarray([float(lo)], dtype=np.float32)
    coeff = (hi / lo) ** (1.0 / (num_level - 1))
    return np.floor(lo * coeff ** np.arange(num_level)).astype(np.float32)


def _hash(vert: torch.Tensor, entries: int) -> torch.Tensor:
    """``vert (..., 3)`` integral floats -> row in ``[0, entries)``."""
    v = vert.to(torch.int32).to(torch.int64) & MASK32
    h = torch.zeros_like(v[..., 0])
    for axis in range(3):
        h = h ^ ((v[..., axis] * PRIMES[axis]) & MASK32)
    h = torch.where(h >= 2**31, h - 2**32, h)
    return torch.remainder(h, entries)


def hash_encode(tables: torch.Tensor, pts: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """``(M, L * F)`` features of ``pts (M, 3)``, level-major."""
    num_level, entries, f = tables.shape
    res = torch.as_tensor(level_resolutions(cfg), device=pts.device)
    bits = torch.tensor(CORNERS, dtype=torch.float32, device=pts.device)  # (8, 3)
    scaled = pts[:, None, :] * res[None, :, None]  # (M, L, 3)
    floor = torch.floor(scaled)
    span = torch.ceil(scaled) - floor
    vert = floor[:, :, None, :] + bits * span[:, :, None, :]  # (M, L, 8, 3)
    opposite = floor[:, :, None, :] + (1.0 - bits) * span[:, :, None, :]
    weight = torch.prod(torch.abs(opposite - scaled[:, :, None, :]), dim=-1)  # (M, L, 8)
    rows = _hash(vert, entries) + (torch.arange(num_level, device=pts.device) * entries)[None, :, None]
    feats = tables.reshape(num_level * entries, f)[rows]  # (M, L, 8, F)
    return torch.sum(feats * weight[..., None], dim=2).reshape(pts.shape[0], num_level * f)


def sh_encoding(d: torch.Tensor) -> torch.Tensor:
    """Degree-4 real SH basis, 16 components."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    comps = [
        torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z, SH_C3[2] * y * (4.0 * zz - xx - yy),
        SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy), SH_C3[4] * x * (4.0 * zz - xx - yy),
        SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy),
    ]
    return torch.stack(comps, dim=-1)


def _mlp(params: Dict, x: torch.Tensor, rounding: Rounding) -> torch.Tensor:
    out = linear(x, params["fc_in"]["w"], params["fc_in"]["b"], rounding)
    i = 0
    while f"fc_hidden_{i}" in params:
        out = torch.relu(linear(out, params[f"fc_hidden_{i}"]["w"], params[f"fc_hidden_{i}"]["b"], rounding))
        i += 1
    return linear(out, params["fc_out"]["w"], params["fc_out"]["b"], rounding)


def field(params: Dict, pts: torch.Tensor, dirs: torch.Tensor, cfg: Dict, rounding: Rounding = None):
    """``(sigma (...), rgb (..., 3))`` of one network."""
    if cfg["signal_encoder.degree"] != 4:
        raise ValueError("the reference's SH basis is degree 4")
    shape = pts.shape[:-1]
    feats = hash_encode(params["tables"], pts.reshape(-1, 3), cfg)
    dens = _mlp(params["density_mlp"], feats, rounding)
    sigma = torch.exp2(dens[:, 0])
    color = _mlp(params["color_mlp"], torch.cat([dens, sh_encoding(dirs.reshape(-1, 3))], dim=-1), rounding)
    return sigma.reshape(shape), torch.sigmoid(color).reshape(*shape, 3)
