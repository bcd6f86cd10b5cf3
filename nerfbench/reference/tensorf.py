"""TensoRF-VM (Chen, Xu, Geiger, Yu and Su, ECCV 2022, arXiv:2203.09507,
section 4; the public code's ``TensorVMSplit`` with ``MLPRender_Fea`` and
``configs/lego.txt``) in plain PyTorch.

A point is normalised as the public code's ``normalize_coord``: ``xhat =
(x - aabb_min) * 2 / (aabb_max - aabb_min) - 1`` in the box ``[-b, b]^3``;
a point outside it (any ``|xhat| > 1``) has density 0 and zero features.
Plane m spans the axes (a, b) = (0, 1), (0, 2), (1, 2) and its line the
axis c = 2, 1, 0; both are sampled by ``F.grid_sample(align_corners=True)``
(the plane at ``(xhat_a, xhat_b)`` as grid (x, y), the line as a
one-texel-wide image at ``(0, xhat_c)``), so -1 and +1 fall on the edge
texels. The density feature is the sum over m and the density components
of plane sample x line sample; ``sigma = distance_scale * softplus(f +
density_shift)`` (the public code multiplies the step by distance_scale
instead; the product is the same). The appearance's products, plane-major,
go through ``basis_mat`` (no bias); the render MLP takes ``[features,
view, PE(features), PE(view)]``, the view direction normalised to unit
length, PE the public code's ``positional_encoding`` (channel-major
products with 2^f, all sines, then all cosines, no pi), through
``Linear -> ReLU -> Linear -> ReLU -> Linear`` to a sigmoid.

Planes are stored ``(R_b, R_a, C)`` and lines ``(R_c, C)``, components
fastest (the public code's ``(1, C, R_b, R_a)`` and ``(1, C, R_c, 1)``
transposed); linear weights ``(in, out)``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from nerfbench.reference import strict_f32
from nerfbench.reference.lowp import Rounding, linear

PLANE_AXES = ((0, 1), (0, 2), (1, 2))
LINE_AXES = (2, 1, 0)
FACTORS = ("density_plane", "density_line", "app_plane", "app_line")


def networks(cfg: Dict) -> List[str]:
    return ["coarse"]


def _sizes(cfg: Dict) -> Tuple[int, int, int]:
    return cfg["network.vm_grid_res"], cfg["network.vm_density_components"], cfg["network.vm_app_components"]


def mlp_in_dim(cfg: Dict) -> int:
    app, fea, view = cfg["network.app_dim"], cfg["network.fea_pe"], cfg["network.view_pe"]
    return app + 3 + 2 * fea * app + 2 * view * 3


def _linear_table(cfg: Dict) -> Dict[str, Tuple[int, int]]:
    _, _, ca = _sizes(cfg)
    fc = cfg["network.feature_c"]
    return {"basis_mat": (3 * ca, cfg["network.app_dim"]), "fc_0": (mlp_in_dim(cfg), fc), "fc_1": (fc, fc),
            "fc_2": (fc, 3)}


def layout(cfg: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str, int]]:
    """Every leaf: ``(path, shape, kind, fan_in)``, kind ``table`` (the
    twelve factors) or ``linear``."""
    r, cd, ca = _sizes(cfg)
    shapes = {"density_plane": (r, r, cd), "density_line": (r, cd), "app_plane": (r, r, ca), "app_line": (r, ca)}
    leaves = []
    for net in networks(cfg):
        for key in FACTORS:
            leaves += [((net, key, str(m)), shapes[key], "table", 0) for m in range(3)]
        table = _linear_table(cfg)
        leaves.append(((net, "basis_mat", "w"), table["basis_mat"], "linear", table["basis_mat"][0]))
        for name in ("fc_0", "fc_1", "fc_2"):
            i, o = table[name]
            leaves.append(((net, "render_mlp", name, "w"), (i, o), "linear", i))
            leaves.append(((net, "render_mlp", name, "b"), (o,), "linear", i))
    return leaves


def macs_per_point(cfg: Dict) -> int:
    """``basis_mat`` and the render MLP (39,856 at the published sizes),
    plus the VM encode's plane x line products, 3 x (C_d + C_a) = 192,
    counted as multiply-adds: 40,048."""
    _, cd, ca = _sizes(cfg)
    return sum(i * o for i, o in _linear_table(cfg).values()) + 3 * (cd + ca)


def encode_bytes(cfg: Dict, points: int, backward: bool) -> int:
    """Bytes the VM encode must move at least: points in (12 bytes), the
    density feature (4) and the appearance products (3 C_a in the
    configuration's compute dtype) out, the factors read once; the
    backward reads the cotangents of both outputs and the points and the
    factors, and writes the factors' gradients once."""
    r, cd, ca = _sizes(cfg)
    factors = 3 * (cd + ca) * (r * r + r) * 4
    width = 2 if cfg["device.compute_dtype"] == "bfloat16" else 4
    per_point = 3 * 4 + 4 + 3 * ca * width
    fwd = points * per_point + factors
    bwd = points * per_point + 2 * factors
    return fwd + (bwd if backward else 0)


def normalize(pts: torch.Tensor, bound: float) -> torch.Tensor:
    return (pts - (-bound)) * (2.0 / (2.0 * bound)) - 1.0


def positional_encoding(x: torch.Tensor, freqs: int) -> torch.Tensor:
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    scaled = (x[..., None] * bands).reshape(*x.shape[:-1], x.shape[-1] * freqs)
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


def plane_samples(plane: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """``(N, C)`` bilinear samples of ``plane (R_b, R_a, C)`` at ``(xa,
    xb)``."""
    image = plane.permute(2, 0, 1)[None]  # (1, C, R_b, R_a)
    grid = torch.stack([xa, xb], dim=-1)[None, :, None, :]  # (1, N, 1, 2): x indexes R_a, y R_b
    return F.grid_sample(image, grid, mode="bilinear", align_corners=True)[0, :, :, 0].t()


def line_samples(line: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """``(N, C)`` linear samples of ``line (R_c, C)`` at ``xc``."""
    image = line.t()[None, :, :, None]  # (1, C, R_c, 1)
    grid = torch.stack([torch.zeros_like(xc), xc], dim=-1)[None, :, None, :]
    return F.grid_sample(image, grid, mode="bilinear", align_corners=True)[0, :, :, 0].t()


def vm_encode(params: Dict, xhat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sigma_feat (N,), app (N, 3 C_a))``, zero outside the box."""
    inside = (xhat.abs() <= 1.0).all(dim=-1)
    sigma = 0.0
    app = []
    for m in range(3):
        (a, b), c = PLANE_AXES[m], LINE_AXES[m]
        xa, xb, xc = xhat[:, a], xhat[:, b], xhat[:, c]
        key = str(m)
        sigma = sigma + (plane_samples(params["density_plane"][key], xa, xb)
                         * line_samples(params["density_line"][key], xc)).sum(dim=-1)
        app.append(plane_samples(params["app_plane"][key], xa, xb) * line_samples(params["app_line"][key], xc))
    app = torch.cat(app, dim=-1)
    return torch.where(inside, sigma, torch.zeros_like(sigma)), torch.where(inside[:, None], app, torch.zeros_like(app))


def field(params: Dict, pts: torch.Tensor, dirs: torch.Tensor, cfg: Dict, rounding: Rounding = None):
    """``(sigma (...), rgb (..., 3))`` of one network at points and
    (unnormalised) ray directions, with TF32 off."""
    strict_f32()
    shape = pts.shape[:-1]
    xhat = normalize(pts.reshape(-1, 3), cfg["network.aabb_bound"])
    sigma_feat, app = vm_encode(params, xhat)
    inside = (xhat.abs() <= 1.0).all(dim=-1)
    sigma = torch.where(inside, cfg["network.distance_scale"] * F.softplus(sigma_feat + cfg["network.density_shift"]),
                        torch.zeros_like(sigma_feat))
    basis = params["basis_mat"]["w"]
    feat = linear(app, basis, torch.zeros(basis.shape[1], dtype=basis.dtype, device=basis.device), rounding)
    d = dirs.reshape(-1, 3)
    view = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    h = torch.cat([feat, view, positional_encoding(feat, cfg["network.fea_pe"]),
                   positional_encoding(view, cfg["network.view_pe"])], dim=-1)
    mlp = params["render_mlp"]
    for name in ("fc_0", "fc_1"):
        h = torch.relu(linear(h, mlp[name]["w"], mlp[name]["b"], rounding))
    rgb = torch.sigmoid(linear(h, mlp["fc_2"]["w"], mlp["fc_2"]["b"], rounding))
    return sigma.reshape(shape), rgb.reshape(*shape, 3)


# The shaping of the seed's weights into a field like a trained one. The
# seed draws every factor U(-t, t) (the configuration's ``table_bound``,
# TensoRF's init_scale 0.1 as a standard deviation): then f is ~0 and
# sigma = 25 softplus(-10) ~ 1.1e-3, so a ray through the box reaches an
# opacity of ~0.5% and the colour hardly depends on the appearance.
DENSITY_NOISE = 3.0  # the density factors' draws scaled by this: f varies by ~1 from texel to texel
DENSITY_BASE = 5.7  # f's mean: sigma ~0.7 a unit of t, an opacity of 0.5-1 over a ray's 1.5-5 units in the box
APP_SCALE = 10.0  # the appearance factors scaled by this: products and basis features of order 1


def prepare(params: Dict, cfg: Dict) -> None:
    """Shape seeded weights, in place: every density factor scaled by
    ``DENSITY_NOISE`` and raised by ``sqrt(DENSITY_BASE / (3 C_d))``, so
    that f has mean ~``DENSITY_BASE`` with texel-to-texel variation (a
    density positive everywhere in the box, its rays reaching an opacity
    between ~0.5 and 1 without saturating in the first samples); every
    appearance factor scaled by ``APP_SCALE``."""
    _, cd, _ = _sizes(cfg)
    lift = (DENSITY_BASE / (3 * cd)) ** 0.5
    for net in params.values():
        for m in range(3):
            for key in ("density_plane", "density_line"):
                net[key][str(m)].mul_(DENSITY_NOISE).add_(lift)
            for key in ("app_plane", "app_line"):
                net[key][str(m)].mul_(APP_SCALE)
