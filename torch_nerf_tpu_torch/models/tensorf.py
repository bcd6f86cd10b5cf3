"""TensoRF-VM: the vector-matrix factorised radiance field of Chen, Xu,
Geiger, Yu and Su, "TensoRF: Tensorial Radiance Fields" (ECCV 2022,
arXiv:2203.09507, section 4; the public code's ``TensorVMSplit`` with
``MLPRender_Fea``).

A point ``x`` is normalised to ``xhat = (x - aabb_min) * 2 / (aabb_max -
aabb_min) - 1`` in the box ``[-bound, bound]^3``; a point outside the box
has density 0. The density feature is the sum over the three planes m and
their density components of plane sample x line sample
(:mod:`ops.vm_grid`), and ``sigma = distance_scale * softplus(f +
density_shift)``: TensoRF's ``distance_scale`` folded into sigma, so that
the port's compositing (``sigma * delta``) is unchanged. The appearance's
3 x C_a products go through ``basis_mat`` (linear, no bias) to ``app_dim``
features; the render MLP takes ``[features, view, PE(features), PE(view)]``
(the view direction normalised to unit length; TensoRF's
``positional_encoding``: channel-major products with 1, 2, ..., 2^(F-1),
all sines, then all cosines, no pi) through ``Linear -> ReLU -> Linear ->
ReLU -> Linear`` to a sigmoid.

The parameter tree: ``{"density_plane": {"0", "1", "2"}, "density_line":
..., "app_plane": ..., "app_line": ..., "basis_mat": {"w"}, "render_mlp":
{"fc_0", "fc_1", "fc_2": {"w", "b"}}}``, planes ``(R_b, R_a, C)`` and
lines ``(R_c, C)`` (components fastest), linear weights stored ``(in,
out)``. The JAX package has no counterpart.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from torch_nerf_tpu_torch import tracing
from torch_nerf_tpu_torch.ops import vm_grid

Params = Dict[str, Any]

FACTOR_KEYS = ("density_plane", "density_line", "app_plane", "app_line")
INIT_SCALE = 0.1  # TensoRF's init_scale: factors drawn 0.1 * N(0, 1)


def factor_shapes(grid_res: int, density_components: int, app_components: int) -> Dict[str, Tuple[int, ...]]:
    """``{key: shape}`` of each factor group's three tensors (a cubic grid:
    planes ``(R, R, C)``, lines ``(R, C)``)."""
    r = grid_res
    return {"density_plane": (r, r, density_components), "density_line": (r, density_components),
            "app_plane": (r, r, app_components), "app_line": (r, app_components)}


def mlp_in_dim(app_dim: int, fea_pe: int, view_pe: int) -> int:
    """``[features, view, PE(features), PE(view)]``: 27 + 3 + 108 + 12 = 150
    at the published sizes."""
    return app_dim + 3 + 2 * fea_pe * app_dim + 2 * view_pe * 3


def mlp_shapes(app_components: int, app_dim: int, feature_c: int, fea_pe: int,
               view_pe: int) -> Dict[str, Tuple[int, int]]:
    """(in, out) of ``basis_mat`` and the render MLP's three layers."""
    return {"basis_mat": (3 * app_components, app_dim), "fc_0": (mlp_in_dim(app_dim, fea_pe, view_pe), feature_c),
            "fc_1": (feature_c, feature_c), "fc_2": (feature_c, 3)}


def macs_per_point(app_components: int, app_dim: int, feature_c: int, fea_pe: int, view_pe: int,
                   density_components: int) -> int:
    """Multiply-adds a point: ``basis_mat`` and the render MLP, plus the VM
    encode's plane x line products (3 x (C_d + C_a))."""
    mlp = sum(i * o for i, o in mlp_shapes(app_components, app_dim, feature_c, fea_pe, view_pe).values())
    return mlp + 3 * (density_components + app_components)


def _linear(generator, fan_in: int, fan_out: int, device, bias: bool = True) -> Dict[str, torch.Tensor]:
    bound = 1.0 / math.sqrt(fan_in)
    out = {"w": (torch.rand((fan_in, fan_out), generator=generator, device=device) * 2 - 1) * bound}
    if bias:
        out["b"] = (torch.rand((fan_out,), generator=generator, device=device) * 2 - 1) * bound
    return out


def init_tensorf_params(
    generator: torch.Generator,
    grid_res: int = 300,
    density_components: int = 16,
    app_components: int = 48,
    app_dim: int = 27,
    feature_c: int = 128,
    fea_pe: int = 2,
    view_pe: int = 2,
    device: Optional[torch.device] = None,
) -> Params:
    """TensoRF's init, drawn from ``generator`` in this order: the factors
    ``INIT_SCALE * N(0, 1)`` (density planes, density lines, appearance
    planes, appearance lines, m = 0, 1, 2 each), then ``basis_mat`` and the
    render MLP as PyTorch's ``nn.Linear`` draws them (U(-1/sqrt(in),
    1/sqrt(in))), the last layer's bias 0."""
    params: Params = {}
    for key, shape in factor_shapes(grid_res, density_components, app_components).items():
        params[key] = {str(m): INIT_SCALE * torch.randn(shape, generator=generator, device=device)
                       for m in range(3)}
    shapes = mlp_shapes(app_components, app_dim, feature_c, fea_pe, view_pe)
    params["basis_mat"] = _linear(generator, *shapes["basis_mat"], device, bias=False)
    mlp = {name: _linear(generator, *shapes[name], device) for name in ("fc_0", "fc_1", "fc_2")}
    mlp["fc_2"]["b"].zero_()
    params["render_mlp"] = mlp
    return params


def factors_of(params: Params) -> vm_grid.Factors:
    return vm_grid.Factors(*(tuple(params[key][str(m)] for m in range(3)) for key in FACTOR_KEYS))


def normalize_points(pts: torch.Tensor, bound: float) -> torch.Tensor:
    """TensoRF's ``normalize_coord`` in the box ``[-bound, bound]^3``."""
    return (pts - (-bound)) * (2.0 / (2.0 * bound)) - 1.0


def encoding_terms(x: torch.Tensor, freqs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sines and cosines of TensoRF's ``positional_encoding`` of ``x
    (..., D)``: ``sin(x_d 2^f)`` and ``cos(x_d 2^f)``, ``(..., D F)`` each,
    channel-major."""
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    scaled = (x[..., None] * bands).reshape(*x.shape[:-1], x.shape[-1] * freqs)
    return torch.sin(scaled), torch.cos(scaled)


def positional_encoding(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """TensoRF's ``positional_encoding``: ``x (..., D)`` -> ``(..., 2 D F)``,
    all sines, then all cosines."""
    return torch.cat(encoding_terms(x, freqs), dim=-1)


def vm_encode(params: Params, xhat: torch.Tensor, out_dtype: torch.dtype, use_kernel: bool = True):
    """``(sigma_feat (N,) f32, app (N, 3 C_a) out_dtype)`` of ``xhat (N,
    3)``: through the VM kernels (their plain versions on CPU tensors) when
    ``use_kernel``, else the plain version by autograd."""
    factors = factors_of(params)
    if use_kernel:
        return vm_grid.vm_encode(factors, xhat, out_dtype)
    sigma, app = vm_grid.vm_encode_reference(factors, xhat)
    return sigma, app.to(out_dtype)


def render_mlp_apply(params: Params, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``Linear -> ReLU -> Linear -> ReLU -> Linear``: the two hidden layers
    in ``compute_dtype``, each product accumulated in f32 with its bias and
    rounded once (``addmm``); the last layer in f32, so that the three
    colour pre-activations, which the loss differentiates, are not rounded
    to ``compute_dtype``."""

    def linear(p, v):
        return torch.addmm(p["b"].to(compute_dtype), v, p["w"].to(compute_dtype))

    h = torch.relu(linear(params["fc_0"], x))
    h = torch.relu(linear(params["fc_1"], h))
    return torch.addmm(params["fc_2"]["b"], h.float(), params["fc_2"]["w"])


def view_encoding(dirs: torch.Tensor, view_pe: int) -> torch.Tensor:
    """``[view, PE(view)]`` of the unit view directions, ``(R, 1, 3 + 6
    view_pe)``: once a ray where ``dirs`` is a ray's direction expanded over
    its samples (``(R, S, 3)`` with stride 0 over S, as
    ``renderer._render_pass`` passes them), else once a point (R = N)."""
    d = dirs[:, 0] if dirs.dim() == 3 and dirs.stride(1) == 0 else dirs.reshape(-1, 3)
    view = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return torch.cat([view, positional_encoding(view, view_pe)], dim=-1)[:, None, :]


def tensorf_apply(
    params: Params,
    pts: torch.Tensor,
    dirs: torch.Tensor,
    bound: float = 1.5,
    density_shift: float = -10.0,
    distance_scale: float = 25.0,
    fea_pe: int = 2,
    view_pe: int = 2,
    compute_dtype: torch.dtype = torch.float32,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sigma (...), rgb (..., 3))`` at points and (unnormalised) ray
    directions ``(..., 3)``. The factors and the density stay in f32;
    ``basis_mat`` and the render MLP's hidden layers take ``compute_dtype``
    products (:func:`render_mlp_apply`). The
    features' encoding is taken in ``compute_dtype`` from the rounded
    features: their products with 2^f are exact, and sin and cos are
    computed in f32 and rounded, as from the features in f32."""
    batch_shape = pts.shape[:-1]
    xhat = normalize_points(pts.reshape(-1, 3), bound)
    with tracing.span("field.vm_encode"):
        sigma_feat, app = vm_encode(params, xhat, compute_dtype, use_kernel)
        inside = vm_grid.inside_box(xhat)
        sigma = torch.where(inside, distance_scale * torch.nn.functional.softplus(sigma_feat + density_shift),
                            torch.zeros_like(sigma_feat))
    with tracing.span("field.basis"):
        feat = torch.matmul(app, params["basis_mat"]["w"].to(compute_dtype))
    with tracing.span("field.render_mlp"):
        view = view_encoding(dirs, view_pe).to(compute_dtype)
        rays = view.shape[0]
        view = view.expand(rays, feat.shape[0] // rays, -1)
        f = feat.view(rays, -1, feat.shape[-1])
        mlp_in = torch.cat([f, view[..., :3], *encoding_terms(f, fea_pe), view[..., 3:]], dim=-1)
        rgb = torch.sigmoid(render_mlp_apply(params["render_mlp"], mlp_in.view(feat.shape[0], -1), compute_dtype))
    tracing.backward_spans([(rgb, "field.render_mlp.bwd"), (feat, "field.basis.bwd"), (app, None)])
    return sigma.reshape(batch_shape), rgb.reshape(*batch_shape, 3)
