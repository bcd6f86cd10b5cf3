"""Rays, stratified and inverse-CDF sampling and alpha compositing, as the
NeRF paper (section 4 and 5.2) and its published code define them.

Pixel ``p`` of an ``(H, W)`` image has ``x = p % W``, ``y = H - 1 - p //
W``; its camera-frame direction is ``((x - W/2) / f, (y - H/2) / f, -1)``,
unnormalised, turned by the camera-to-world rotation; the origin is the
camera's position. A pass of ``S`` samples splits ``[near, far]`` into
``S`` equal bins with one uniformly jittered sample a bin. The fine pass
draws a fresh stratification of the coarse bins and, from the coarse
weights + 1e-5 normalised to a histogram over them, ``S_f`` inverse-CDF
samples, each jittered uniformly inside its bin; the union, sorted, is the
fine pass's samples. ``delta_i = t_{i+1} - t_i`` with 1e8 after the last;
``w_i = exp(-sum_{j<i} sigma_j delta_j) (1 - exp(-sigma_i delta_i))``,
``C = sum_i w_i c_i`` on a black background.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

SENTINEL = 1e8


def pixel_rays(pixels: torch.Tensor, height: int, width: int, focal: float, pose: torch.Tensor):
    """``(origins (N, 3), directions (N, 3))`` of flat pixel indices."""
    p = pixels.to(torch.int64)
    x = (p % width).float()
    y = ((height - 1) - p // width).float()
    d_cam = torch.stack([(x - width / 2.0) / focal, (y - height / 2.0) / focal, -torch.ones_like(x)], dim=-1)
    rot, trans = pose[:3, :3].float(), pose[:3, 3].float()
    d = d_cam @ rot.T
    return trans.expand_as(d), d


def stratified(jitter: torch.Tensor, near: float, far: float) -> torch.Tensor:
    num = jitter.shape[-1]
    edges = torch.linspace(near, far, num + 1, dtype=torch.float32, device=jitter.device)[:-1]
    return edges + ((far - near) / num) * jitter


def inverse_cdf(weights: torch.Tensor, near: float, far: float, coarse_jitter: torch.Tensor, u: torch.Tensor,
                fine_jitter: torch.Tensor) -> torch.Tensor:
    """Fresh stratification merged with inverse-CDF samples, sorted."""
    num = coarse_jitter.shape[-1]
    size = (far - near) / num
    edges = torch.linspace(near, far, num + 1, dtype=torch.float32, device=weights.device)[:-1]
    w = weights + 1e-5
    pdf = w / w.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf[:, :-1]], dim=-1)
    idx = (torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True) - 1).clamp(0, num - 1)
    t_fine = edges[0] + idx.float() * size + size * fine_jitter
    t_coarse = edges + size * coarse_jitter
    return torch.sort(torch.cat([t_coarse, t_fine], dim=-1), dim=-1).values


def composite(sigma: torch.Tensor, rgb: torch.Tensor, t: torch.Tensor):
    """``(C (N, 3), weights (N, S))``."""
    delta = torch.diff(torch.cat([t, torch.full_like(t[:, :1], SENTINEL)], dim=-1), dim=-1)
    sd = sigma * delta
    acc = torch.cumsum(sd, dim=-1)
    trans = torch.exp(-torch.cat([torch.zeros_like(acc[:, :1]), acc[:, :-1]], dim=-1))
    w = trans * (1.0 - torch.exp(-sd))
    return torch.sum(w[..., None] * rgb, dim=-2), w


def render(field: Callable, params: Dict, o: torch.Tensor, d: torch.Tensor, uniforms, near: float, far: float,
           hierarchical: bool) -> Dict[str, Optional[torch.Tensor]]:
    """The coarse pass and, if ``hierarchical``, the fine pass of rays
    ``o``, ``d`` on the draws ``uniforms`` (coarse, fine_coarse, u, fine):
    ``{"coarse": C, "fine": C or None}``. ``field(params_of_net, pts,
    dirs)``; the fine samples come from the coarse weights, detached."""

    def one_pass(net_params, t):
        pts = o[:, None, :] + t[..., None] * d[:, None, :]
        sigma, rgb = field(net_params, pts, d[:, None, :].expand_as(pts))
        return composite(sigma, rgb, t)

    t_c = stratified(uniforms[0], near, far)
    c_c, w_c = one_pass(params["coarse"], t_c)
    if not hierarchical:
        return {"coarse": c_c, "fine": None}
    t_f = inverse_cdf(w_c.detach(), near, far, uniforms[1], uniforms[2], uniforms[3])
    c_f, _ = one_pass(params["fine"], t_f)
    return {"coarse": c_c, "fine": c_f}
