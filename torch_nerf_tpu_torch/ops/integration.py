"""Volume-rendering quadrature (alpha compositing) along rays.

Counterpart of ``torch_nerf_tpu/ops/integration.py:27-55``:
``T_i = exp(-sum_{j<i} sigma_j delta_j)``, ``alpha_i = 1 - exp(-sigma_i
delta_i)``, ``w_i = T_i alpha_i``, ``C = sum_i w_i c_i``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def composite(
    sigma: torch.Tensor, radiance: torch.Tensor, delta: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sigma (N, S)``, ``radiance (N, S, 3)``, ``delta (N, S)`` ->
    ``(rgb (N, 3), weights (N, S))``."""
    sigma_delta = sigma * delta
    accum = torch.cumsum(sigma_delta, dim=-1)
    exclusive = torch.cat([torch.zeros_like(accum[..., :1]), accum[..., :-1]], dim=-1)
    transmittance = torch.exp(-exclusive)
    alpha = 1.0 - torch.exp(-sigma_delta)
    weights = transmittance * alpha
    rgb = torch.sum(weights[..., None] * radiance, dim=-2)
    return rgb, weights
