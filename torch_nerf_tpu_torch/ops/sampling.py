"""Ray sampling: stratified bins and inverse-CDF (hierarchical) sampling.

Counterpart of ``torch_nerf_tpu/ops/sampling.py:31-184``. Every function
that draws random numbers takes an explicit ``torch.Generator`` and has a
``*_from_uniforms`` core that takes the draws instead, so a test can feed
both packages the same numbers (JAX's threefry and torch's generators
differ).
"""

from __future__ import annotations

from typing import Tuple

import torch

# Sentinel after the last sample so the final interval is effectively infinite.
DELTA_SENTINEL = 1e8


def t_bins(
    t_near: float, t_far: float, num_bins: int, device=None
) -> Tuple[torch.Tensor, float]:
    """Left edges ``(num_bins,)`` of equal partitions of [t_near, t_far], and
    the bin size."""
    bins = torch.linspace(t_near, t_far, num_bins + 1, dtype=torch.float32, device=device)[:-1]
    return bins, (t_far - t_near) / num_bins


def stratified_t_samples_from_uniforms(
    jitter: torch.Tensor, t_near: float, t_far: float
) -> torch.Tensor:
    """One jittered sample per bin: ``t = bin_left + size * jitter (N, S)``."""
    bins, size = t_bins(t_near, t_far, jitter.shape[-1], device=jitter.device)
    return bins[None, :] + size * jitter


def stratified_t_samples(
    generator: torch.Generator, num_rays: int, t_near: float, t_far: float, num_samples: int
) -> torch.Tensor:
    jitter = torch.rand((num_rays, num_samples), generator=generator, device=generator.device)
    return stratified_t_samples_from_uniforms(jitter, t_near, t_far)


def sample_pdf_from_uniforms(
    bins: torch.Tensor,
    bin_size: float,
    weights: torch.Tensor,
    u: torch.Tensor,
    jitter: torch.Tensor,
) -> torch.Tensor:
    """Inverse-CDF sampling from per-ray histograms -> ``(N, S_f)``.

    ``weights + 1e-5``, an exclusive-cumsum CDF, the bin of ``u`` as
    ``searchsorted(cdf, u, right=True) - 1`` clamped to the bins, and
    uniform jitter within that bin. ``bins`` are the uniform left edges
    ``(N, S_c)``, so a bin's start is ``bins[:, :1] + idx * bin_size``.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf_inner = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf_inner[..., :1]), cdf_inner[..., :-1]], dim=-1)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True) - 1
    idx = idx.clamp(0, bins.shape[-1] - 1)
    t_start = bins[..., :1] + idx.to(bins.dtype) * bin_size
    return t_start + bin_size * jitter


def hierarchical_t_samples_from_uniforms(
    weights: torch.Tensor,
    t_near: float,
    t_far: float,
    coarse_jitter: torch.Tensor,
    u: torch.Tensor,
    fine_jitter: torch.Tensor,
) -> torch.Tensor:
    """Fresh coarse stratification (``coarse_jitter (N, S_c)``) merged with
    inverse-CDF draws (``u``, ``fine_jitter (N, S_f)``) from the coarse
    ``weights``, sorted -> ``(N, S_c + S_f)``."""
    num_rays, num_coarse = coarse_jitter.shape
    bins, size = t_bins(t_near, t_far, num_coarse, device=coarse_jitter.device)
    bins = bins[None, :].expand(num_rays, num_coarse)
    t_coarse = bins + size * coarse_jitter
    t_fine = sample_pdf_from_uniforms(bins, size, weights, u, fine_jitter)
    return torch.sort(torch.cat([t_coarse, t_fine], dim=-1), dim=-1).values


def hierarchical_t_samples(
    generator: torch.Generator,
    weights: torch.Tensor,
    t_near: float,
    t_far: float,
    num_coarse: int,
    num_fine: int,
) -> torch.Tensor:
    n, dev = weights.shape[0], generator.device
    coarse_jitter = torch.rand((n, num_coarse), generator=generator, device=dev)
    u = torch.rand((n, num_fine), generator=generator, device=dev)
    fine_jitter = torch.rand((n, num_fine), generator=generator, device=dev)
    return hierarchical_t_samples_from_uniforms(weights, t_near, t_far, coarse_jitter, u, fine_jitter)


def t_deltas(t_samples: torch.Tensor) -> torch.Tensor:
    """``delta_i = t_{i+1} - t_i`` with the 1e8 sentinel last."""
    tail = torch.full_like(t_samples[..., :1], DELTA_SENTINEL)
    return torch.diff(torch.cat([t_samples, tail], dim=-1), dim=-1)


def points_along_rays(
    ray_origin: torch.Tensor, ray_dir: torch.Tensor, t_samples: torch.Tensor
) -> torch.Tensor:
    """``o + t * d`` -> ``(N, S, 3)``."""
    return ray_origin[:, None, :] + t_samples[..., None] * ray_dir[:, None, :]
