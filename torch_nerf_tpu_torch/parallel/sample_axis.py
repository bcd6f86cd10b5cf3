"""Compositing over a sample axis sharded across ranks.

Counterpart of ``torch_nerf_tpu/parallel/sample_axis.py``: the per-ray
transmittance is an exclusive prefix sum of ``sigma * delta`` along the
samples, so with the samples split over a group of ranks it factors into

1. a local exclusive cumsum within each rank's samples,
2. an exclusive sum of the ranks' totals (an ``all_gather`` of ``(N, 1)``),
3. a sum of the ranks' partial RGB (an ``all_reduce`` of ``(N, 3)``).

Plain torch: the JAX package has no kernel here either.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from torch_nerf_tpu_torch.parallel import collectives


def composite_shard(sigma: torch.Tensor, radiance: torch.Tensor, delta: torch.Tensor, group
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's composite over its samples ``sigma (N, S_r)``,
    ``radiance (N, S_r, 3)``, ``delta (N, S_r)`` (the last rank's last
    interval carries the 1e8 tail) -> ``(rgb (N, 3), the whole sum on every
    rank; weights (N, S_r), this rank's share of the weights)``."""
    sigma_delta = sigma * delta
    accum = torch.cumsum(sigma_delta, dim=-1)
    # the exclusive sum by a shift, not accum - sigma_delta: the 1e8 tail
    # would cancel the whole prefix in f32
    local_exclusive = torch.cat([torch.zeros_like(accum[..., :1]), accum[..., :-1]], dim=-1)
    totals = collectives.all_gather(accum[..., -1:], group, dim=-1)  # (N, ranks)
    before = torch.arange(totals.shape[-1], device=totals.device) < dist.get_rank(group)
    prefix = torch.sum(totals * before, dim=-1, keepdim=True)
    transmittance = torch.exp(-(local_exclusive + prefix))
    weights = transmittance * (1.0 - torch.exp(-sigma_delta))
    rgb = collectives.all_reduce(torch.sum(weights[..., None] * radiance, dim=-2), group)
    return rgb, weights


def make_sample_sharded_composite(group) -> Callable:
    """``composite(sigma (N, S), radiance (N, S, 3), delta (N, S)) -> (rgb
    (N, 3), weights (N, S))`` on whole arrays, the same on every rank of
    ``group``: each rank composites its ``S / ranks`` samples
    (:func:`composite_shard`) and the weights are gathered, the
    counterpart of ``ops.integration.composite``."""

    def composite(sigma, radiance, delta):
        size = collectives.group_size(group)
        if sigma.shape[-1] % size != 0:
            raise ValueError(f"{sigma.shape[-1]} samples must divide over {size} ranks")
        width = sigma.shape[-1] // size
        mine = slice(dist.get_rank(group) * width, (dist.get_rank(group) + 1) * width)
        rgb, weights = composite_shard(sigma[:, mine], radiance[:, mine], delta[:, mine], group)
        return rgb, collectives.all_gather(weights, group, dim=-1)

    return composite
