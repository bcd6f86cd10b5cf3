"""Occupancy-grid sample pruning: skip empty space before the field.

Counterpart of ``torch_nerf_tpu/occupancy.py:65-309``:

* a dense ``R^3`` grid of EMA-max densities over ``[-bound, bound]^3``,
  refreshed every ``update_every`` steps by the field's density at one
  jittered point a cell, ``g = max(decay * g, sigma)``;
* a train step draws its usual ``S`` stratified candidates a ray, looks up
  their cells and keeps a static ``K``: every occupied sample when at most
  ``K`` are, else ``K`` evenly spaced among them; leftover slots take the
  earliest unoccupied samples, placed after the kept ones (out of ``t``
  order: their density is about 0, so compositing does not see where they
  sit);
* each kept sample composites over the span it covers: its own interval
  and those of the dropped occupied samples up to the next kept one. When at
  most ``K`` are occupied this is the dense quadrature wherever the pruned
  density is 0; over budget it is a coarsened quadrature that keeps the
  optical depth. The last kept sample's span runs to the ray's end and so
  takes the 1e8 tail of an occupied last sample that was dropped.

Before ``warmup_steps`` every cell reads occupied. The randomness is
explicit: the sweep takes its ``(R^3, 3)`` jitter as an argument
(:func:`draw_jitter` draws it from a ``torch.Generator``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from torch_nerf_tpu_torch.ops import sampling


@dataclasses.dataclass(frozen=True)
class OccupancyConfig:
    """``keep_samples`` is the static budget a ray after pruning;
    ``keep_samples_fine`` budgets a hierarchical model's merged fine set (0
    keeps it whole); ``warmup_steps`` reads every cell occupied for the
    first steps, while the grid (zero at first) forms."""

    resolution: int = 64
    bound: float = 4.0
    update_every: int = 16
    decay: float = 0.95
    threshold: float = 1e-2
    keep_samples: int = 128
    warmup_steps: int = 512
    keep_samples_fine: int = 0


def init_grid(cfg: OccupancyConfig, device: Optional[torch.device] = None) -> torch.Tensor:
    """The flat ``(R^3,)`` f32 density grid, all zero."""
    return torch.zeros((cfg.resolution**3,), dtype=torch.float32, device=device)


def cell_indices(pts: torch.Tensor, cfg: OccupancyConfig) -> torch.Tensor:
    """World points ``(..., 3)`` -> flat cell index (int64); points outside
    the grid take the nearest border cell."""
    r = cfg.resolution
    x = (pts + cfg.bound) * (r / (2.0 * cfg.bound))
    i = torch.floor(x).to(torch.int32).clamp(0, r - 1).long()
    return (i[..., 0] * r + i[..., 1]) * r + i[..., 2]


def occupied_mask(grid: torch.Tensor, pts: torch.Tensor, cfg: OccupancyConfig, step: int) -> torch.Tensor:
    """Boolean ``(...,)`` occupancy at world points; all True before
    ``warmup_steps``."""
    vals = grid[cell_indices(pts, cfg)]
    return (vals > cfg.threshold) | (step < cfg.warmup_steps)


def quota_keep_mask(occ: torch.Tensor, keep: int) -> torch.Tensor:
    """``(N, S)`` mask of the survivors, at most ``keep`` a ray: every
    occupied sample when their count ``m <= keep``, else the r-th occupied
    one iff ``floor(r * keep / m)`` steps up."""
    occ_i = occ.to(torch.int32)
    m = occ_i.sum(dim=-1, keepdim=True).clamp_min(1)
    r = torch.cumsum(occ_i, dim=-1, dtype=torch.int32)  # 1-based rank where occupied
    return occ & (torch.div(r * keep, m, rounding_mode="floor") > torch.div((r - 1) * keep, m, rounding_mode="floor"))


def _keep_order(kept: torch.Tensor, keep: int) -> torch.Tensor:
    """Indices ``(N, keep)``: the kept samples in ``t`` order, then the
    earliest others. The sort keys are distinct in a row, so any sort
    gives this order."""
    n, s = kept.shape
    pos = torch.arange(s, device=kept.device).expand(n, s)
    key = torch.where(kept, pos, pos + s)
    return torch.sort(key, dim=-1).indices[:, :keep]


def select_samples(occ: torch.Tensor, keep: int) -> torch.Tensor:
    """``keep`` sample indices a ray from an ``(N, S)`` occupancy mask, in
    :func:`prune_t_samples`'s order."""
    return _keep_order(quota_keep_mask(occ, keep), keep)


def prune_t_samples(
    grid: torch.Tensor,
    cfg: OccupancyConfig,
    ray_origin: torch.Tensor,
    ray_dir: torch.Tensor,
    t_samples: torch.Tensor,
    step: int,
    keep: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense ``(N, S)`` depths -> the kept ``(t (N, K), delta (N, K))``,
    ``delta`` each kept sample's covered span (the padding slots keep their
    own interval). ``keep`` overrides ``cfg.keep_samples``."""
    keep = cfg.keep_samples if keep is None else keep
    pts = sampling.points_along_rays(ray_origin, ray_dir, t_samples)
    occ = occupied_mask(grid, pts, cfg, step)
    kept = quota_keep_mask(occ, keep)
    dense_delta = sampling.t_deltas(t_samples)
    e_incl = torch.cumsum(dense_delta * occ.to(t_samples.dtype), dim=-1)
    # the exclusive sum by a shift: subtracting an occupied last sample's
    # 1e8 from the inclusive sum would cancel the whole prefix in f32
    e_excl = torch.cat([torch.zeros_like(e_incl[:, :1]), e_incl[:, :-1]], dim=-1)
    e_total = e_incl[:, -1:]

    order = _keep_order(kept, keep)
    t_sel = torch.gather(t_samples, 1, order)
    delta_sel = torch.gather(dense_delta, 1, order)
    e_sel = torch.gather(e_excl, 1, order)
    m = kept.sum(dim=-1, keepdim=True).clamp_max(keep)
    slot = torch.arange(keep, device=t_samples.device)[None, :]
    e_next = torch.cat([e_sel[:, 1:], torch.zeros_like(e_sel[:, :1])], dim=-1)
    covered = torch.where(slot + 1 < m, e_next - e_sel, e_total - e_sel)
    return t_sel, torch.where(slot < m, covered, delta_sel)


def scatter_weights_to_bins(
    t_sel: torch.Tensor, weights_sel: torch.Tensor, t_near: float, t_far: float, num_bins: int
) -> torch.Tensor:
    """Pruned coarse weights ``(N, K)`` -> weights on the ``num_bins``
    uniform coarse bins ``(N, num_bins)``: each kept sample still lies in
    its stratified bin, found from its depth; pruned bins get 0."""
    bin_size = (t_far - t_near) / num_bins
    idx = torch.floor((t_sel - t_near) / bin_size).to(torch.int32).clamp(0, num_bins - 1).long()
    out = torch.zeros((t_sel.shape[0], num_bins), dtype=weights_sel.dtype, device=weights_sel.device)
    return out.scatter_add_(1, idx, weights_sel)


def make_density_fn(field, params_key: str = "coarse") -> Callable[[Dict[str, Any], torch.Tensor], torch.Tensor]:
    """``(params, pts (M, 3)) -> sigma (M,)`` of the ``params_key`` network,
    with zero directions (they reach only the colour branch), through the
    field's inference route (``field.prepare``: kernel 1 for the fused
    field, ``ops/ngp_mlp.py``'s fused forward after the hash encode for a
    bf16 Instant-NGP field), building no graph."""

    def density(params: Dict[str, Any], pts: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            sigma, _ = field.apply(field.prepare(params[params_key]), pts, torch.zeros_like(pts))
        return sigma

    return density


def draw_jitter(generator: torch.Generator, cfg: OccupancyConfig) -> torch.Tensor:
    """The ``(R^3, 3)`` uniforms of one sweep, on the generator's device."""
    return torch.rand((cfg.resolution**3, 3), generator=generator, device=generator.device)


def sweep_points(jitter: torch.Tensor, cfg: OccupancyConfig) -> torch.Tensor:
    """The ``(R^3, 3)`` points a sweep reads: cell ``i`` at ``jitter[i]``
    of its extent."""
    r = cfg.resolution
    flat = torch.arange(r**3, device=jitter.device)
    ijk = torch.stack([(flat // (r * r)) % r, (flat // r) % r, flat % r], dim=-1)
    return (ijk.to(torch.float32) + jitter) * (2.0 * cfg.bound / r) - cfg.bound


def update_grid(
    grid: torch.Tensor,
    density_fn: Callable[..., torch.Tensor],
    params: Dict[str, Any],
    jitter: torch.Tensor,
    cfg: OccupancyConfig,
) -> torch.Tensor:
    """One EMA-max sweep at the jittered point ``jitter`` of every cell
    (:func:`sweep_points`): ``max(decay * grid, sigma)``, without a graph."""
    with torch.no_grad():
        sigma = density_fn(params, sweep_points(jitter, cfg))
        return torch.maximum(cfg.decay * grid, sigma.to(grid.dtype))


def is_update_step(step: int, cfg: OccupancyConfig) -> bool:
    """Whether the step with the state's ``step`` sweeps the grid."""
    return step % cfg.update_every == 0


def maybe_update_grid(
    grid: torch.Tensor,
    density_fn: Callable[..., torch.Tensor],
    params: Dict[str, Any],
    jitter: Optional[torch.Tensor],
    step: int,
    cfg: OccupancyConfig,
) -> torch.Tensor:
    """:func:`update_grid` on every ``update_every``-th step (``jitter``
    must then be given), else the grid as it is."""
    if not is_update_step(step, cfg):
        return grid
    if jitter is None:
        raise ValueError(f"step {step} updates the occupancy grid and needs its jitter")
    return update_grid(grid, density_fn, params, jitter, cfg)
