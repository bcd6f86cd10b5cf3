"""Kernel 9's grouping, emulated on the CPU, against the plain backward and
the JAX package's.

Kernel 9 (``hash_fold_bwd_kernel``) runs one warp per level of a window of
32 consecutive points; the lanes of a run of equal packed rows sum their
weighted cotangents (a corner of zero weight contributes an exact zero),
and the run's first lane adds the sums to the row. The kernel runs only on
a Hopper card; :func:`grouped_fold_backward` is a plain emulation of that
grouping (windows of 32 points per level, a sum over each run of equal
rows, one ``index_add_`` of the run sums into the table gradient), held
against ``fold_backward_reference`` and the JAX package's jitted
``hash_fold._bwd_xla`` on ``packed`` and ``packed_dual`` tables with
numpy-seeded inputs: samples along rays (runs of equal rows), a ragged
tail (n % 32 != 0), every point in one voxel, and integral points (zero
weights). Tolerance: relative L2 1e-6 (the same f32 sums in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nerf_tpu.models import instant_ngp as jngp
from torch_nerf_tpu.ops.pallas import hash_fold as jfold
from torch_nerf_tpu_torch.models import hash_math
from torch_nerf_tpu_torch.ops import hash_grid

LAYOUTS = ("packed", "packed_dual")
CASES = ("rays", "one_voxel", "integral")
LEVELS, LOG_T, MIN_RES, MAX_RES = 3, 10, 4, 16
WARP = 32


def _grid(layout):
    res = jngp.level_resolutions(LEVELS, MIN_RES, MAX_RES)
    if layout == "packed_dual":
        r, o = jngp.dual_resolutions_offsets(jnp.asarray(res))
        return np.array(r, np.float32), np.array(o, np.float32)
    return np.asarray(res, np.float32), np.zeros(LEVELS, np.float32)


def _points(case, seed):
    """n = 32k + 13 points of one contention case."""
    rng = np.random.default_rng(seed)
    if case == "rays":  # 10 rays of 40 sorted samples on a unit segment, cut: runs of equal rows
        o = rng.uniform(-1.5, 1.5, (10, 3))
        d = rng.normal(size=(10, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = np.sort(rng.uniform(0.0, 1.0, (10, 40)), axis=1)
        pts = (o[:, None] + t[..., None] * d[:, None]).reshape(-1, 3)[: 11 * WARP + 13]
    elif case == "one_voxel":  # every point within 1e-3 of (0.3, -0.41, 0.17)
        pts = np.array([0.3, -0.41, 0.17]) + rng.uniform(0.0, 1e-3, (4 * WARP + 13, 3))
    else:  # integral on every axis, on two, and points between them
        integral = rng.integers(-3, 4, (2 * WARP, 3)).astype(np.float64)
        integral[WARP:, 0] += 0.3
        pts = np.concatenate([integral, rng.uniform(-1.5, 1.5, (WARP + 13, 3))])
    return pts.astype(np.float32)


def grouped_fold_backward(g, coords, resolutions, offsets, num_lines, feat_dim):
    """The plain emulation of kernel 9: for each level, the points in
    windows of 32; in each window, runs of consecutive points on equal
    packed rows; each run's weighted cotangents summed (a zero weight gives
    an exact zero), then one ``index_add_`` of every run's sums into its
    row. -> ``dtables (L, num_lines, 128)``."""
    num_level, f = resolutions.shape[0], feat_dim
    rows = hash_grid.check_fold_layout((num_level, num_lines, 128), f)
    n = coords.shape[0]
    row, w = hash_math.packed_prep(coords, resolutions, rows, offsets)  # (L, n), (L, n, 8)
    gl = g.reshape(n, num_level, 1, f).permute(1, 0, 2, 3)  # (L, n, 1, F)
    vals = torch.where(w[..., None] == 0.0, 0.0, gl * w[..., None]).reshape(num_level, n, 8 * f)
    lane = torch.arange(n) % WARP
    dflat = torch.zeros((num_level * rows, 8 * f), dtype=torch.float32)
    for level in range(num_level):
        r = row[level]
        head = (lane == 0) | torch.cat([torch.ones(1, dtype=torch.bool), r[1:] != r[:-1]])
        run = torch.cumsum(head.long(), 0) - 1
        sums = torch.zeros((int(head.sum()), 8 * f)).index_add_(0, run, vals[level])
        dflat.index_add_(0, level * rows + r[head], sums)
    return dflat.reshape(num_level, num_lines, 128)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", CASES)
def test_grouped_backward_matches_plain_and_jax(layout, case):
    f = 2
    r, o = _grid(layout)
    levels = r.shape[0]
    rows = 2**LOG_T // 8
    num_lines = rows // hash_grid.fold_factor(f)
    pts = _points(case, seed=CASES.index(case))
    n = pts.shape[0]
    assert n % WARP == 13
    g = np.random.default_rng(7).normal(size=(n, levels * f)).astype(np.float32)
    args = (torch.from_numpy(g), torch.from_numpy(pts), torch.from_numpy(r), torch.from_numpy(o), num_lines, f)
    got = grouped_fold_backward(*args)
    ref = hash_grid.fold_backward_reference(*args)
    cfg = jfold.FoldCfg(feat_dim=f, num_rows=rows, num_level=levels, use_kernel=False, interpret=False, tile=128)
    g128 = np.pad(g, ((0, 0), (0, 128 - levels * f)))
    jref = jax.jit(lambda a, b, c, d: jfold._bwd_xla(a, b, c, d, num_lines, cfg))(
        jnp.asarray(g128), jnp.asarray(pts), jnp.asarray(r), jnp.asarray(o))
    jref = torch.from_numpy(np.array(jref).reshape(levels, num_lines, 128))
    for want in (ref, jref):
        assert got.shape == want.shape
        assert ((got - want).norm() / want.norm()).item() <= 1e-6

    row, w = hash_math.packed_prep(args[1], args[2], rows, args[3])
    if case != "integral":  # the grouping took place: a run in a window spans several points
        assert bool(((row[:, 1:] == row[:, :-1]) & (torch.arange(1, n) % WARP != 0)).any())
    if case == "one_voxel":
        assert all(len(torch.unique(level_rows)) == 1 for level_rows in row)
        # a whole row's gradient is the sum of every point's share
        assert torch.allclose(got.reshape(levels, rows, 8 * f).sum(dim=(1, 2)),
                              ref.reshape(levels, rows, 8 * f).sum(dim=(1, 2)), rtol=1e-5, atol=1e-5)
    if case == "integral":
        # integral on every axis: every weight of a base level vanishes
        assert w[:LEVELS, :WARP].abs().max() == 0.0


def test_grouping_counts_one_atomic_row_a_run():
    """The emulation's run heads: a window starts a run, and so does every
    change of row; a warp of one voxel is one run."""
    r, o = _grid("packed")
    pts = torch.from_numpy(_points("one_voxel", seed=1))
    row, _ = hash_math.packed_prep(pts, torch.from_numpy(r), 2**LOG_T // 8, torch.from_numpy(o))
    n = pts.shape[0]
    lane = torch.arange(n) % WARP
    for level_rows in row:
        head = (lane == 0) | torch.cat([torch.ones(1, dtype=torch.bool), level_rows[1:] != level_rows[:-1]])
        assert int(head.sum()) == -(-n // WARP)
