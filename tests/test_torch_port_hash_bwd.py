"""Kernels 5 and 7's grouping, emulated on the CPU, against the plain
backwards and the JAX package's.

Kernels 5 (``hash_brick_bwd_kernel``, the ``bricked`` layout) and 7
(``hash_corner_bwd_kernel<F>``, the ``hash`` layout) run one warp per level
of a window of 32 consecutive points. A run of consecutive lanes that write
the same rows sums its weighted cotangents (a site or corner of zero weight
contributes an exact zero), and the run's first lane adds the sums at its
own rows. Kernel 5's run shares the brick row and the floor site; kernel
7's run shares all 8 corner rows, not merely the floor voxel: at an
integral scaled coordinate span is 0 and the ceil-side corners sit on the
floor's vertex, so such a point heading a run of its voxel's points would
put their sums on its rows. The kernels run only on a Hopper card;
:func:`grouped_brick_backward` and :func:`grouped_corner_backward` are
plain emulations of that grouping (windows of 32 points per level, a sum
over each run, one ``index_add_`` of the run sums at the head's rows), held
against ``brick_backward_reference`` / ``corner_backward_reference`` and
the JAX package's jitted ``hash_brick._bwd_xla`` / VJP of
``instant_ngp.hash_encode`` with numpy-seeded inputs: samples along rays
(runs), every point in one voxel, and integral points heading and inside
runs of their voxel, each with a ragged tail (n % 32 = 13); kernel 7 at F
in {1, 2, 4, 8} and at a T that is not a power of two. Tolerance: relative
L2 1e-6 (the same f32 sums in another order).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nerf_tpu.models import instant_ngp as jngp
from torch_nerf_tpu.ops.pallas import hash_brick as jbrick
from torch_nerf_tpu_torch.ops import hash_grid

CASES = ("rays", "one_voxel", "integral")
LEVELS, LOG_T, MIN_RES, MAX_RES = 3, 10, 4, 16
WARP = 32
F_BRICK = hash_grid.BRICK_FEAT


def _res():
    return np.asarray(jngp.level_resolutions(LEVELS, MIN_RES, MAX_RES), np.float32)


def _points(case, seed):
    """n = 32k + 13 points of one case."""
    rng = np.random.default_rng(seed)
    if case == "rays":  # 10 rays of 40 sorted samples on a unit segment, cut: runs of one voxel
        o = rng.uniform(-1.5, 1.5, (10, 3))
        d = rng.normal(size=(10, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = np.sort(rng.uniform(0.0, 1.0, (10, 40)), axis=1)
        pts = (o[:, None] + t[..., None] * d[:, None]).reshape(-1, 3)[: 11 * WARP + 13]
    elif case == "one_voxel":  # every point within 1e-3 of (0.3, -0.41, 0.17)
        pts = np.array([0.3, -0.41, 0.17]) + rng.uniform(0.0, 1e-3, (4 * WARP + 13, 3))
    else:
        # groups of 8 in the voxel of a point integral on every axis (or, every
        # other group, on y and z only): the integral point heads the group,
        # or sits at its fourth place behind three points of its voxel
        groups = []
        for k in range(12):
            c = rng.integers(-3, 4, 3).astype(np.float64)
            if k % 2:
                c[0] += 0.3
            near = c + rng.uniform(1e-5, 1e-3, (7, 3))
            at = 0 if k % 4 < 2 else 3
            groups.append(np.concatenate([near[:at], c[None], near[at:]]))
        pts = np.concatenate(groups + [rng.uniform(-1.5, 1.5, (WARP + 13, 3))])
    return pts.astype(np.float32)


def _runs(keys_differ, n):
    """Run heads of the warp grouping: a window of 32 starts a run, and so
    does every lane whose key differs from the lane before; and each lane's
    run number."""
    head = (torch.arange(n) % WARP == 0) | torch.cat([torch.ones(1, dtype=torch.bool), keys_differ])
    return head, torch.cumsum(head.long(), 0) - 1


def _floor_sites(coords, resolutions):
    """(L, N, 3) the floor site inside the brick per axis, as ``brick_prep``
    takes it (v - 3 floor(v / 3))."""
    sites = []
    for axis in range(3):
        v = torch.floor(resolutions[:, None] * coords[None, :, axis])
        sites.append((v - 3.0 * torch.floor(v / 3.0)).long())
    return torch.stack(sites, dim=-1)


def grouped_brick_backward(g, coords, resolutions, num_bricks):
    """The plain emulation of kernel 5: for each level, runs of consecutive
    points on the same brick row and floor site in windows of 32; each
    run's 8 sites x F weighted cotangents summed, then one ``index_add_`` of
    every run's sums at its first point's sites. -> ``(L, T_b, 128)``."""
    num_level, f, n = resolutions.shape[0], F_BRICK, coords.shape[0]
    rows, w128 = hash_grid.brick_prep(coords, resolutions, num_bricks, f)  # (L, n), (L, n, 128)
    site = _floor_sites(coords, resolutions)  # (L, n, 3)
    shift = torch.tensor(list(itertools.product((0, 1), repeat=3)))  # (dx, dy, dz), dz fastest
    s = site[:, :, None, :] + shift  # (L, n, 8, 3)
    lanes = (((s[..., 0] * 4 + s[..., 1]) * 4 + s[..., 2]) * f)[..., None] + torch.arange(f)
    lanes = lanes.reshape(num_level, n, 8 * f)  # (dx, dy, dz, f) at ((dx*2 + dy)*2 + dz)*F + f
    w16 = torch.gather(w128, 2, lanes)
    gl = g.reshape(n, num_level, f).permute(1, 0, 2).repeat(1, 1, 8)  # element k carries g[..., k % F]
    vals = torch.where(w16 == 0.0, 0.0, gl * w16)
    key = rows * 64 + (site[..., 0] * 4 + site[..., 1]) * 4 + site[..., 2]
    dflat = torch.zeros(num_level * num_bricks * 128, dtype=torch.float32)
    for level in range(num_level):
        head, run = _runs(key[level, 1:] != key[level, :-1], n)
        sums = torch.zeros((int(head.sum()), 8 * f)).index_add_(0, run, vals[level])
        at = (level * num_bricks + rows[level, head])[:, None] * 128 + lanes[level, head]
        dflat.index_add_(0, at.reshape(-1), sums.reshape(-1))
    return dflat.reshape(num_level, num_bricks, 128)


def grouped_corner_backward(g, coords, resolutions, num_entries, feat_dim, key="rows"):
    """The plain emulation of kernel 7: for each level, runs of consecutive
    points in windows of 32 whose 8 corner rows all agree (``key="floor"``:
    whose floor voxels agree, the trap the kernel avoids); each run's 8F
    weighted cotangents summed, then one ``index_add_`` of every run's sums
    at its first point's 8 rows. -> ``(L, T, F)``."""
    num_level, f, n = resolutions.shape[0], feat_dim, coords.shape[0]
    idx, w = hash_grid.corner_prep(coords, resolutions, num_entries)  # (n, L*8) flat rows, weights
    rows = idx.reshape(n, num_level, 8).permute(1, 0, 2)  # (L, n, 8)
    w = w.reshape(n, num_level, 8, 1).permute(1, 0, 2, 3)
    gl = g.reshape(n, num_level, 1, f).permute(1, 0, 2, 3)
    vals = torch.where(w == 0.0, 0.0, gl * w).reshape(num_level, n, 8 * f)
    floor = torch.floor(resolutions[:, None, None] * coords[None])  # (L, n, 3)
    keys = rows if key == "rows" else floor
    dflat = torch.zeros((num_level * num_entries, f), dtype=torch.float32)
    for level in range(num_level):
        head, run = _runs((keys[level, 1:] != keys[level, :-1]).any(dim=-1), n)
        sums = torch.zeros((int(head.sum()), 8 * f)).index_add_(0, run, vals[level])
        dflat.index_add_(0, rows[level, head].reshape(-1), sums.reshape(-1, f))
    return dflat.reshape(num_level, num_entries, f)


def _rel_l2(got, want):
    assert got.shape == want.shape
    return ((got - want).norm() / want.norm()).item()


def _inputs(case, levels_f):
    pts = _points(case, seed=CASES.index(case))
    n = pts.shape[0]
    assert n % WARP == 13
    g = np.random.default_rng(7).normal(size=(n, levels_f)).astype(np.float32)
    return pts, g


def _check_case(case, pts, res, keys):
    """What each case must contain: runs of several points in a window;
    one voxel a level; integral points with zero weights, heading runs."""
    n = pts.shape[0]
    inside = torch.arange(1, n) % WARP != 0
    if case != "integral":
        assert bool(((keys[:, 1:] == keys[:, :-1]) & inside).any())
    if case == "one_voxel":
        assert all(len(torch.unique(k)) == 1 for k in keys)
    if case == "integral":
        floor = torch.floor(res[:, None, None] * torch.from_numpy(pts)[None])  # (L, n, 3)
        at = torch.tensor([8 * k + (0 if k % 4 < 2 else 3) for k in range(12)])
        scaled = res[:, None, None] * torch.from_numpy(pts[at])[None]
        assert bool((scaled == torch.floor(scaled)).any(dim=-1).all())  # every weight 0 on every level
        # the group's other points share the integral point's floor voxel
        group = (at // 8 * 8)[:, None] + torch.arange(8)
        assert bool((floor[:, group] == floor[:, at, None]).all())


@pytest.mark.parametrize("case", CASES)
def test_grouped_brick_backward_matches_plain_and_jax(case):
    res = _res()
    num_bricks = hash_grid.bricks_per_level(LOG_T, F_BRICK)
    pts, g = _inputs(case, LEVELS * F_BRICK)
    args = (torch.from_numpy(g), torch.from_numpy(pts), torch.from_numpy(res), num_bricks)
    got = grouped_brick_backward(*args)
    ref = hash_grid.brick_backward_reference(*args)
    cfg = jbrick.BrickCfg(feat_dim=F_BRICK, num_bricks=num_bricks, num_level=LEVELS, use_kernel=False,
                          interpret=False, tile=128)
    g128 = np.pad(g, ((0, 0), (0, 128 - LEVELS * F_BRICK)))
    jref = jax.jit(lambda a, b, c: jbrick._bwd_xla(a, b, c, cfg))(jnp.asarray(g128), jnp.asarray(pts), jnp.asarray(res))
    jref = torch.from_numpy(np.array(jref).reshape(LEVELS, num_bricks, 128))
    for want in (ref, jref):
        assert _rel_l2(got, want) <= 1e-6

    rows, _ = hash_grid.brick_prep(args[1], args[2], num_bricks, F_BRICK)
    site = _floor_sites(args[1], args[2])
    _check_case(case, pts, args[2], rows * 64 + (site[..., 0] * 4 + site[..., 1]) * 4 + site[..., 2])


CORNER_CASES = [(case, 2, 2**LOG_T) for case in CASES] + [
    ("rays", 1, 2**LOG_T), ("rays", 4, 2**LOG_T), ("rays", 8, 2**LOG_T), ("integral", 8, 2**LOG_T),
    ("rays", 2, 1000), ("integral", 2, 1000),
]


@pytest.mark.parametrize("case,feat_dim,num_entries", CORNER_CASES)
def test_grouped_corner_backward_matches_plain_and_jax(case, feat_dim, num_entries):
    res = _res()
    pts, g = _inputs(case, LEVELS * feat_dim)
    args = (torch.from_numpy(g), torch.from_numpy(pts), torch.from_numpy(res), num_entries, feat_dim)
    got = grouped_corner_backward(*args)
    ref = hash_grid.corner_backward_reference(*args)
    tables = jnp.zeros((LEVELS, num_entries, feat_dim), jnp.float32)
    jref = jax.jit(lambda t, c, r, cot: jax.vjp(lambda tt: jngp.hash_encode(tt, c, r), t)[1](cot)[0])(
        tables, jnp.asarray(pts), jnp.asarray(res), jnp.asarray(g))
    for want in (ref, torch.from_numpy(np.array(jref))):
        assert _rel_l2(got, want) <= 1e-6

    idx, _ = hash_grid.corner_prep(args[1], args[2], num_entries)
    rows = idx.reshape(-1, LEVELS, 8).permute(1, 0, 2)
    # one number a point for its 8 rows
    _check_case(case, pts, args[2], torch.stack([torch.unique(r, dim=0, return_inverse=True)[1] for r in rows]))


def test_floor_key_would_put_runs_on_an_integral_heads_rows():
    """Trap 1 of kernel 7: with runs keyed on the floor voxel alone, an
    integral point heading a run of its voxel's points puts their sums on
    its own rows (ceil-side corners on the floor's vertex); keyed on the 8
    rows, it is a run of its own."""
    res = torch.from_numpy(_res())
    pts, g = _inputs("integral", LEVELS * 2)
    args = (torch.from_numpy(g), torch.from_numpy(pts), res, 2**LOG_T, 2)
    ref = hash_grid.corner_backward_reference(*args)
    assert _rel_l2(grouped_corner_backward(*args, key="rows"), ref) <= 1e-6
    assert _rel_l2(grouped_corner_backward(*args, key="floor"), ref) > 1e-2


@pytest.mark.parametrize("layout", ("bricked", "hash"))
def test_grouping_counts_one_atomic_row_a_run(layout):
    """The emulations' run heads: a window starts a run, and so does every
    change of rows; a warp of one voxel is one run, so its rows take one
    set of atomics (kernel 5: 4 float4 or 8 float2 a run; kernel 7: 8
    F-wide, one a corner)."""
    res = torch.from_numpy(_res())
    pts = torch.from_numpy(_points("one_voxel", seed=1))
    n = pts.shape[0]
    if layout == "bricked":
        rows, _ = hash_grid.brick_prep(pts, res, hash_grid.bricks_per_level(LOG_T, F_BRICK), F_BRICK)
        site = _floor_sites(pts, res)
        differ = [k[1:] != k[:-1] for k in rows * 64 + (site[..., 0] * 4 + site[..., 1]) * 4 + site[..., 2]]
    else:
        idx, _ = hash_grid.corner_prep(pts, res, 2**LOG_T)
        rows = idx.reshape(n, LEVELS, 8).permute(1, 0, 2)
        differ = [(r[1:] != r[:-1]).any(dim=-1) for r in rows]
    for d in differ:
        head, _ = _runs(d, n)
        assert int(head.sum()) == -(-n // WARP)
