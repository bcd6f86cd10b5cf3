"""Kernels 4, 6 and 8's level-group-major walk, emulated on the CPU,
against the plain forwards and the JAX package's.

Kernels 4 (``hash_brick_fwd_kernel``, the ``bricked`` layout), 6
(``hash_corner_fwd_kernel<F>``, ``hash``) and 8 (``hash_fold_fwd_kernel<F>``,
``packed`` and ``packed_dual``) walk the levels in groups of G consecutive
(pseudo-)levels, the group varying slowest: a block of 8 warps takes one
group and a tile of P = 256 / G points; warp w takes level w % G of the
group and the window of 32 points from 32 * (w / G), lane = point; each
(point, level)'s F sums go to a tile staged in shared memory, which is
then stored to the group's G*F columns of its points. A group fills 32
output bytes of a point in kernels 4 and 6 (G = 4 at F = 2) and 64 in
kernel 8 (G = 8 at F = 2), at most 8 levels. Kernel 4 reads each of its 4
runs of two z-sites (4 floats of the brick row) as one 16-byte vector where
the floor site's z is even and as two 8-byte ones where it is odd. Kernel 6
reads its 8 corner rows as x-pairs: where T is even and F <= 2, one load of
the aligned pair of rows holding the floor-x corner's row also serves the
ceil-x corner where its row lies in the same pair.

The kernels run only on a Hopper card; :func:`tiled_forward` is a plain
emulation of that walk (blocks in grid order, warps, lanes, the staged
tile, the stores), with :func:`brick_blend` (the z-run reads),
:func:`corner_blend` (the x-pair reads) and :func:`fold_blend` as each
warp's arithmetic, held against ``brick_encode_reference`` /
``corner_encode_reference`` / ``fold_encode_reference`` and the JAX
package's jitted ``hash_brick._fwd_xla`` / ``instant_ngp.hash_encode`` /
``hash_fold._fwd_xla`` with numpy-seeded inputs: samples along rays, every
point in one voxel, and integral points; n % P != 0, L = 3 (not a multiple
of G), T_b a small power of two (brick), F in {1, 2, 4, 8} (corner, T a
power of two, even and odd) and {1, 2, 4, 8, 16} (fold, both packed
layouts). Tolerance: relative L2 1e-6 and max-abs 1e-5 (the same f32 sums,
the JAX ones perhaps in another order). One test counts that the walk
writes every (point, level) output element exactly once, another the
brick's runs read as one vector.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nerf_tpu.models import instant_ngp as jngp
from torch_nerf_tpu.ops.pallas import hash_brick as jbrick
from torch_nerf_tpu.ops.pallas import hash_fold as jfold
from torch_nerf_tpu_torch.models import hash_math, instant_ngp
from torch_nerf_tpu_torch.ops import hash_grid

WARP, THREADS = 32, 256
# hash_grid.cu's kBrickGroupBytes, kCornerGroupBytes and kFoldGroupBytes
BRICK_GROUP_BYTES, CORNER_GROUP_BYTES, FOLD_GROUP_BYTES = 32, 32, 64
X_PAIRS = ((0, 1), (2, 4), (3, 5), (6, 7))  # corners that differ only in x, in the reference's order
CASES = ("rays", "one_voxel", "integral")
LEVELS, LOG_T, MIN_RES, MAX_RES = 3, 10, 4, 16
N = 2 * THREADS + 13  # n % P = 13 for every tile size P


def group_levels(feat_dim, group_bytes):
    """``FwdTile::kLevels``: G*F floats fill ``group_bytes``, 1 <= G <= 8."""
    return min(8, max(1, group_bytes // (4 * feat_dim)))


def tiled_forward(blend, n, levels, feat_dim, group_bytes):
    """The kernels' walk over ``n`` points and ``levels`` levels:
    ``blend(level, points) -> (m, F)`` is one warp's arithmetic for its
    lanes' points. -> ``(out (n, L*F), writes (n, L*F))``: the stored
    features (NaN where nothing was stored) and how many stores each
    element took."""
    g = group_levels(feat_dim, group_bytes)
    tile = THREADS // g
    tiles = -(-n // tile)
    out = torch.full((n, levels * feat_dim), math.nan)
    writes = torch.zeros((n, levels * feat_dim), dtype=torch.int64)
    lanes = torch.arange(WARP)
    for block in range(-(-levels // g) * tiles):  # blockIdx order: the group slowest
        l0, p0 = block // tiles * g, block % tiles * tile
        staged = torch.full((tile, g * feat_dim), math.nan)
        for warp in range(THREADS // WARP):
            j, window = warp % g, warp // g * WARP
            points = p0 + window + lanes
            valid = points < n
            if l0 + j < levels and bool(valid.any()):
                staged[window + lanes[valid], j * feat_dim:(j + 1) * feat_dim] = blend(l0 + j, points[valid])
        cols = min(g, levels - l0) * feat_dim
        m = min(tile, n - p0)
        out[p0:p0 + m, l0 * feat_dim:l0 * feat_dim + cols] = staged[:m, :cols]
        writes[p0:p0 + m, l0 * feat_dim:l0 * feat_dim + cols] += 1
    return out, writes


def brick_sites(coords, resolution):
    """The kernel's ``brick_of`` for one level: ``(site (m, 3) int64, the
    floor site in its brick per axis; w (m, 3, 2) f32, span - frac at the
    floor site and frac at the ceil site)``."""
    scaled = coords * resolution
    v = torch.floor(scaled)
    span = torch.ceil(scaled) - v
    frac = scaled - v
    site = (v - hash_grid.STRIDE * torch.floor(v / float(hash_grid.STRIDE))).long()
    return site, torch.stack([span - frac, frac], dim=-1)


def brick_blend(tables, coords, resolutions, counts=None):
    """Kernel 4's arithmetic for one warp: ``brick_prep``'s row, the floor
    site, and each (dx, dy)'s run of two z-sites (4 consecutive floats)
    read as one 16-byte vector where the floor site's z is even and as two
    8-byte ones where it is odd, blended in the kernel's order. ``counts``
    tallies the runs and the runs read as one vector."""
    num_level, t_b, _ = tables.shape
    f, e = hash_grid.BRICK_FEAT, hash_grid.BRICK_EDGE
    flat = tables.reshape(-1)
    quads, pairs = flat.reshape(-1, 4), flat.reshape(-1, 2)

    def blend(level, points):
        idx, _ = hash_grid.brick_prep(coords[points], resolutions[level:level + 1], t_b, f)
        row = (idx[0] + level * t_b) * hash_grid.LANES
        site, w = brick_sites(coords[points], resolutions[level])
        even = site[:, 2] % 2 == 0
        acc = torch.zeros((points.shape[0], f))
        for dx in range(2):
            for dy in range(2):
                wxy = w[:, 0, dx] * w[:, 1, dy]
                at = row + (((site[:, 0] + dx) * e + site[:, 1] + dy) * e + site[:, 2]) * f
                # the run lies in one 32-byte sector; 16-byte aligned exactly where z is even
                assert bool((at % 8 <= 4).all()) and torch.equal(at % 4 == 0, even)
                odd = torch.cat([pairs[at // 2], pairs[at // 2 + 1]], dim=1)
                run = torch.where(even[:, None], quads[at // 4], odd)  # (m, 4): (z, f) at 2z + f
                w0, w1 = wxy * w[:, 2, 0], wxy * w[:, 2, 1]
                acc = acc + (run[:, :f] * w0[:, None] + run[:, f:] * w1[:, None])
        if counts is not None:
            counts["runs"] += 4 * points.shape[0]
            counts["vector"] += 4 * int(even.sum())
        return acc

    return blend


def corner_blend(tables, coords, resolutions, counts=None):
    """Kernel 6's arithmetic for one warp: the 8 corners' rows and weights
    (``corner_prep``), the rows read as x-pairs where T is even and F <= 2,
    the corners summed in the reference's order. ``counts`` tallies the
    ceil-x corners served by their pair's load."""
    num_level, num_entries, f = tables.shape
    flat = tables.reshape(num_level * num_entries, f)
    pairs = flat.reshape(-1, 2 * f) if num_entries % 2 == 0 and f <= 2 else None

    def blend(level, points):
        rows, w = hash_grid.corner_prep(coords[points], resolutions[level:level + 1], num_entries)
        rows = rows + level * num_entries
        v = [None] * 8
        for c0, c1 in X_PAIRS:
            if pairs is None:
                v[c0], v[c1] = flat[rows[:, c0]], flat[rows[:, c1]]
                continue
            two = pairs[rows[:, c0] >> 1]

            def half(r):
                return torch.where((r & 1).bool()[:, None], two[:, f:], two[:, :f])

            same = (rows[:, c1] >> 1) == (rows[:, c0] >> 1)
            v[c0] = half(rows[:, c0])
            v[c1] = torch.where(same[:, None], half(rows[:, c1]), flat[rows[:, c1]])
            if counts is not None:
                counts["paired"] += int(same.sum())
        acc = torch.zeros((points.shape[0], f))
        for c in range(8):
            acc = acc + v[c] * w[:, c:c + 1]
        return acc

    return blend


def fold_blend(tables, coords, resolutions, offsets, feat_dim):
    """Kernel 8's arithmetic for one warp: one packed row a lane, its 8F
    floats summed in row order into feature e % F with corner e / F's
    weight."""
    f = feat_dim
    rows = hash_grid.check_fold_layout(tables.shape, f)
    flat = tables.reshape(-1, 8 * f)

    def blend(level, points):
        row, w = hash_math.packed_prep(coords[points], resolutions[level:level + 1], rows,
                                       offsets[level:level + 1])
        r = flat[row[0] + level * rows]  # (m, 8F)
        acc = torch.zeros((points.shape[0], f))
        for e in range(8 * f):
            acc[:, e % f] += r[:, e] * w[0, :, e // f]
        return acc

    return blend


def _points(case, seed, n=N):
    """``n`` points of one case."""
    rng = np.random.default_rng(seed)
    if case == "rays":  # 14 rays of 40 sorted samples on a unit segment: runs of one voxel a level
        o = rng.uniform(-1.5, 1.5, (14, 3))
        d = rng.normal(size=(14, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = np.sort(rng.uniform(0.0, 1.0, (14, 40)), axis=1)
        pts = (o[:, None] + t[..., None] * d[:, None]).reshape(-1, 3)[:n]
    elif case == "one_voxel":  # every point within 1e-3 of (0.3, -0.41, 0.17)
        pts = np.array([0.3, -0.41, 0.17]) + rng.uniform(0.0, 1e-3, (n, 3))
    else:  # integral on every axis (the first 64), on y and z only (the next 64), and between
        integral = rng.integers(-3, 4, (4 * WARP, 3)).astype(np.float64)
        integral[2 * WARP:, 0] += 0.3
        pts = np.concatenate([integral, rng.uniform(-1.5, 1.5, (n - 4 * WARP, 3))])
    assert pts.shape == (n, 3)
    return pts.astype(np.float32)


def _resolutions():
    return np.asarray(jngp.level_resolutions(LEVELS, MIN_RES, MAX_RES), np.float32)


def _check(got, wants):
    for want in wants:
        assert got.shape == want.shape
        assert not torch.isnan(got).any()
        assert ((got - want).norm() / want.norm()).item() <= 1e-6
        assert (got - want).abs().max().item() <= 1e-5


def _check_case(case, out, feat_dim):
    """Integral points (on every axis, or on y and z only) have all-zero
    features on every base level; the points between them do not."""
    if case == "integral":
        assert out[:4 * WARP, :LEVELS * feat_dim].abs().max().item() == 0.0
        assert out[4 * WARP:].abs().max(dim=1).values.min().item() > 0.0


BRICK_CASES = [(case, levels, 64) for case in CASES for levels in (3, 8)] + [("rays", 8, 512)]


def _brick_args(case, levels, t_b):
    """numpy-seeded ``(tables (L, T_b, 128), points, resolutions)``."""
    res = np.asarray(jngp.level_resolutions(levels, MIN_RES, MAX_RES), np.float32)
    tables = np.random.default_rng(17 + levels).uniform(-1.0, 1.0, (levels, t_b, 128)).astype(np.float32)
    return tables, _points(case, seed=CASES.index(case)), res


@pytest.mark.parametrize("case,levels,t_b", BRICK_CASES)
def test_tiled_brick_forward_matches_plain_and_jax(case, levels, t_b):
    tables, pts, res = _brick_args(case, levels, t_b)
    args = (torch.from_numpy(tables), torch.from_numpy(pts), torch.from_numpy(res))
    f = hash_grid.BRICK_FEAT
    got, writes = tiled_forward(brick_blend(*args), N, levels, f, BRICK_GROUP_BYTES)
    assert bool((writes == 1).all())
    ref = hash_grid.brick_encode_reference(*args)
    cfg = jbrick.BrickCfg(feat_dim=f, num_bricks=t_b, num_level=levels, use_kernel=False, interpret=False,
                          tile=128)
    jref = jax.jit(lambda t, c, r: jbrick._fwd_xla(t.reshape(levels * t_b, 128), c, r, cfg))(
        jnp.asarray(tables), jnp.asarray(pts), jnp.asarray(res))
    _check(got, (ref, torch.from_numpy(np.array(jref)[:, :levels * f])))
    _check_case(case, got, f)


@pytest.mark.parametrize("case", CASES)
def test_brick_reads_even_z_runs_as_one_vector(case):
    """Kernel 4 reads a run as one vector exactly where the floor site's z
    (floor(res * z) mod 3, counted here in numpy) is even, and as two where
    it is odd; every case takes both forms, and a (point, level) takes fewer
    than the 8 loads of two per run."""
    levels, t_b = 8, 64
    tables, pts, res = _brick_args(case, levels, t_b)
    counts = {"runs": 0, "vector": 0}
    blend = brick_blend(torch.from_numpy(tables), torch.from_numpy(pts), torch.from_numpy(res), counts)
    tiled_forward(blend, N, levels, hash_grid.BRICK_FEAT, BRICK_GROUP_BYTES)
    z = np.floor(res[:, None] * pts[None, :, 2])
    even = int(((z - 3 * np.floor(z / 3)) % 2 == 0).sum())
    assert counts == {"runs": 4 * levels * N, "vector": 4 * even}
    loads = 2 * counts["runs"] - counts["vector"]
    assert 4 * levels * N < loads < 8 * levels * N


CORNER_CASES = [(case, f, 2**LOG_T) for case in CASES for f in hash_grid.CORNER_FEATS] + [
    ("rays", 2, 1000), ("rays", 2, 999), ("rays", 1, 999), ("integral", 2, 999), ("one_voxel", 8, 1000),
]


@pytest.mark.parametrize("case,feat_dim,num_entries", CORNER_CASES)
def test_tiled_corner_forward_matches_plain_and_jax(case, feat_dim, num_entries):
    res = _resolutions()
    pts = _points(case, seed=CASES.index(case))
    tables = np.random.default_rng(11 + feat_dim).uniform(-1.0, 1.0, (LEVELS, num_entries, feat_dim)).astype(
        np.float32)
    args = (torch.from_numpy(tables), torch.from_numpy(pts), torch.from_numpy(res))
    counts = {"paired": 0}
    got, writes = tiled_forward(corner_blend(*args, counts=counts), N, LEVELS, feat_dim, CORNER_GROUP_BYTES)
    assert bool((writes == 1).all())
    ref = hash_grid.corner_encode_reference(*args)
    jref = jax.jit(jngp.hash_encode)(jnp.asarray(tables), jnp.asarray(pts), jnp.asarray(res))
    _check(got, (ref, torch.from_numpy(np.array(jref))))
    _check_case(case, got, feat_dim)
    # the x-pair reads took place where they may: T even and F <= 2
    assert (counts["paired"] > 0) == (num_entries % 2 == 0 and feat_dim <= 2)


def _fold_grid(layout, levels=LEVELS, min_res=MIN_RES, max_res=MAX_RES):
    res = jngp.level_resolutions(levels, min_res, max_res)
    if layout == "packed_dual":
        r, o = jngp.dual_resolutions_offsets(jnp.asarray(res))
        return np.array(r, np.float32), np.array(o, np.float32)
    return np.asarray(res, np.float32), np.zeros(levels, np.float32)


@pytest.mark.parametrize("layout", ("packed", "packed_dual"))
@pytest.mark.parametrize("feat_dim", hash_grid.FOLD_FEATS)
@pytest.mark.parametrize("case", CASES)
def test_tiled_fold_forward_matches_plain_and_jax(case, feat_dim, layout):
    r, o = _fold_grid(layout)
    levels = r.shape[0]
    rows = 2**LOG_T // 8
    lines = rows // hash_grid.fold_factor(feat_dim)
    pts = _points(case, seed=CASES.index(case))
    tables = np.random.default_rng(13 + feat_dim).uniform(-1.0, 1.0, (levels, lines, 128)).astype(np.float32)
    args = (torch.from_numpy(tables), torch.from_numpy(pts), torch.from_numpy(r), torch.from_numpy(o))
    got, writes = tiled_forward(fold_blend(*args, feat_dim), N, levels, feat_dim, FOLD_GROUP_BYTES)
    assert bool((writes == 1).all())
    ref = hash_grid.fold_encode_reference(*args, feat_dim)
    cfg = jfold.FoldCfg(feat_dim=feat_dim, num_rows=rows, num_level=levels, use_kernel=False, interpret=False,
                        tile=128)
    jref = jax.jit(lambda t, c, rr, oo: jfold._fwd_xla(t.reshape(levels * lines, 128), c, rr, oo, cfg))(
        jnp.asarray(tables), jnp.asarray(pts), jnp.asarray(r), jnp.asarray(o))
    _check(got, (ref, torch.from_numpy(np.array(jref)[:, :levels * feat_dim])))
    _check_case(case, got, feat_dim)


@pytest.mark.parametrize("kernel,feat_dim", [("brick", hash_grid.BRICK_FEAT)]
                         + [("corner", f) for f in hash_grid.CORNER_FEATS]
                         + [("fold", f) for f in hash_grid.FOLD_FEATS])
def test_walk_writes_every_element_once(kernel, feat_dim):
    """Every (point, level) output element is stored exactly once, for a
    single point, a ragged window and a ragged tile, at 3 levels (a
    partial last group), the presets' 16 and ``packed_dual``'s 32."""
    group_bytes = {"brick": BRICK_GROUP_BYTES, "corner": CORNER_GROUP_BYTES, "fold": FOLD_GROUP_BYTES}[kernel]
    seen = []

    def blend(level, points):
        seen.append((level, points))
        return torch.zeros((points.shape[0], feat_dim))

    for n in (1, 33, 4099):
        for levels in (3, 16, 32):
            seen.clear()
            out, writes = tiled_forward(blend, n, levels, feat_dim, group_bytes)
            assert bool((writes == 1).all()) and not torch.isnan(out).any()
            # every (point, level) blended once, by a warp of one level
            pairs = torch.cat([level * n + points for level, points in seen])
            assert torch.equal(torch.sort(pairs).values, torch.arange(levels * n))


def test_forward_kernels_match_plain_version_on_the_card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA card of compute capability 9.0 (Hopper); the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd = (hash_grid.hash_brick_fwd, hash_grid.hash_corner_fwd, hash_grid.hash_fold_fwd)
    for levels in (3, 16):
        base = torch.as_tensor(hash_math.level_resolutions(levels, 16, 512), device=dev)
        for n in (1, 33, 4099):
            pts = torch.rand((n, 3), generator=gen, device=dev) * 3 - 1.5
            pts[-1] = torch.tensor([0.25, -0.5, 1.0], device=dev)
            cases = [(hash_grid.hash_corner_fwd, (torch.rand((levels, t, f), generator=gen, device=dev) * 2 - 1,
                                                  pts, base), hash_grid.corner_encode_reference, ())
                     for f in hash_grid.CORNER_FEATS for t in (2**16, 1000, 999)]
            cases += [(hash_grid.hash_brick_fwd, (torch.rand((levels, t_b, 128), generator=gen, device=dev) * 2 - 1,
                                                  pts, base), hash_grid.brick_encode_reference, ())
                      for t_b in (512, 8192)]
            for f in hash_grid.FOLD_FEATS:
                for res, off in ((base, torch.zeros_like(base)), instant_ngp.dual_resolutions_offsets(base)):
                    tables = torch.rand((res.shape[0], 2**13 // hash_grid.fold_factor(f), 128), generator=gen,
                                        device=dev) * 2 - 1
                    cases.append((hash_grid.hash_fold_fwd, (tables, pts, res, off), hash_grid.fold_encode_reference,
                                  (f,)))
            for kernel, args, plain, extra in cases:
                before = [k.launches for k in fwd]
                out = kernel(*args, *extra)
                torch.cuda.synchronize()
                assert [k.launches for k in fwd] == [b + (k is kernel) for b, k in zip(before, fwd)]
                ref = plain(*args, *extra)
                assert (out - ref).abs().max().item() <= 1e-5
                assert ((out - ref).norm() / ref.norm()).item() <= 1e-5
                f = out.shape[1] // args[2].shape[0]
                assert out[-1, :levels * f].abs().max().item() == 0.0  # integral: the base levels vanish
