"""The general route's dW GEMM on the tensor cores (``csrc/nerf_dw_tc.cuh``).

The kernel runs only on a Hopper card; here the Python side of its
contract is held on the CPU:

- the Python twin of its plan (``fused_nerf.dw_tc_plan``) for every config
  of the route table: the 128 x N tiles cover each layer's grad once and
  each db column once, the slices cover the points in order, the launch
  order is slice-major, a CTA's shared memory fits 227 KB, the slices go
  in windows of at most 8 waves of CTAs, the workspace is one partial a
  (tile, slice of a window) in each of two buffers; and the jobs, slices,
  windows and bytes of a few configs worked out by hand;
- a torch emulation of the kernel over the stashes of ``forward_activations``
  and the chain: 64-point x 64-column boxes with zeros past m and past each
  stash's width, the tiles over the slices in launch order, f32 sums a
  slice, the fixed-order reduce, the grads mapped back by
  ``grads_from_general``; held against the JAX package's kernel-2 grads
  (``fused_nerf_apply``'s backward, its Pallas kernel in interpret mode) at bf16
  width 96 / level 12 and f32 width 64;
- a numpy emulation of the f32 scheme on one layer's stash: three bf16
  pieces, 8 products a 32-point half-stage, the tensor core's truncating
  accumulation (each k16 step's exact sum added with a rounding toward
  zero), a fresh accumulator each half-stage folded by a rounding f32
  add: within the f32 limit, and one accumulator over the slice outside
  it.

Inputs come from seeded numpy generators. Tolerances: the emulation
against the exact sums of the same stash 1e-6 (f32 sums of a slice in
another order); against JAX, each grad leaf by relative L2: f32 1e-5 (both
f32, summed in another order), bf16 JAX's own distance from the f32 grads + 1e-3 (the
two forwards and chains round to bf16 in other places: each reads ~6%
from the other and ~12% from f32 here). The f32 limit is ``chip_smoke.py``'s: relative L2 within 2x
the plain f32 product's + 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nerf_tpu.ops.pallas import fused_nerf as jfused
from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES, init_nerf_params, params_from_jax
from torch_nerf_tpu_torch.ops import fused_nerf

SMEM_LIMIT = 232_448
POINTS = 1100  # two slices, the second ending 12 points into a stage

# the route table's configs (fused_nerf.forward_route): (feat, level, dtype)
ROUTE_CONFIGS = ([(f, lv, torch.bfloat16) for f in (64, 128, 256, 384, 512) for lv in (10, 12)]
                 + [(f, 10, torch.bfloat16) for f in (96, 160, 576, 1024)]
                 + [(f, 10, torch.float32) for f in (64, 96, 256, 320, 1000)] + [(256, 20, torch.float32)])


def _cfg(feat, level, dtype, dir_level=4):
    return fused_nerf.FusedNeRFConfig(coord_encode_level=level, dir_encode_level=dir_level, feat_dim=feat,
                                      compute_dtype=dtype)


# ---------------------------------------------------------------------------
# the plan


@pytest.mark.parametrize("feat,level,dtype", ROUTE_CONFIGS)
@pytest.mark.parametrize("points", [786_432, 65_573, POINTS, 1])
def test_plan_covers_every_grad_once(feat, level, dtype, points):
    cfg = _cfg(feat, level, dtype)
    plan = fused_nerf.dw_tc_plan(cfg, points)
    acts, dzs = fused_nerf.stash_widths(cfg)
    widths = (256, 128, 64) if dtype == torch.bfloat16 else (128, 64)
    for layer, (segs, nwidth) in enumerate(zip(fused_nerf.DW_SEGMENTS, dzs)):
        rows = sum(acts[s] for s in segs)
        covered = np.zeros((rows, nwidth), np.int64)
        db = np.zeros(nwidth, np.int64)
        for job in plan.jobs:
            if job.layer != layer:
                continue
            assert job.n in widths and job.col0 % 64 == 0
            assert job.width == acts[segs[job.seg]]
            r0 = job.row_off + 128 * job.kb
            covered[r0:min(r0 + 128, job.row_off + job.width), job.col0:job.col0 + job.n] += 1
            if job.kbi == 0:
                db[job.col0:job.col0 + job.n] += 1
        assert (covered == 1).all() and (db == 1).all(), (layer, covered.min(), covered.max())
    # the slices: [0, m) in order, 64-point stages; the launch order slice-major
    slices = plan.slices()
    assert slices[0][0] == 0 and slices[-1][1] == max(points, 1) and plan.chunk % 64 == 0
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:])) and all(e > b for b, e in slices)
    order = plan.order()
    assert order[:len(plan.jobs)] == [(0, j) for j in range(len(plan.jobs))]
    assert order == sorted(order) and len(order) == plan.splits * len(plan.jobs)
    assert plan.smem_bytes <= SMEM_LIMIT
    # windows of at most 8 waves of CTAs over 132 SMs, the last one possibly short
    assert plan.window * plan.windows >= plan.splits > plan.window * (plan.windows - 1)
    assert len(plan.jobs) * plan.window <= max(len(plan.jobs), 8 * 132)
    maxn = widths[0]
    part = 4 * (128 * maxn + maxn)
    buffers = min(plan.windows, 2)
    assert plan.workspace_bytes == -(-buffers * len(plan.jobs) * plan.window * part // 256) * 256
    assert plan.workspace_bytes <= 16 * 132 * part  # 279 MB bf16, 139 MB f32, whatever the point count


# (feat, level, dtype, points) -> (tiles, slices, points a slice, shared memory a CTA, slices a
# launch, launches), by hand:
# bf16 512 / 12: pe 75 -> 80, de 27 -> 32, dz widths 512 (2 tiles of 256),
# fc_8's 528 (256, 256, 64), fc_9's 256, fc_out's 16 (one of 64): fc_in 2,
# fc_1-4 4 x 8, fc_5 (1 + 4) x 2, fc_6-7 2 x 8, fc_8 4 x 3, fc_9 (4 + 1), fc_out 2
# = 79; f32 256 / 10 (tiles at most 128 wide): 2 + 16 + 6 + 8 + 6 + 3 + 1 = 42;
# f32 64 / 10: 1 + 4 + 2 + 2 + 1 + 2 + 1 = 13. Slices of 4096 points, at
# least cdiv(2 x 132, tiles) of at least 1024; shared memory bf16 4 x 48 KB
# + 1024 + 64, f32 2 x 64 KB + 96 KB of pieces + 1024 + 32. Windows:
# cdiv(slices, 8 x 132 // tiles) launches, the slices shared out evenly:
# 79 tiles take 13 -> 15 launches of 13 (the last of 10), 17 slices 2 of
# 9; 42 take 25 -> 8 of 24; bf16 1024 / 10 has 4 + 4 x 32 + 9 x 4 + 2 x 32
# + 8 x 5 + 9 x 2 + 4 = 294 tiles, 3 -> 64 launches of 3.
@pytest.mark.parametrize("feat,level,dtype,points,want", [
    (512, 12, torch.bfloat16, 786_432, (79, 192, 4096, 197_696, 13, 15)),
    (512, 12, torch.bfloat16, 65_573, (79, 17, 3904, 197_696, 9, 2)),
    (1024, 10, torch.bfloat16, 786_432, (294, 192, 4096, 197_696, 3, 64)),
    (256, 10, torch.float32, 786_432, (42, 192, 4096, 230_432, 24, 8)),
    (64, 10, torch.float32, POINTS, (13, 2, 576, 230_432, 2, 1)),
    (64, 10, torch.float32, 20_000, (13, 20, 1024, 230_432, 20, 1)),
])
def test_plan_by_hand(feat, level, dtype, points, want):
    plan = fused_nerf.dw_tc_plan(_cfg(feat, level, dtype), points)
    assert (len(plan.jobs), plan.splits, plan.chunk, plan.smem_bytes, plan.window, plan.windows) == want


@pytest.mark.parametrize("feat,level,dtype,points", [(96, 12, torch.bfloat16, 100), (64, 10, torch.float32, 130)])
def test_stash_views_lay_the_stashes_out_as_the_kernels_do(feat, level, dtype, points):
    """``stash_views`` of a workspace: carve_stash's order and 256-byte
    alignment (m rounded up to 64 rows), no two views overlapping, all
    within ``stash_nbytes``; ``general_check.dw_plain`` over them is each
    layer's A^T dZ and db."""
    from torch_nerf_tpu_torch.runners import general_check

    cfg = _cfg(feat, level, dtype)
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = fused_nerf.stash_nbytes(points, cfg)
    workspace = torch.zeros(nbytes, dtype=torch.uint8)
    acts, dzs = fused_nerf.stash_views(workspace, points, cfg)
    views = list(acts.values()) + dzs
    offsets = [v.data_ptr() - workspace.data_ptr() for v in views]
    widths = list(fused_nerf.stash_widths(cfg)[0].values()) + fused_nerf.stash_widths(cfg)[1]
    mp = -(-points // 64) * 64
    assert [v.shape for v in views] == [(points, w) for w in widths]
    assert offsets == sorted(offsets) and all(o % 256 == 0 for o in offsets)
    assert all(b - a >= mp * w * size for a, b, w in zip(offsets, offsets[1:] + [nbytes], widths))
    gen = torch.Generator().manual_seed(4)
    for v in views:
        v.copy_(torch.randn(v.shape, generator=gen))
    layers = general_check.dw_layers(cfg, workspace, points)
    for (segs, z), (w, b), names in zip(layers, general_check.dw_plain(layers, torch.float64), fused_nerf.DW_SEGMENTS):
        a = torch.cat([acts[n] for n in names], dim=1).double()
        assert torch.equal(w, a.t() @ z.double()) and torch.equal(b, z.double().sum(0))


# ---------------------------------------------------------------------------
# the kernel emulated over the stashes, against JAX's kernel 2


def _stash(params, pts, dirs, g_sigma, g_rgb, cfg):
    """The general route's stashes as the kernels write them, in the
    compute type: ``({activation: (m, width)}, [each layer's dz (m,
    width)])`` (``fused_nerf.stash_widths``), from ``forward_activations``
    and the chain of ``backward_from_activations`` (fc_8's dz as
    [features, sigma, zeros])."""
    dt, f = cfg.compute_dtype, cfg.feat_dim
    acts_w, dz_w = fused_nerf.stash_widths(cfg)
    a = fused_nerf.forward_activations(params, pts, dirs, cfg)

    def pad(x, width):
        return torch.nn.functional.pad(x, (0, width - x.shape[1]))

    def wt(name):
        return params[name]["w"].to(dt).t()

    names = ["pe", "de"] + [f"h{i}" for i in range(8)] + ["features", "h9"]
    values = [a["pe"], a["de"]] + [a[n] for n in LAYER_NAMES[:8]] + [a["z8"][:, 1:], a["fc_9"]]
    acts = {n: pad(v, acts_w[n]) for n, v in zip(names, values)}
    zero = torch.zeros((), dtype=dt)
    dz = [None] * 11
    rgb = a["rgb"]
    dz[10] = (g_rgb * rgb * (1.0 - rgb)).to(dt)
    dz[9] = torch.where(a["fc_9"] > 0, dz[10] @ wt("fc_out"), zero)
    dcat9 = dz[9] @ wt("fc_9")
    dsig = torch.where(a["z8"][:, 0].float() > 0, g_sigma, 0.0).to(dt)
    dz8 = torch.cat([dsig[:, None], dcat9[:, :f]], dim=-1)  # the public order, for the chain
    dz[8] = torch.cat([dcat9[:, :f], dsig[:, None]], dim=-1)
    dh = dz8 @ wt("fc_8")
    for l in range(7, -1, -1):
        dz[l] = torch.where(a[LAYER_NAMES[l]] > 0, dh, zero)
        if l:
            dh = dz[l] @ wt(LAYER_NAMES[l])
            if l == 5:
                dh = dh[:, cfg.pos_enc_dim:]
    return acts, [pad(z, w) for z, w in zip(dz, dz_w)]


def _box(x, p0, col0, rows, cols):
    """Rows [p0, p0 + rows) x columns [col0, col0 + cols) of a stash as TMA
    loads them: zeros past its rows and its columns."""
    out = torch.zeros((rows, cols), dtype=x.dtype)
    part = x[p0:p0 + rows, col0:col0 + cols]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def _emulate_dw(acts, dzs, plan, cfg):
    """The kernel's tiles over the slices in launch order (64-point stages,
    f32 sums a slice; db point by point in order), then each tile's
    partials summed in slice order (a window's reduce goes on from the
    last one's sum: one sum over all the slices) -> kernel-layout
    ``(grads_w, grads_b)``."""
    shapes = fused_nerf.general_grad_shapes(cfg)
    gw = [torch.zeros(s, dtype=torch.float32) for s in shapes]
    gb = [torch.zeros((s[1],), dtype=torch.float32) for s in shapes]
    parts = {}
    for s, j in plan.order():
        job = plan.jobs[j]
        begin, end = plan.slices()[s]
        a_stash = acts[fused_nerf.DW_SEGMENTS[job.layer][job.seg]]
        z_stash = dzs[job.layer]
        acc = torch.zeros((128, job.n), dtype=torch.float32)
        db = torch.zeros((job.n,), dtype=torch.float32)
        for p0 in range(begin, end, 64):
            a = _box(a_stash[:end], p0, 128 * job.kb, 64, 128).float()
            z = _box(z_stash[:end], p0, job.col0, 64, job.n).float()
            acc += a.t() @ z
            for row in z:
                db += row
        parts[j, s] = (acc, db)
    for j, job in enumerate(plan.jobs):
        acc, db = parts[j, 0]
        for s in range(1, plan.splits):
            acc = acc + parts[j, s][0]
            db = db + parts[j, s][1]
        rows = min(128, job.width - 128 * job.kb)
        cols = min(job.n, shapes[job.layer][1] - job.col0)
        r0 = job.row_off + 128 * job.kb
        gw[job.layer][r0:r0 + rows, job.col0:job.col0 + cols] = acc[:rows, :cols]
        if job.kbi == 0:
            gb[job.layer][job.col0:job.col0 + cols] = db[:cols]
    return gw, gb


def _he_params(cfg, seed):
    """Seeded port-init weights with the He gain (every layer matters)."""
    params = init_nerf_params(torch.Generator().manual_seed(seed), cfg.pos_enc_dim, cfg.dir_enc_dim, cfg.feat_dim)
    return {n: {"w": v["w"] * 6**0.5, "b": v["b"]} for n, v in params.items()}


def _jax_case(feat, level, dtype, seed):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jcfg = jfused.FusedNeRFConfig(coord_encode_level=level, dir_encode_level=4, feat_dim=feat, tile=64,
                                  compute_dtype=jdt, interpret=True)
    rng = np.random.default_rng(seed)
    # He-uniform weights and small biases, from numpy, in JAX's tree
    shapes = {n: v["w"].shape for n, v in _he_params(_cfg(feat, level, dtype), 0).items()}
    jparams = {n: {"w": rng.uniform(-1, 1, size=s).astype(np.float32) * np.float32((6 / s[0]) ** 0.5),
                   "b": rng.uniform(-0.1, 0.1, size=s[1:]).astype(np.float32)} for n, s in shapes.items()}
    pts = rng.uniform(-2, 2, size=(POINTS, 3)).astype(np.float32)
    dirs = rng.normal(size=(POINTS, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g_sigma = rng.normal(size=(POINTS,)).astype(np.float32)
    g_rgb = rng.normal(size=(POINTS, 3)).astype(np.float32)
    # kernel 2 alone: the backward of fused_nerf_apply's custom VJP
    jgrads, _, _ = jfused._fused_bwd(jcfg, (jparams, jnp.asarray(pts), jnp.asarray(dirs)),
                                     (jnp.asarray(g_sigma), jnp.asarray(g_rgb)))
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    return params_from_jax(jparams), [torch.from_numpy(x) for x in (pts, dirs, g_sigma, g_rgb)], jgrads


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("feat,level,dtype", [(96, 12, torch.bfloat16), (64, 10, torch.float32)])
def test_emulated_dw_matches_jax_kernel_grads(feat, level, dtype):
    cfg = _cfg(feat, level, dtype)
    params, inputs, jgrads = _jax_case(feat, level, dtype, seed=feat + level)
    tol = {}
    if dtype == torch.bfloat16:
        # within JAX's own bf16 distance from the f32 grads (of the same
        # bf16-rounded weights) + 1e-3: the two bf16 versions round in other
        # places, each ~2x closer to the other than to f32
        rounded = {n: {k: v.to(dtype).float() for k, v in p.items()} for n, p in params.items()}
        f32, _, _ = fused_nerf.fused_nerf_bwd_reference(rounded, *inputs, _cfg(feat, level, torch.float32))
        tol = {(n, k): _rel(jgrads[n][k], f32[n][k].numpy()) + 1e-3 for n in LAYER_NAMES for k in ("w", "b")}
    acts, dzs = _stash(params, *inputs, cfg)
    plan = fused_nerf.dw_tc_plan(cfg, POINTS)
    assert plan.splits == 2 and POINTS % 64  # two slices and a ragged last stage
    gw, gb = _emulate_dw(acts, dzs, plan, cfg)
    # the same sums exactly (f64) over the same stashes
    for layer, (segs, z) in enumerate(zip(fused_nerf.DW_SEGMENTS, dzs)):
        a = torch.cat([acts[s] for s in segs], dim=1).double()
        assert _rel(gw[layer], a.t() @ z.double()) < 1e-6, layer
        assert _rel(gb[layer], z.double().sum(0)) < 1e-6, layer
    grads = fused_nerf.grads_from_general(gw, gb, cfg)
    for name in LAYER_NAMES:
        for leaf in ("w", "b"):
            got, want = grads[name][leaf].numpy(), jgrads[name][leaf]
            assert got.shape == np.shape(want), f"{name}.{leaf}"
            assert _rel(got, want) < tol.get((name, leaf), 1e-5), f"{name}.{leaf}: {_rel(got, want)}"


# ---------------------------------------------------------------------------
# the f32 scheme emulated: three pieces, 8 products, the truncating accumulator


def _round_toward_zero(x):
    """f64 -> the f32 next to it toward zero."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(y, np.float32(0)), y)


def _pieces(x):
    return [p.double().numpy() for p in fused_nerf.bf16_pieces(torch.from_numpy(x))]


# the products x_i z_j (i + j <= 3) in the kernel's order, the smallest first
ORDER = ((1, 2), (2, 1), (0, 2), (2, 0), (1, 1), (0, 1), (1, 0), (0, 0))


def _f32_scheme(a, z, fold=True, dropped=()):
    """A^T Z of f32 ``a`` (K, M), ``z`` (K, N) as the kernel's f32 route sums
    it: each 64-point stage in two 32-point halves, each half's 8 piece
    products k16 step by k16 step, each step's exact sum added to the
    accumulator with a rounding toward zero; with ``fold`` a fresh
    accumulator each half, added to the f32 sum by a rounding add, else
    one accumulator over all of K. ``dropped``: pieces left out of both
    operands (a planted fault)."""
    pa, pz = _pieces(a), _pieces(z)
    for i in dropped:
        pa[i], pz[i] = 0 * pa[i], 0 * pz[i]
    total = np.zeros((a.shape[1], z.shape[1]), np.float32)
    acc = np.zeros_like(total)
    for p0 in range(0, a.shape[0], 32):
        if fold:
            acc = np.zeros_like(total)
        for i, j in ORDER:
            for k in (p0, p0 + 16):
                acc = _round_toward_zero(acc.astype(np.float64) + pa[i][k:k + 16].T @ pz[j][k:k + 16])
        if fold:
            total = (total + acc).astype(np.float32)
    return total if fold else acc


@pytest.fixture(scope="module")
def f32_layer():
    """One layer's f32 stash slice at width 64: relu activations (a
    forward's h3) and its dz with the He gain, 4096 points (128 halves);
    the exact product and the plain f32 one's error."""
    cfg = _cfg(64, 10, torch.float32)
    rng = np.random.default_rng(3)
    params = _he_params(cfg, int(rng.integers(1 << 30)))
    pts = torch.from_numpy(rng.uniform(-2, 2, size=(4096, 3)).astype(np.float32))
    dirs = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(4096, 3)).astype(np.float32)), dim=-1)
    g_sigma = torch.from_numpy(rng.normal(size=(4096,)).astype(np.float32))
    g_rgb = torch.from_numpy(rng.normal(size=(4096, 3)).astype(np.float32))
    acts, dzs = _stash(params, pts, dirs, g_sigma, g_rgb, cfg)
    a, z = acts["h3"].numpy(), dzs[4].numpy()
    exact = a.astype(np.float64).T @ z.astype(np.float64)
    plain = _rel(a.T @ z, exact)
    return a, z, exact, 2 * plain + 1e-5


def test_folded_f32_scheme_meets_the_f32_limit(f32_layer):
    a, z, exact, limit = f32_layer
    assert np.abs(exact).max() > 0 and (a > 0).mean() > 0.1
    err = _rel(_f32_scheme(a, z), exact)
    assert err <= limit, (err, limit)


def test_one_accumulator_fails_the_f32_limit(f32_layer):
    a, z, exact, limit = f32_layer
    err = _rel(_f32_scheme(a, z, fold=False), exact)
    assert err > limit, (err, limit)


def test_dropped_pieces_move_the_f32_sums(f32_layer):
    """The planted faults of the f32 pieces: the low piece dropped reads
    over 10x the scheme's error (2^-16 of an operand: under the f32 limit's
    1e-5 floor, so ``chip_smoke.py`` holds it on one stage against a
    limit of its own), the low and middle pieces dropped (one bf16
    product) far outside the f32 limit."""
    a, z, exact, limit = f32_layer
    a, z = a[:256], z[:256]
    exact = a.astype(np.float64).T @ z.astype(np.float64)
    scheme = _rel(_f32_scheme(a, z), exact)
    low = _rel(_f32_scheme(a, z, dropped=(2,)), exact)
    both = _rel(_f32_scheme(a, z, dropped=(1, 2)), exact)
    assert low > 10 * scheme and both > 100 * limit, (scheme, low, both, limit)
