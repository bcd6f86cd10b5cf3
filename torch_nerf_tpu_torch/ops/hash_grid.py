"""Multiresolution hash-grid encodes, forward and backward, as hand-written
Hopper kernels: the bricked, the per-corner and the voxel-packed table
layouts.

``csrc/hash_grid.cu`` holds six kernels, each replacing a Pallas TPU
kernel of the JAX package:

* :func:`hash_brick_fwd` -- ``ops/pallas/hash_brick.py::_fwd_kernel`` (kernel 4);
* :func:`hash_brick_bwd` -- ``hash_brick.py::_bwd_kernel`` (kernel 5);
* :func:`hash_corner_fwd` -- ``ops/pallas/hash_corner.py::_fwd_kernel`` (kernel 6);
* :func:`hash_corner_bwd` -- ``hash_corner.py::_bwd_kernel`` (kernel 7);
* :func:`hash_fold_fwd` -- ``ops/pallas/hash_fold.py::_fwd_kernel`` (kernel 8);
* :func:`hash_fold_bwd` -- ``hash_fold.py::_bwd_kernel`` (kernel 9).

Each encode returns ``(N, L*F)`` f32 features, level-major and
feature-minor. The JAX encodes' (N, 128) lane-padded lines, placement
matmuls, bf16 placement and weight roundings, SMEM index streams,
VMEM-resident tables, tile padding and grouped accumulators are TPU
workarounds and are not carried over. The tables keep their parameter
shapes, so checkpoints and ``params_from_jax`` carry across as they are:
the brick layout's (L, T_b, 128) -- 4^3 sites x F = 2 a row, lane ``((sx*4
+ sy)*4 + sz)*F + f`` -- and the packed layout's folded (L, rows/fold, 128),
``fold = 128 / (8F)`` packed rows of 8 corners x F a line, which is a pure
reshape of the (L, rows, 8F) packed table. Every layout is bound by bytes
on an H100 (the source's header note).

Beside each kernel is its plain PyTorch version, which the CPU takes and
which the kernel is held against on the card: :func:`brick_prep` +
gather (``hash_brick.py:309-354, 441-456``), :func:`corner_prep` + gather
(``models/instant_ngp.py::hash_encode``) and ``hash_math.packed_prep`` +
gather (``hash_fold.py:265-276, 368-381``), with ``index_add_`` for the
backwards, in slices of :data:`CHUNK` points. The wrappers run the kernel
on CUDA tensors (or raise) and the plain version on CPU tensors; each
counts its launches in ``.launches``. :func:`brick_encode`,
:func:`corner_encode` and :func:`fold_encode` are
``torch.autograd.Function``\\ s whose forward is the forward kernel and
whose backward is the backward kernel; like the JAX package's
``custom_vjp``, they give no gradient to the coordinates, the resolutions
or the offsets. The forwards (kernels 4, 6 and 8) walk the levels in
groups of 4 (brick, corner) or 8 (packed) levels at F = 2, the group
slowest, so that the tables being gathered stay in the card's L2; a warp
takes one level of 32 consecutive points and a block stores its staged
tile of the group's columns whole; kernel 4 reads each run of two z-sites
as one 16-byte vector where the floor site's z is even, kernel 6 its
corner rows in x-adjacent pairs. Their outputs equal the
thread-per-(point, level) form's bit for bit. The backward kernels first
sum, within a warp of 32 consecutive points of one level, the points that
write the same rows, then add the sums with vector atomics, in an order
that changes from run to run.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from torch_nerf_tpu_torch.models.hash_math import CORNERS, LANES, as_int32, hash_axis, lattice_u32, packed_prep
from torch_nerf_tpu_torch.ops import build
from torch_nerf_tpu_torch.ops.fused_nerf import check_tensor

KERNEL = "hash_grid"
BRICK_EDGE = 4  # sites per axis; bricks overlap by one site plane
STRIDE = BRICK_EDGE - 1
BRICK_FEAT = LANES // BRICK_EDGE**3  # F = 2: 4^3 sites x F fill a 128-float row
CORNER_FEATS = (1, 2, 4, 8)  # the corner kernels' feature widths
FOLD_FEATS = (1, 2, 4, 8, 16)  # a packed row of 8 corners x F divides 128 floats
# points per slice of the plain versions: the brick's (L, CHUNK, 128) f32
# weights are 67 MB at L = 16
CHUNK = 1 << 13


def bricks_per_level(log_max_entry_per_level: int, feat_dim: int) -> int:
    """Rows per level at the reference parameter budget 2^log * F floats."""
    total = (2**log_max_entry_per_level) * feat_dim
    if total % LANES != 0:
        raise ValueError(f"2^{log_max_entry_per_level} * F={feat_dim} must fill whole 128-float rows")
    return total // LANES


def check_brick_layout(table_shape, feat_dim: int = BRICK_FEAT) -> None:
    """Raise unless ``table_shape`` is a brick table (L, T_b, 128) with F = 2
    and T_b a power of two."""
    if BRICK_EDGE**3 * feat_dim != LANES:
        raise ValueError(f"bricked layout requires F={BRICK_FEAT}, got {feat_dim}")
    if len(table_shape) != 3 or table_shape[2] != LANES:
        raise ValueError(f"brick tables must be (L, T_b, {LANES}), got {tuple(table_shape)}")
    t_b = table_shape[1]
    if t_b < 1 or t_b & (t_b - 1):
        raise ValueError(f"bricked layout needs a power-of-two row count, got T_b={t_b}")


def fold_factor(feat_dim: int) -> int:
    """Packed rows of 8 corners x F in one 128-float line of a folded table."""
    if feat_dim not in FOLD_FEATS:
        raise ValueError(f"feat_dim must divide 16 lanes of 8 corners, got {feat_dim}")
    return LANES // (8 * feat_dim)


def check_fold_layout(table_shape, feat_dim: int) -> int:
    """Raise unless ``table_shape`` is a folded packed table (L, rows/fold,
    128) with a power-of-two packed row count; return that count."""
    fold = fold_factor(feat_dim)
    if len(table_shape) != 3 or table_shape[2] != LANES:
        raise ValueError(f"folded packed tables must be (L, rows/fold, {LANES}), got {tuple(table_shape)}")
    rows = table_shape[1] * fold
    if rows < 1 or rows & (rows - 1):
        raise ValueError(f"the packed layout needs a power-of-two row count, got {rows}")
    return rows


# ---------------------------------------------------------------------------
# the plain versions


def _slices(n: int):
    return [slice(a, min(n, a + CHUNK)) for a in range(0, n, CHUNK)]


def brick_prep(coords: torch.Tensor, resolutions: torch.Tensor, num_bricks: int, feat_dim: int = BRICK_FEAT):
    """Brick lookup of every (level, point): ``(idx (L, N) int64 rows,
    w128 (L, N, 128) f32 lane weights)``. Lane (site, f) weighs
    ``wx(sx) * wy(sy) * wz(sz)``, ``w_axis`` being ``span - frac`` at the
    voxel's floor site, ``frac`` at its ceil site and 0 elsewhere."""
    n, num_level, dev = coords.shape[0], resolutions.shape[0], coords.device
    site = torch.arange(LANES, device=dev) // feat_dim
    e = BRICK_EDGE
    sites = ((site // (e * e)).float(), ((site // e) % e).float(), (site % e).float())
    h = torch.zeros((num_level, n), dtype=torch.int64, device=dev)
    w128 = torch.ones((num_level, n, LANES), dtype=torch.float32, device=dev)
    for axis in range(3):
        scaled = resolutions[:, None] * coords[None, :, axis]
        v = torch.floor(scaled)
        span = torch.ceil(scaled) - v
        frac = scaled - v
        b = torch.floor(v / float(STRIDE))
        local = (v - float(STRIDE) * b)[..., None]  # (L, N, 1), in {0, 1, 2}
        sa = sites[axis]
        wa = torch.where(sa == local, (span - frac)[..., None], 0.0) + torch.where(
            sa == local + 1.0, frac[..., None], 0.0
        )
        w128 = w128 * wa
        h = hash_axis(h, lattice_u32(b), axis)
    return h & (num_bricks - 1), w128


def brick_encode_reference(tables: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor) -> torch.Tensor:
    """The plain version of kernel 4: ``(N, L*F)``, differentiable in
    ``tables`` by autograd."""
    check_brick_layout(tables.shape)
    num_level, t_b, _ = tables.shape
    f = BRICK_FEAT
    flat = tables.reshape(num_level * t_b, LANES)
    offset = (torch.arange(num_level, device=coords.device) * t_b)[:, None]
    outs = [tables.new_zeros((0, num_level * f))]
    for sl in _slices(coords.shape[0]):
        idx, w128 = brick_prep(coords[sl], resolutions, t_b, f)
        prod = flat[idx + offset] * w128  # (L, m, 128)
        out = prod.reshape(num_level, -1, LANES // f, f).sum(dim=2)  # (L, m, F)
        outs.append(out.permute(1, 0, 2).reshape(-1, num_level * f))
    return torch.cat(outs)


def brick_backward_reference(
    g: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor, num_bricks: int
) -> torch.Tensor:
    """The plain version of kernel 5: ``g (N, L*F)`` -> ``dtables (L, T_b,
    128)``, the weighted cotangents scatter-added with ``index_add_``,
    summed in ``g``'s dtype (f32; f64 for a reference that many points
    summed into one row must not round)."""
    num_level, f = resolutions.shape[0], BRICK_FEAT
    dflat = torch.zeros((num_level * num_bricks, LANES), dtype=g.dtype, device=g.device)
    offset = (torch.arange(num_level, device=g.device) * num_bricks)[:, None]
    for sl in _slices(coords.shape[0]):
        idx, w128 = brick_prep(coords[sl], resolutions, num_bricks, f)
        gl = g[sl].reshape(-1, num_level, f).permute(1, 0, 2)  # (L, m, F)
        vals = gl.repeat(1, 1, LANES // f) * w128  # lane k carries g[..., k % F]
        dflat.index_add_(0, (idx + offset).reshape(-1), vals.reshape(-1, LANES))
    return dflat.reshape(num_level, num_bricks, LANES)


def corner_prep(coords: torch.Tensor, resolutions: torch.Tensor, num_entries: int):
    """Per-corner lookup of every (point, level, corner), as
    ``hash_encode`` builds it: ``(idx (N, L*8) int64 rows of the (L*T, F)
    flat table, weights (N, L*8) f32)``; the weight is the product over axes
    of ``|opposite corner - scaled|``."""
    n, num_level, dev = coords.shape[0], resolutions.shape[0], coords.device
    res_lane = resolutions.repeat_interleave(8)  # (L*8,)
    bits = torch.as_tensor(np.tile(CORNERS, (num_level, 1)), device=dev)  # (L*8, 3)
    level_offset = (torch.arange(num_level, device=dev) * num_entries).repeat_interleave(8)
    idx = torch.zeros((n, num_level * 8), dtype=torch.int64, device=dev)
    weights = torch.ones((n, num_level * 8), dtype=coords.dtype, device=dev)
    for axis in range(3):
        scaled = coords[:, axis : axis + 1] * res_lane[None, :]
        floor = torch.floor(scaled)
        span = torch.ceil(scaled) - floor  # 0 when scaled is integral
        bit = bits[None, :, axis]
        vert = floor + bit * span
        opposite = floor + (1.0 - bit) * span
        weights = weights * torch.abs(opposite - scaled)
        idx = hash_axis(idx, lattice_u32(vert), axis)
    return torch.remainder(as_int32(idx), num_entries) + level_offset[None, :], weights


def corner_encode_reference(tables: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor) -> torch.Tensor:
    """The plain version of kernel 6 (``hash_encode``, any T): ``(N, L*F)``,
    differentiable in ``tables`` by autograd."""
    num_level, num_entries, f = tables.shape
    flat = tables.reshape(num_level * num_entries, f)
    outs = [tables.new_zeros((0, num_level * f))]
    for sl in _slices(coords.shape[0]):
        idx, w = corner_prep(coords[sl], resolutions, num_entries)
        feats = flat[idx].reshape(-1, num_level, 8, f)
        outs.append((feats * w.reshape(-1, num_level, 8, 1)).sum(dim=2).reshape(-1, num_level * f))
    return torch.cat(outs)


def corner_backward_reference(
    g: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor, num_entries: int, feat_dim: int
) -> torch.Tensor:
    """The plain version of kernel 7: ``g (N, L*F)`` -> ``dtables (L, T,
    F)``; corners that share a row accumulate, summed in ``g``'s dtype (as
    :func:`brick_backward_reference`)."""
    num_level = resolutions.shape[0]
    dflat = torch.zeros((num_level * num_entries, feat_dim), dtype=g.dtype, device=g.device)
    for sl in _slices(coords.shape[0]):
        idx, w = corner_prep(coords[sl], resolutions, num_entries)
        vals = g[sl].reshape(-1, num_level, 1, feat_dim) * w.reshape(-1, num_level, 8, 1)
        dflat.index_add_(0, idx.reshape(-1), vals.reshape(-1, feat_dim))
    return dflat.reshape(num_level, num_entries, feat_dim)


def fold_encode_reference(
    tables: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor, offsets: torch.Tensor, feat_dim: int
) -> torch.Tensor:
    """The plain version of kernel 8: folded ``tables (L, rows/fold, 128)``
    read as the packed (L, rows, 8F) view, one row gathered a (level, point)
    and its 8 corners blended -> ``(N, L*F)``, differentiable in ``tables``
    by autograd."""
    rows = check_fold_layout(tables.shape, feat_dim)
    num_level, f = tables.shape[0], feat_dim
    flat = tables.reshape(num_level * rows, 8 * f)
    offset = (torch.arange(num_level, device=coords.device) * rows)[:, None]
    outs = [tables.new_zeros((0, num_level * f))]
    for sl in _slices(coords.shape[0]):
        row, w = packed_prep(coords[sl], resolutions, rows, offsets)
        corners = flat[row + offset].reshape(num_level, -1, 8, f)
        out = (corners * w[..., None]).sum(dim=2)  # (L, m, F)
        outs.append(out.permute(1, 0, 2).reshape(-1, num_level * f))
    return torch.cat(outs)


def fold_backward_reference(
    g: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor, offsets: torch.Tensor,
    num_lines: int, feat_dim: int,
) -> torch.Tensor:
    """The plain version of kernel 9: ``g (N, L*F)`` -> ``dtables (L,
    num_lines, 128)``, the weighted cotangents scatter-added into the packed
    rows with ``index_add_``, summed in ``g``'s dtype (f32; f64 for a
    reference that many points summed into one row must not round)."""
    num_level, f = resolutions.shape[0], feat_dim
    rows = check_fold_layout((num_level, num_lines, LANES), f)
    dflat = torch.zeros((num_level * rows, 8 * f), dtype=g.dtype, device=g.device)
    offset = (torch.arange(num_level, device=g.device) * rows)[:, None]
    for sl in _slices(coords.shape[0]):
        row, w = packed_prep(coords[sl], resolutions, rows, offsets)
        gl = g[sl].reshape(-1, num_level, 1, f).permute(1, 0, 2, 3)  # (L, m, 1, F)
        vals = gl * w[..., None]  # (L, m, 8, F)
        dflat.index_add_(0, (row + offset).reshape(-1), vals.reshape(-1, 8 * f))
    return dflat.reshape(num_level, num_lines, LANES)


# ---------------------------------------------------------------------------
# the kernels' wrappers


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/hash_grid.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("hash_brick_fwd", "hash_brick_bwd"):
        getattr(lib, name).argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        getattr(lib, name).restype = i32
    for name in ("hash_corner_fwd", "hash_corner_bwd"):
        getattr(lib, name).argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        getattr(lib, name).restype = i32
    for name in ("hash_fold_fwd", "hash_fold_bwd"):
        getattr(lib, name).argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        getattr(lib, name).restype = i32
    lib.hash_grid_error_string.argtypes = [i32]
    lib.hash_grid_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    return bind(build.load(KERNEL))


def _check_points(coords: torch.Tensor, resolutions: torch.Tensor, num_level: int) -> int:
    if coords.dim() != 2 or coords.shape[1] != 3:
        raise ValueError(f"coords must be (N, 3), got {tuple(coords.shape)}")
    check_tensor("coords", coords, tuple(coords.shape))
    check_tensor("resolutions", resolutions, (num_level,))
    if resolutions.device != coords.device:
        raise ValueError("resolutions and coords must be on the same device")
    return coords.shape[0]


def _launch(name: str, *args) -> None:
    """Call the C function ``name`` with tensors as device pointers, then
    the current stream; raise on a launch error."""
    lib = _library()
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
    if err != 0:
        msg = lib.hash_grid_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")


def hash_brick_fwd(tables: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor) -> torch.Tensor:
    """Kernel 4 on CUDA tensors (or raise), :func:`brick_encode_reference`
    on CPU tensors: ``tables (L, T_b, 128)``, ``coords (N, 3)``,
    ``resolutions (L,)`` -> ``(N, L*2)``."""
    if coords.device.type == "cpu":
        return brick_encode_reference(tables, coords, resolutions)
    check_brick_layout(tables.shape)
    num_level, t_b, _ = tables.shape
    check_tensor("tables", tables, tuple(tables.shape))
    n = _check_points(coords, resolutions, num_level)
    if tables.device != coords.device:
        raise ValueError("tables and coords must be on the same device")
    _check_aligned("tables", tables)
    out = torch.empty((n, num_level * BRICK_FEAT), dtype=torch.float32, device=coords.device)
    if n:
        _launch("hash_brick_fwd", tables, coords, resolutions, out, n, num_level, t_b)
        hash_brick_fwd.launches += 1
    return out


def hash_brick_bwd(
    g: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor, num_bricks: int
) -> torch.Tensor:
    """Kernel 5 on CUDA tensors (or raise), :func:`brick_backward_reference`
    on CPU tensors: ``g (N, L*2)`` -> ``dtables (L, T_b, 128)``."""
    if coords.device.type == "cpu":
        return brick_backward_reference(g, coords, resolutions, num_bricks)
    num_level = resolutions.shape[0]
    check_brick_layout((num_level, num_bricks, LANES))
    n = _check_points(coords, resolutions, num_level)
    check_tensor("g", g, (n, num_level * BRICK_FEAT))
    _check_aligned("g", g)
    dtables = torch.zeros((num_level, num_bricks, LANES), dtype=torch.float32, device=coords.device)
    _check_aligned("dtables", dtables)
    if n:
        _launch("hash_brick_bwd", g, coords, resolutions, dtables, n, num_level, num_bricks)
        hash_brick_bwd.launches += 1
    return dtables


def _check_corner_feat(feat_dim: int) -> None:
    if feat_dim not in CORNER_FEATS:
        raise ValueError(f"the corner kernels take F in {CORNER_FEATS}, got {feat_dim}")


def hash_corner_fwd(tables: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor) -> torch.Tensor:
    """Kernel 6 on CUDA tensors (or raise), :func:`corner_encode_reference`
    on CPU tensors: ``tables (L, T, F)`` -> ``(N, L*F)``."""
    if coords.device.type == "cpu":
        return corner_encode_reference(tables, coords, resolutions)
    num_level, num_entries, f = tables.shape
    _check_corner_feat(f)
    check_tensor("tables", tables, tuple(tables.shape))
    n = _check_points(coords, resolutions, num_level)
    if tables.device != coords.device:
        raise ValueError("tables and coords must be on the same device")
    _check_aligned("tables", tables)
    out = torch.empty((n, num_level * f), dtype=torch.float32, device=coords.device)
    if n:
        _launch("hash_corner_fwd", tables, coords, resolutions, out, n, num_level, num_entries, f)
        hash_corner_fwd.launches += 1
    return out


def hash_corner_bwd(
    g: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor, num_entries: int, feat_dim: int
) -> torch.Tensor:
    """Kernel 7 on CUDA tensors (or raise), :func:`corner_backward_reference`
    on CPU tensors: ``g (N, L*F)`` -> ``dtables (L, T, F)``."""
    if coords.device.type == "cpu":
        return corner_backward_reference(g, coords, resolutions, num_entries, feat_dim)
    _check_corner_feat(feat_dim)
    num_level = resolutions.shape[0]
    n = _check_points(coords, resolutions, num_level)
    check_tensor("g", g, (n, num_level * feat_dim))
    _check_aligned("g", g)
    dtables = torch.zeros((num_level, num_entries, feat_dim), dtype=torch.float32, device=coords.device)
    _check_aligned("dtables", dtables)
    if n:
        _launch("hash_corner_bwd", g, coords, resolutions, dtables, n, num_level, num_entries, feat_dim)
        hash_corner_bwd.launches += 1
    return dtables


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """The kernels read tables and cotangents, and add to table gradients,
    in 8- or 16-byte vectors."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned: the kernel reads or adds to it in vectors")


def _check_offsets(offsets: torch.Tensor, resolutions: torch.Tensor) -> None:
    check_tensor("offsets", offsets, tuple(resolutions.shape))
    if offsets.device != resolutions.device:
        raise ValueError("offsets and resolutions must be on the same device")


def hash_fold_fwd(
    tables: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor, offsets: torch.Tensor, feat_dim: int
) -> torch.Tensor:
    """Kernel 8 on CUDA tensors (or raise), :func:`fold_encode_reference`
    on CPU tensors: ``tables (L, rows/fold, 128)``, ``coords (N, 3)``,
    ``resolutions`` and ``offsets`` (L,) -> ``(N, L*F)``."""
    if coords.device.type == "cpu":
        return fold_encode_reference(tables, coords, resolutions, offsets, feat_dim)
    rows = check_fold_layout(tables.shape, feat_dim)
    num_level = tables.shape[0]
    check_tensor("tables", tables, tuple(tables.shape))
    n = _check_points(coords, resolutions, num_level)
    _check_offsets(offsets, resolutions)
    if tables.device != coords.device:
        raise ValueError("tables and coords must be on the same device")
    _check_aligned("tables", tables)
    out = torch.empty((n, num_level * feat_dim), dtype=torch.float32, device=coords.device)
    if n:
        _launch("hash_fold_fwd", tables, coords, resolutions, offsets, out, n, num_level, rows, feat_dim)
        hash_fold_fwd.launches += 1
    return out


def hash_fold_bwd(
    g: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor, offsets: torch.Tensor,
    num_lines: int, feat_dim: int,
) -> torch.Tensor:
    """Kernel 9 on CUDA tensors (or raise), :func:`fold_backward_reference`
    on CPU tensors: ``g (N, L*F)`` -> ``dtables (L, num_lines, 128)``."""
    if coords.device.type == "cpu":
        return fold_backward_reference(g, coords, resolutions, offsets, num_lines, feat_dim)
    num_level = resolutions.shape[0]
    rows = check_fold_layout((num_level, num_lines, LANES), feat_dim)
    n = _check_points(coords, resolutions, num_level)
    _check_offsets(offsets, resolutions)
    check_tensor("g", g, (n, num_level * feat_dim))
    _check_aligned("g", g)
    dtables = torch.zeros((num_level, num_lines, LANES), dtype=torch.float32, device=coords.device)
    _check_aligned("dtables", dtables)
    if n:
        _launch("hash_fold_bwd", g, coords, resolutions, offsets, dtables, n, num_level, rows, feat_dim)
        hash_fold_bwd.launches += 1
    return dtables


for _fn in (hash_brick_fwd, hash_brick_bwd, hash_corner_fwd, hash_corner_bwd, hash_fold_fwd, hash_fold_bwd):
    _fn.launches = 0


class _BrickEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, coords, resolutions):
        ctx.save_for_backward(coords, resolutions)
        ctx.num_bricks = tables.shape[1]
        return hash_brick_fwd(tables, coords, resolutions)

    @staticmethod
    def backward(ctx, g):
        coords, resolutions = ctx.saved_tensors
        return hash_brick_bwd(g.contiguous(), coords, resolutions, ctx.num_bricks), None, None


class _CornerEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, coords, resolutions):
        ctx.save_for_backward(coords, resolutions)
        ctx.table_shape = tuple(tables.shape)
        return hash_corner_fwd(tables, coords, resolutions)

    @staticmethod
    def backward(ctx, g):
        coords, resolutions = ctx.saved_tensors
        _, num_entries, f = ctx.table_shape
        return hash_corner_bwd(g.contiguous(), coords, resolutions, num_entries, f), None, None


class _FoldEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, coords, resolutions, offsets, feat_dim):
        ctx.save_for_backward(coords, resolutions, offsets)
        ctx.num_lines, ctx.feat_dim = tables.shape[1], feat_dim
        return hash_fold_fwd(tables, coords, resolutions, offsets, feat_dim)

    @staticmethod
    def backward(ctx, g):
        coords, resolutions, offsets = ctx.saved_tensors
        dtables = hash_fold_bwd(g.contiguous(), coords, resolutions, offsets, ctx.num_lines, ctx.feat_dim)
        return dtables, None, None, None, None


def brick_encode(tables: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor) -> torch.Tensor:
    """Bricked encode ``(N, L*2)`` through kernels 4 (forward) and 5
    (backward); gradients reach ``tables`` only."""
    return _BrickEncode.apply(tables, coords, resolutions)


def corner_encode(tables: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor) -> torch.Tensor:
    """Per-corner encode ``(N, L*F)`` through kernels 6 (forward) and 7
    (backward); gradients reach ``tables`` only."""
    return _CornerEncode.apply(tables, coords, resolutions)


def fold_encode(
    tables: torch.Tensor, coords: torch.Tensor, resolutions: torch.Tensor, offsets: torch.Tensor, feat_dim: int
) -> torch.Tensor:
    """Voxel-packed encode ``(N, L*F)`` of folded tables through kernels 8
    (forward) and 9 (backward); gradients reach ``tables`` only."""
    return _FoldEncode.apply(tables, coords, resolutions, offsets, feat_dim)
