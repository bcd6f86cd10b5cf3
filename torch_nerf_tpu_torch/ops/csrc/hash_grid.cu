// Multiresolution hash-grid encodes on Hopper: the bricked, the per-corner
// and the voxel-packed table layouts, each forward and backward.
//
// Replaces six Pallas TPU kernels of the JAX package:
//   hash_brick_fwd_kernel  <- torch_nerf_tpu/ops/pallas/hash_brick.py::_fwd_kernel
//                             (reached through _fwd_pallas's pl.pallas_call)
//   hash_brick_bwd_kernel  <- hash_brick.py::_bwd_kernel (through _bwd_pallas)
//   hash_corner_fwd_kernel <- torch_nerf_tpu/ops/pallas/hash_corner.py::_fwd_kernel
//                             (through _fwd_pallas)
//   hash_corner_bwd_kernel <- hash_corner.py::_bwd_kernel (through _bwd_pallas)
//   hash_fold_fwd_kernel   <- torch_nerf_tpu/ops/pallas/hash_fold.py::_fwd_kernel
//                             (through _fwd_pallas)
//   hash_fold_bwd_kernel   <- hash_fold.py::_bwd_kernel (through _bwd_pallas)
//
// Every encode blends, for every (point, level), the 8 trilinear lattice
// sites of the point's voxel, F features each, into out[point, level*F + f]
// (level-major, feature-minor: an (N, L*F) f32 array). They differ only in
// where a site's features live:
//   * bricked: one Teschner hash of the brick b = floor(floor(res*x) / 3)
//     per axis picks a row of the (L, T_b, 128) table, T_b a power of two;
//     the row holds 4^3 sites x F = 2 (lane ((sx*4 + sy)*4 + sz)*F + f),
//     and the voxel's 8 sites are local = v - 3b and local + 1 per axis;
//   * corner: each of the 8 corners hashes on its own into the (L, T, F)
//     table, row = the non-negative remainder of the int32-reinterpreted
//     hash mod T (a bitwise AND when T is a power of two);
//   * packed: one hash of the voxel's floor corner picks a packed row of
//     8 corners x F floats (corner c's feature f at c*F + f, corners in the
//     reference's order); the folded (L, rows/fold, 128) table is a pure
//     reshape of (L, rows, 8F), so row r of level l starts at float
//     (l*rows + r)*8F, 32F bytes from the last: every row is 16-byte
//     aligned and is read as 2F float4 vectors. rows is a power of two and
//     the row is the hash's low bits. The dual layout passes 2L
//     pseudo-levels whose offsets are 0.5 for levels [L, 2L).
// The weights are the JAX package's, in f32: scaled = x*res (x*res + off
// for the packed layout), v = floor, span = ceil - v, frac = scaled - v;
// per axis span - frac at the floor site and frac at the ceil site
// (bricked and packed, the select form), or |opposite - scaled| (corner,
// hash_encode's form); at an integral scaled coordinate span is 0 and every
// weight vanishes (the reference's quirk). x*res is taken with __fmul_rn so
// that it is never fused into the subtraction that follows; x*res + off is
// taken with __fmaf_rn, one rounding, as XLA computes it (for an offset of
// 0.5 the two-step form differs in the last bit of frac and, at a voxel
// face, in floor); v / 3 is an IEEE division (the build has no
// --use_fast_math).
//
// The backwards scatter-add g[point, level*F + f] * w into a zeroed f32
// table gradient; corners of one point that share a row, and the many
// points of a coarse level, accumulate. The order of those sums changes
// from run to run. No gradient reaches the coordinates, the resolutions or
// the offsets, as in the JAX package's custom_vjp.
//
// Bound on an H100 SXM: bytes. Each (point, level) does ~60 flops against
// a data-dependent gather of 8 x F floats from a 64 MiB table that does not
// fit in the 50 MB L2; counting each input once, one encode of 2^20 points
// moves the table or its gradient (67.1 MB, twice that for the dual
// layout), the coordinates (12.6 MB) and the output or its cotangent (134.2
// MB at L*F = 32): 0.064 ms at 3.35 TB/s (0.124 ms dual).
//
// Forward of the brick (kernel 4): one thread per (point, level) with the
// level varying fastest, so a warp's loads of the coordinates broadcast and
// its F-wide stores fill whole output rows; it reads only the 4 runs of 2
// sites x F floats that carry weight, not its 128-float row. Under that
// order all L levels are gathered at once, so the whole table (67.1 MB,
// 134.2 MB dual) is live against the 50 MB L2, and on the ~10 fine levels,
// where each sample reads a new row, most gathers go to HBM as random
// 32-byte sectors.
//
// Forwards of the corner and packed layouts (kernels 6, 8): a level-group-
// major walk that keeps the tables being gathered in L2. The grid walks the
// levels in groups of G consecutive (pseudo-)levels, with the group varying
// slowest: block b takes group b / tiles and tile b % tiles of P = 256 / G
// points (FwdTile). A group fills 32 output bytes of a point in kernel 6
// (G = 4 at F = 2, a sector) and 64 in kernel 8 (G = 8). One level of one
// table is 4 MB at the presets' size (2^19 x F x 4 B; 2^16 packed rows x
// 64 B), so a group's 16 or 32 MB stays in L2 while every point passes
// through it, and HBM supplies each table byte about once a launch. The
// design assumes that the blocks resident at any moment (~8 an SM, ~1000 of
// a group's 2^20 / P) are neighbours in blockIdx order, as the hardware
// dispatches a 1-D grid in rising order in practice; the programming model
// does not promise it, and the results do not depend on it, only where the
// gathers are served from. Inside a block, lane = point and warp = a level
// of the group: on the coarse levels consecutive samples of a ray share a
// voxel, so their lanes ask for the same rows in one request. Each (point,
// level)'s F sums are staged in shared memory, and the tile is stored as
// whole sectors of out[p, l0*F : (l0 + G)*F] (store_tile): without the
// staging, lane = point would make every F-wide store a partial sector.
// Kernel 6 reads its 8 corner rows of F floats as 4 x-pairs (corner_pair):
// the x prime is 1, so where the floor's x is even two corners that differ
// only in x land on one aligned pair of rows, and one vector load serves
// both. The address math (axis_geometry, corner_of, packed_of) and the
// order of the sums over the corners are the backwards' and the
// reference's, so the outputs are those of the thread-per-(point, level)
// forwards they replace bit for bit. On the NGP train batch (2^20 points),
// NVIDIA H100 80GB HBM3 at 700.00 W (runners/kernel_ab.py against the
// thread-per-(point, level) forwards, PERF.md section 6): kernel 6 0.594
// ms (1.012), kernel 8 0.301 ms (0.333), 0.591 ms dual (0.805); 32-byte
// groups for kernel 8 took 0.314 (0.630 dual), 64-byte groups for kernel
// 6 0.661, kernel 6 without x-pairs 0.641. What holds them now is not HBM
// but their load requests: kernel 8 issues 4 float4 loads a (point,
// level), each lane's to its own sector, at 0.85-0.87 a clock an SM in
// both layouts at 1980 MHz; reading a warp's 32 packed rows together
// through shared memory (half the sectors a load instruction touches) was
// slower.
//
// Backwards (kernels 5, 7, 9): what holds them is the scatter, not the
// bytes above: up to 8F updates a (point, level) at random rows of a table
// that misses L2, each a read-modify-write of a 32-byte sector. So they cut
// the number of atomics. A warp takes one level of 32 consecutive points,
// lane = point; a ray's samples come one after another, so on the coarse
// levels neighbouring lanes fall in one voxel. Each run of consecutive
// lanes that write the same rows (the same brick row and floor site; the
// same 8 corner rows; the same packed row) sums its weighted cotangents by
// a segmented shuffle scan, and the run's first lane adds the sums with
// sm_90's vector atomics: 4-8 (float4 or float2 pairs) a run for the brick
// where the scalar form took up to 16 a point, 8 F-wide ones for the
// corners where it took up to 8F, 2F float4 for the packed row where it
// took up to 8F. A sum whose components are all 0 is not added. On
// the 2^20 points of an NGP train batch (L 16, F 2, T 2^19), NVIDIA H100
// 80GB HBM3 at 700.00 W (PERF.md section 6): kernel 5 1.48 ms (3.43 with
// scalar atomics, one thread per (point, level)), kernel 7 2.35 ms (3.93),
// kernel 9 1.18 ms (3.37); counted, at most 57-68 G vector atomics a
// second each, so the count of atomics, not the bytes, sets the time. A
// deterministic sort-based scatter, or a brick row staged in shared
// memory, is left for later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// output bytes of a point a forward's level group fills (FwdTile)
constexpr int kCornerGroupBytes = 32;  // kernel 6: a sector; G = 4 at F = 2
constexpr int kFoldGroupBytes = 64;    // kernel 8: G = 8 at F = 2
constexpr int kBrickEdge = 4;
constexpr int kBrickLanes = 128;
__constant__ uint32_t kPrimes[3] = {1u, 2654435761u, 805459861u};
// the reference's corner order: fff, cff, fcf, ffc, ccf, cfc, fcc, ccc
__constant__ int kCorners[8][3] = {{0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {0, 0, 1},
                                   {1, 1, 0}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1}};

struct Axis {
  float scaled, v, span, frac;
};

__device__ __forceinline__ Axis axis_geometry(float x, float res) {
  Axis a;
  a.scaled = __fmul_rn(x, res);
  a.v = floorf(a.scaled);
  a.span = ceilf(a.scaled) - a.v;
  a.frac = a.scaled - a.v;
  return a;
}

__device__ __forceinline__ uint32_t lattice_bits(float v) {
  return static_cast<uint32_t>(static_cast<int32_t>(v));
}

// One (point, level) of the brick layout: the row's offset in the table,
// the floor site per axis and the two weights per axis.
struct Brick {
  size_t row;
  int site[3];
  float w[3][2];
};

__device__ __forceinline__ Brick brick_of(const float* __restrict__ coords,
                                          const float* __restrict__ res, int p, int l,
                                          int bricks) {
  Brick k;
  const float r = __ldg(res + l);
  uint32_t h = 0;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const Axis a = axis_geometry(__ldg(coords + 3 * static_cast<size_t>(p) + axis), r);
    const float b = floorf(a.v / 3.0f);
    k.site[axis] = static_cast<int>(a.v - 3.0f * b);
    k.w[axis][0] = a.span - a.frac;
    k.w[axis][1] = a.frac;
    h ^= lattice_bits(b) * kPrimes[axis];
  }
  k.row = (static_cast<size_t>(l) * bricks + (h & static_cast<uint32_t>(bricks - 1))) * kBrickLanes;
  return k;
}

// One corner of the corner layout: its weight and its row's offset.
__device__ __forceinline__ float corner_of(const Axis* a, int c, int l, int entries,
                                           size_t* row) {
  uint32_t h = 0;
  float w = 1.0f;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const bool ceil_side = kCorners[c][axis] != 0;
    const float vert = ceil_side ? a[axis].v + a[axis].span : a[axis].v;
    const float opposite = ceil_side ? a[axis].v : a[axis].v + a[axis].span;
    w = __fmul_rn(w, fabsf(opposite - a[axis].scaled));
    h ^= lattice_bits(vert) * kPrimes[axis];
  }
  int slot;
  if ((entries & (entries - 1)) == 0) {
    slot = static_cast<int>(h & static_cast<uint32_t>(entries - 1));
  } else {
    slot = static_cast<int32_t>(h) % entries;
    if (slot < 0) slot += entries;
  }
  *row = static_cast<size_t>(l) * entries + slot;
  return w;
}

template <int F>
__device__ __forceinline__ void store(float* __restrict__ out, size_t i, const float* acc) {
  if constexpr (F == 2) {
    *reinterpret_cast<float2*>(out + i * 2) = make_float2(acc[0], acc[1]);
  } else if constexpr (F % 4 == 0) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      reinterpret_cast<float4*>(out + i * F)[q] =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) out[i * F + f] = acc[f];
  }
}

template <int F>
__device__ __forceinline__ void load(const float* __restrict__ g, size_t i, float* v) {
  if constexpr (F == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(g + i * 2));
    v[0] = x.x;
    v[1] = x.y;
  } else if constexpr (F % 4 == 0) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(g + i * F) + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = __ldg(g + i * F + f);
  }
}

// --------------------------------------------------------------------------
// the forwards' level-group-major walk (kernels 6 and 8)

// One block's share of the walk. A group is G consecutive (pseudo-)levels
// whose G*F floats of a point fill kBytes of output (at most 8 levels, a
// warp each): block b takes level group b / tiles (levels [l0, l0 + G)) and
// tile b % tiles (points [p0, p0 + P)). Warp w takes level l0 + w % G and
// the window of 32 points from p0 + 32 * (w / G), lane = point, so a block
// of 8 warps covers P = 256 / G points of G levels.
template <int F, int kBytes>
struct FwdTile {
  static constexpr int kLevels = kBytes / (4 * F) < 1 ? 1 : kBytes / (4 * F) > 8 ? 8 : kBytes / (4 * F);
  static constexpr int kPoints = kThreads / kLevels;
  static constexpr int kCols = kLevels * F;  // staged floats a point
  static_assert((kThreads / 32) % kLevels == 0, "a block's warps cover whole windows of the group's levels");
  int l0, p0;  // the group's first level, the tile's first point
  int j, pp;   // this warp's level in the group, this lane's point in the tile
};

template <class Tile>
__device__ __forceinline__ Tile fwd_tile(int n) {
  Tile t;
  const unsigned tiles = (static_cast<unsigned>(n) + Tile::kPoints - 1) / Tile::kPoints;
  t.l0 = static_cast<int>(blockIdx.x / tiles) * Tile::kLevels;
  t.p0 = static_cast<int>(blockIdx.x % tiles) * Tile::kPoints;
  const int warp = static_cast<int>(threadIdx.x >> 5);
  t.j = warp % Tile::kLevels;
  t.pp = (warp / Tile::kLevels) * 32 + static_cast<int>(threadIdx.x & 31);
  return t;
}

// Stores the staged tile (kPoints rows of kCols floats) to the group's
// columns of its points: as float4 when `vec` (L*F a multiple of 4 and
// `out` 16-byte aligned, so every point's G*F floats are whole aligned
// vectors and a warp writes whole sectors), else float by float. A group
// past the last level stores only the levels that exist.
template <int F, class Tile>
__device__ __forceinline__ void store_tile(const float* staged, float* __restrict__ out, const Tile& t,
                                           int n, int levels, bool vec) {
  const int cols = min(Tile::kLevels, levels - t.l0) * F;
  const int points = min(Tile::kPoints, n - t.p0);
  const size_t stride = static_cast<size_t>(levels) * F;
  float* base = out + static_cast<size_t>(t.p0) * stride + static_cast<size_t>(t.l0) * F;
  if (vec) {
    const int quads = cols / 4;
    for (int i = static_cast<int>(threadIdx.x); i < points * quads; i += kThreads) {
      const int pp = i / quads;
      const int c = 4 * (i - pp * quads);
      *reinterpret_cast<float4*>(base + pp * stride + c) =
          *reinterpret_cast<const float4*>(staged + pp * Tile::kCols + c);
    }
  } else {
    for (int i = static_cast<int>(threadIdx.x); i < points * cols; i += kThreads) {
      const int pp = i / cols;
      const int c = i - pp * cols;
      base[pp * stride + c] = staged[pp * Tile::kCols + c];
    }
  }
}

// --------------------------------------------------------------------------
// the backwards' warp layout: a warp per level of a window of 32 consecutive
// points, lane = point

constexpr unsigned kFull = 0xffffffffu;

// This warp's level and this lane's point; false for a warp past the last
// window (warp-uniform). Lanes with p >= n take part in the shuffles.
__device__ __forceinline__ bool warp_point(int n, int levels, int* l, int* p) {
  const size_t warp = (blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x) >> 5;
  if (warp >= static_cast<size_t>((n + 31) / 32) * levels) return false;
  *l = static_cast<int>(warp % levels);
  *p = static_cast<int>(warp / levels) * 32 + static_cast<int>(threadIdx.x & 31);
  return true;
}

// Runs of consecutive lanes: one starts at lane 0 and at every lane whose
// `starts` is set. Leaves in each run's first lane the run's sum of every
// v[e] (a segmented shuffle scan: after the step of offset o, lane i holds
// the sum over [i, min(i + 2o - 1, run_end)], as many steps as the warp's
// longest run needs) and returns whether this lane heads its run.
template <int E>
__device__ __forceinline__ bool sum_runs(bool starts, float (&v)[E]) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const bool head = lane == 0 || starts;
  const uint32_t heads = __ballot_sync(kFull, head);
  const uint32_t later = lane == 31 ? 0u : heads & (kFull << (lane + 1));
  const int run_end = later ? __ffs(later) - 2 : 31;
  const unsigned longest = __reduce_max_sync(kFull, static_cast<unsigned>(run_end - lane + 1));
  for (int o = 1; o < static_cast<int>(longest); o <<= 1) {
    const bool take = lane + o <= run_end;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float u = __shfl_down_sync(kFull, v[e], o);
      if (take) v[e] += u;
    }
  }
  return head;
}

// Vector atomics (sm_90) of 1, 2 or 4 sums to dst (aligned to their size),
// none where every sum is zero: a site or corner of zero weight contributes
// an exact zero, as the scalar kernels skipped it.
__device__ __forceinline__ void add1(float* dst, const float* s) {
  if (s[0] != 0.f) atomicAdd(dst, s[0]);
}

__device__ __forceinline__ void add2(float* dst, const float* s) {
  if (s[0] != 0.f || s[1] != 0.f) atomicAdd(reinterpret_cast<float2*>(dst), make_float2(s[0], s[1]));
}

__device__ __forceinline__ void add4(float* dst, const float* s) {
  if (s[0] != 0.f || s[1] != 0.f || s[2] != 0.f || s[3] != 0.f) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(s[0], s[1], s[2], s[3]));
  }
}

// --------------------------------------------------------------------------
// bricked layout, F = 2

__global__ void __launch_bounds__(kThreads)
    hash_brick_fwd_kernel(const float* __restrict__ tables, const float* __restrict__ coords,
                          const float* __restrict__ res, float* __restrict__ out, int n,
                          int levels, int bricks) {
  constexpr int F = 2;
  const size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (i >= static_cast<size_t>(n) * levels) return;
  const int p = static_cast<int>(i / levels);
  const int l = static_cast<int>(i % levels);
  const Brick k = brick_of(coords, res, p, l, bricks);
  const float* row = tables + k.row;
  float acc[F] = {0.f, 0.f};
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wxy = __fmul_rn(k.w[0][dx], k.w[1][dy]);
      const int site = ((k.site[0] + dx) * kBrickEdge + k.site[1] + dy) * kBrickEdge + k.site[2];
      // the run of two z-sites: 4 consecutive floats, 8-byte aligned
      const float2 lo = __ldg(reinterpret_cast<const float2*>(row + site * F));
      const float2 hi = __ldg(reinterpret_cast<const float2*>(row + site * F + F));
      const float w0 = __fmul_rn(wxy, k.w[2][0]);
      const float w1 = __fmul_rn(wxy, k.w[2][1]);
      acc[0] += lo.x * w0 + hi.x * w1;
      acc[1] += lo.y * w0 + hi.y * w1;
    }
  }
  store<F>(out, i, acc);
}

// Kernel 5: a warp per level of 32 consecutive points (warp_point). Lanes
// in one voxel share the brick row and the floor site, so all 8 sites: a
// run of them sums its 16 weighted cotangents (sum_runs), and its first
// lane adds each (dx, dy)'s run of two z-sites, 4 consecutive floats, with
// one float4 atomic where the floor site is even (16-byte aligned) or two
// float2 atomics where it is odd.
__global__ void __launch_bounds__(kThreads)
    hash_brick_bwd_kernel(const float* __restrict__ g, const float* __restrict__ coords,
                          const float* __restrict__ res, float* __restrict__ dtables, int n,
                          int levels, int bricks) {
  constexpr int F = 2;
  int l, p;
  if (!warp_point(n, levels, &l, &p)) return;
  const bool valid = p < n;
  // site (dx, dy, dz), feature f at ((dx*2 + dy)*2 + dz)*F + f: (dx, dy)'s
  // two z-sites are 4 consecutive floats of the row, as here
  float v[8 * F];
  size_t at = 0;  // the floor site's first float in the table
  uint32_t key = kFull;  // never a voxel's: lanes past n form runs of their own
  if (valid) {
    const Brick k = brick_of(coords, res, p, l, bricks);
    float gv[F];
    load<F>(g, static_cast<size_t>(p) * levels + l, gv);
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float wxy = __fmul_rn(k.w[0][dx], k.w[1][dy]);
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          const float w = __fmul_rn(wxy, k.w[2][dz]);
#pragma unroll
          for (int f = 0; f < F; ++f) v[((dx * 2 + dy) * 2 + dz) * F + f] = w == 0.f ? 0.f : __fmul_rn(gv[f], w);
        }
      }
    const int site = (k.site[0] * kBrickEdge + k.site[1]) * kBrickEdge + k.site[2];
    at = k.row + static_cast<size_t>(site) * F;
    // rows are multiples of 128 floats and of one level less than 2^32
    // floats apart, a site index is below 64: the low word of the row ORed
    // with the site tells the voxels of a level apart (and is never kFull)
    key = static_cast<uint32_t>(k.row) | static_cast<uint32_t>(site);
  } else {
#pragma unroll
    for (int e = 0; e < 8 * F; ++e) v[e] = 0.f;
  }
  if (!sum_runs(key != __shfl_up_sync(kFull, key, 1), v) || !valid) return;
  const bool even = (at & 3) == 0;  // the floor site's z is even
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      float* dst = dtables + at + (dx * kBrickEdge + dy) * kBrickEdge * F;
      const float* s = v + (dx * 2 + dy) * 2 * F;
      if (even) {
        add4(dst, s);
      } else {
        add2(dst, s);
        add2(dst + F, s + F);
      }
    }
}

// --------------------------------------------------------------------------
// corner layout, F features a row

// Corners c0 and c1 (the same but for x) of rows row[c0], row[c1] into
// v[c0], v[c1]: one load of the aligned pair of rows that holds row[c0]
// (2F floats, 8F-byte aligned: one vector where F <= 2) where `pairs`
// allows it, and row[c1] from it too where it lies in the same pair; a load
// of its own otherwise.
template <int F>
__device__ __forceinline__ void corner_pair(const float* __restrict__ tables, const size_t* row,
                                            int c0, int c1, bool pairs, float (&v)[8][F]) {
  if (F > 2 || !pairs) {
    load<F>(tables, row[c0], v[c0]);
    load<F>(tables, row[c1], v[c1]);
    return;
  }
  float two[2 * F];
  load<2 * F>(tables, row[c0] >> 1, two);
  const bool hi0 = row[c0] & 1;
  const bool hi1 = row[c1] & 1;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    v[c0][f] = hi0 ? two[F + f] : two[f];
    v[c1][f] = hi1 ? two[F + f] : two[f];
  }
  if ((row[c1] >> 1) != (row[c0] >> 1)) load<F>(tables, row[c1], v[c1]);
}

// Kernel 6: the level-group-major walk (fwd_tile) in groups of a 32-byte
// output sector (G = 4 at F = 2): lane = point, warp = a level of the
// group. The 8 corner rows are read as x-pairs (corner_pair):
// the x prime is 1, so where the floor's x is even the two corners that
// differ only in x hash to rows 2m and 2m + 1, one aligned pair, and one
// load of 2F floats serves both. The 8 corners are blended in the
// reference's order, the (point, level)'s F sums staged, then the tile
// stored (store_tile).
template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_corner_fwd_kernel(const float* __restrict__ tables, const float* __restrict__ coords,
                           const float* __restrict__ res, float* __restrict__ out, int n,
                           int levels, int entries, bool vec) {
  using Tile = FwdTile<F, kCornerGroupBytes>;
  __shared__ __align__(16) float staged[Tile::kPoints * Tile::kCols];
  const Tile t = fwd_tile<Tile>(n);
  const int l = t.l0 + t.j;
  const int p = t.p0 + t.pp;
  if (l < levels && p < n) {
    const float r = __ldg(res + l);
    Axis a[3];
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
      a[axis] = axis_geometry(__ldg(coords + 3 * static_cast<size_t>(p) + axis), r);
    }
    size_t row[8];
    float w[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) w[c] = corner_of(a, c, l, entries, &row[c]);
    // an odd T would pair the last row of a level with the next level's
    // first (or, at the last level, with no row)
    const bool pairs = (entries & 1) == 0;
    float v[8][F];
    corner_pair<F>(tables, row, 0, 1, pairs, v);
    corner_pair<F>(tables, row, 2, 4, pairs, v);
    corner_pair<F>(tables, row, 3, 5, pairs, v);
    corner_pair<F>(tables, row, 6, 7, pairs, v);
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += v[c][f] * w[c];
    }
    store<F>(staged + t.pp * Tile::kCols, t.j, acc);
  }
  __syncthreads();
  store_tile<F>(staged, out, t, n, levels, vec);
}

// Kernel 7: a warp per level of 32 consecutive points (warp_point). A run
// is consecutive lanes whose 8 corner rows all agree; the voxel fixes them,
// but not its floor alone: at an integral scaled coordinate span = 0 puts
// the ceil-side corners on the floor's vertex, so such a lane (all its
// weights 0) never joins its neighbours' run. The run sums its 8F weighted
// cotangents (sum_runs) and its first lane adds each corner's F sums with
// one F-wide atomic (scalar, float2, one or two float4; rows are F floats,
// so aligned to F*4 bytes): corners of one point on one row still
// accumulate.
template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_corner_bwd_kernel(const float* __restrict__ g, const float* __restrict__ coords,
                           const float* __restrict__ res, float* __restrict__ dtables, int n,
                           int levels, int entries) {
  int l, p;
  if (!warp_point(n, levels, &l, &p)) return;
  const bool valid = p < n;
  // corner c's feature f at c*F + f
  float v[8 * F];
  size_t row[8];
  if (valid) {
    const float r = __ldg(res + l);
    Axis a[3];
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
      a[axis] = axis_geometry(__ldg(coords + 3 * static_cast<size_t>(p) + axis), r);
    }
    float gv[F];
    load<F>(g, static_cast<size_t>(p) * levels + l, gv);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float w = corner_of(a, c, l, entries, &row[c]);
#pragma unroll
      for (int f = 0; f < F; ++f) v[c * F + f] = w == 0.f ? 0.f : __fmul_rn(gv[f], w);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) row[c] = ~static_cast<size_t>(0);  // no row's: runs of their own
#pragma unroll
    for (int e = 0; e < 8 * F; ++e) v[e] = 0.f;
  }
  // rows of one level differ by less than 2^32: the low words tell them apart
  bool starts = false;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t mine = static_cast<uint32_t>(row[c]);
    starts |= mine != __shfl_up_sync(kFull, mine, 1);
  }
  if (!sum_runs(starts, v) || !valid) return;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float* dst = dtables + row[c] * F;
    if constexpr (F == 1) {
      add1(dst, v + c);
    } else if constexpr (F == 2) {
      add2(dst, v + 2 * c);
    } else {
#pragma unroll
      for (int q = 0; q < F / 4; ++q) add4(dst + 4 * q, v + c * F + 4 * q);
    }
  }
}

// --------------------------------------------------------------------------
// voxel-packed layout, F features a corner, 8 corners a row

// Whether corner c (the reference's order) sits on the ceil side of `axis`;
// a constant once the corner loops are unrolled, so the weights stay in
// registers.
__host__ __device__ constexpr int corner_bit(int c, int axis) {
  return axis == 0 ? (c == 1 || c == 4 || c == 5 || c == 7)
         : axis == 1 ? (c == 2 || c == 4 || c == 6 || c == 7)
                     : (c == 3 || c == 5 || c == 6 || c == 7);
}

// One (point, level) of the packed layout: the row's float offset in the
// table and the 8 corner weights in the reference's order.
struct Packed {
  size_t row;
  float w[8];
};

__device__ __forceinline__ Packed packed_of(const float* __restrict__ coords,
                                            const float* __restrict__ res,
                                            const float* __restrict__ off, int p, int l,
                                            int rows, int feat) {
  Packed k;
  const float r = __ldg(res + l);
  const float o = __ldg(off + l);
  float wa[3][2];
  uint32_t h = 0;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const float scaled = __fmaf_rn(__ldg(coords + 3 * static_cast<size_t>(p) + axis), r, o);
    const float v = floorf(scaled);
    const float span = ceilf(scaled) - v;
    const float frac = scaled - v;
    wa[axis][0] = span - frac;
    wa[axis][1] = frac;
    h ^= lattice_bits(v) * kPrimes[axis];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wxy = __fmul_rn(wa[0][corner_bit(c, 0)], wa[1][corner_bit(c, 1)]);
    k.w[c] = __fmul_rn(wxy, wa[2][corner_bit(c, 2)]);
  }
  const size_t packed_row = static_cast<size_t>(l) * rows + (h & static_cast<uint32_t>(rows - 1));
  k.row = packed_row * 8 * feat;
  return k;
}

// Kernel 8: the level-group-major walk (fwd_tile), as kernel 6, in groups
// of 64 output bytes (G = 8 at F = 2): a packed row is read whole, two
// 32-byte sectors of the table a (point, level), and on the NGP batch and
// a render chunk, 32 MB of live tables cost less than the 32-byte groups'
// second pass over the coordinates and the output rows (PERF.md section 6).
// Each lane reads its row as 2F float4 vectors.
template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_fold_fwd_kernel(const float* __restrict__ tables, const float* __restrict__ coords,
                         const float* __restrict__ res, const float* __restrict__ off,
                         float* __restrict__ out, int n, int levels, int rows, bool vec) {
  using Tile = FwdTile<F, kFoldGroupBytes>;
  __shared__ __align__(16) float staged[Tile::kPoints * Tile::kCols];
  const Tile t = fwd_tile<Tile>(n);
  const int l = t.l0 + t.j;
  const int p = t.p0 + t.pp;
  if (l < levels && p < n) {
    const Packed k = packed_of(coords, res, off, p, l, rows, F);
    const float4* row = reinterpret_cast<const float4*>(tables + k.row);
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
    // the row's 8F floats in corner order, four at a time: element e is
    // corner e / F, feature e % F
#pragma unroll
    for (int q = 0; q < 2 * F; ++q) {
      const float4 x = __ldg(row + q);
      const float e4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 4 * q + j;
        acc[e % F] += e4[j] * k.w[e / F];
      }
    }
    store<F>(staged + t.pp * Tile::kCols, t.j, acc);
  }
  __syncthreads();
  store_tile<F>(staged, out, t, n, levels, vec);
}

// Kernel 9: a warp per level of 32 consecutive points (warp_point; the
// block's 8 warps take neighbouring levels of one window, so they share its
// coordinates and its rows of g in L1). A ray's samples come one after
// another, so on the coarse levels neighbouring lanes often fall in the
// same voxel and so the same packed row: each run of lanes with equal rows
// sums its 8F weighted cotangents (sum_runs), and the run's first lane adds
// the sums to the row with 2F float4 atomics.
template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_fold_bwd_kernel(const float* __restrict__ g, const float* __restrict__ coords,
                         const float* __restrict__ res, const float* __restrict__ off,
                         float* __restrict__ dtables, int n, int levels, int rows) {
  int l, p;
  if (!warp_point(n, levels, &l, &p)) return;
  const bool valid = p < n;
  // corner c's feature f at c*F + f, as in the packed row
  float v[8 * F];
  size_t row = 0;
  uint32_t key = kFull;  // never a row's: lanes past n form runs of their own
  if (valid) {
    const Packed k = packed_of(coords, res, off, p, l, rows, F);
    float gv[F];
    load<F>(g, static_cast<size_t>(p) * levels + l, gv);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int f = 0; f < F; ++f) v[c * F + f] = k.w[c] == 0.f ? 0.f : __fmul_rn(gv[f], k.w[c]);
    row = k.row;
    // rows of one level differ by less than 2^32 floats: the low word
    // tells them apart
    key = static_cast<uint32_t>(row);
  } else {
#pragma unroll
    for (int e = 0; e < 8 * F; ++e) v[e] = 0.f;
  }
  if (!sum_runs(key != __shfl_up_sync(kFull, key, 1), v) || !valid) return;
#pragma unroll
  for (int q = 0; q < 2 * F; ++q) add4(dtables + row + 4 * q, v + 4 * q);
}

dim3 grid_for(int n, int levels) {
  const size_t threads = static_cast<size_t>(n) * levels;
  return dim3(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
}

// the backwards: one warp per (window of 32 points, level)
dim3 warp_grid_for(int n, int levels) { return grid_for((n + 31) / 32 * 32, levels); }

template <template <int> class Launch, typename... Args>
int by_feat(int feat, Args... args) {
  switch (feat) {
    case 1: return Launch<1>::run(args...);
    case 2: return Launch<2>::run(args...);
    case 4: return Launch<4>::run(args...);
    case 8: return Launch<8>::run(args...);
    case 16: return Launch<16>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the forwards: one block per (level group, tile of points), the group
// varying slowest
template <class Tile>
dim3 fwd_grid_for(int n, int levels) {
  const unsigned groups = (levels + Tile::kLevels - 1) / Tile::kLevels;
  return dim3(groups * ((static_cast<unsigned>(n) + Tile::kPoints - 1) / Tile::kPoints));
}

// float4 stores of the staged tiles: every point's columns aligned to 16 bytes
bool vec_stores(const float* out, int levels, int feat) {
  return (levels * feat) % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <int F>
struct CornerFwd {
  static int run(const float* tables, const float* coords, const float* res, float* out, int n,
                 int levels, int entries, cudaStream_t stream) {
    hash_corner_fwd_kernel<F><<<fwd_grid_for<FwdTile<F, kCornerGroupBytes>>(n, levels), kThreads, 0, stream>>>(
        tables, coords, res, out, n, levels, entries, vec_stores(out, levels, F));
    return static_cast<int>(cudaGetLastError());
  }
};

template <int F>
struct CornerBwd {
  static int run(const float* g, const float* coords, const float* res, float* dtables, int n,
                 int levels, int entries, cudaStream_t stream) {
    hash_corner_bwd_kernel<F><<<warp_grid_for(n, levels), kThreads, 0, stream>>>(
        g, coords, res, dtables, n, levels, entries);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int F>
struct FoldFwd {
  static int run(const float* tables, const float* coords, const float* res, const float* off,
                 float* out, int n, int levels, int rows, cudaStream_t stream) {
    hash_fold_fwd_kernel<F><<<fwd_grid_for<FwdTile<F, kFoldGroupBytes>>(n, levels), kThreads, 0, stream>>>(
        tables, coords, res, off, out, n, levels, rows, vec_stores(out, levels, F));
    return static_cast<int>(cudaGetLastError());
  }
};

template <int F>
struct FoldBwd {
  static int run(const float* g, const float* coords, const float* res, const float* off,
                 float* dtables, int n, int levels, int rows, cudaStream_t stream) {
    hash_fold_bwd_kernel<F><<<warp_grid_for(n, levels), kThreads, 0, stream>>>(
        g, coords, res, off, dtables, n, levels, rows);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" {

const char* hash_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launches on `stream` and returns the cudaError_t of the launch (0 on
// success). n > 0 points; `bricks` and `rows` powers of two; feat in {1, 2,
// 4, 8} for the corner layout, {1, 2, 4, 8, 16} for the packed layout;
// `tables` of the packed layout and every `dtables` 16-byte aligned.

int hash_brick_fwd(const float* tables, const float* coords, const float* res, float* out, int n,
                   int levels, int bricks, void* stream) {
  hash_brick_fwd_kernel<<<grid_for(n, levels), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tables, coords, res, out, n, levels, bricks);
  return static_cast<int>(cudaGetLastError());
}

int hash_brick_bwd(const float* g, const float* coords, const float* res, float* dtables, int n,
                   int levels, int bricks, void* stream) {
  hash_brick_bwd_kernel<<<warp_grid_for(n, levels), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, coords, res, dtables, n, levels, bricks);
  return static_cast<int>(cudaGetLastError());
}

int hash_corner_fwd(const float* tables, const float* coords, const float* res, float* out, int n,
                    int levels, int entries, int feat, void* stream) {
  return by_feat<CornerFwd>(feat, tables, coords, res, out, n, levels, entries,
                            static_cast<cudaStream_t>(stream));
}

int hash_corner_bwd(const float* g, const float* coords, const float* res, float* dtables, int n,
                    int levels, int entries, int feat, void* stream) {
  return by_feat<CornerBwd>(feat, g, coords, res, dtables, n, levels, entries,
                            static_cast<cudaStream_t>(stream));
}

int hash_fold_fwd(const float* tables, const float* coords, const float* res, const float* off,
                  float* out, int n, int levels, int rows, int feat, void* stream) {
  return by_feat<FoldFwd>(feat, tables, coords, res, off, out, n, levels, rows,
                          static_cast<cudaStream_t>(stream));
}

int hash_fold_bwd(const float* g, const float* coords, const float* res, const float* off,
                  float* dtables, int n, int levels, int rows, int feat, void* stream) {
  return by_feat<FoldBwd>(feat, g, coords, res, off, dtables, n, levels, rows,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
