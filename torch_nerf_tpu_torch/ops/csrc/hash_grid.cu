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
// The backward scatter-adds g[point, level*F + f] * w into a zeroed f32
// table gradient with atomicAdd, skipping zero weights; corners of one point
// that share a row, and the many points of a coarse level, accumulate. The
// order of those sums changes from run to run. No gradient reaches the
// coordinates, the resolutions or the offsets, as in the JAX package's
// custom_vjp. The packed backward (kernel 9) first sums, within a warp of
// 32 consecutive points of one level, the points that share a packed row,
// and adds each row's sums with float4 atomics (sm_90's vector atomicAdd):
// 2F atomics a run of points where the scalar form took up to 8F a point.
//
// Bound on an H100 SXM: bytes. Each (point, level) does ~60 flops against
// a data-dependent gather of 8 x F floats from a 64 MiB table that does not
// fit in the 50 MB L2; counting each input once, one encode of 2^20 points
// moves the table (67.1 MB, twice that for the dual layout), the
// coordinates (12.6 MB) and the output or its cotangent (134.2 MB at L*F =
// 32). Design: one thread per (point, level) with the level varying
// fastest, so a warp's loads of the coordinates broadcast and its F-wide
// stores fill whole output rows; the brick reads only the 4 runs of 2
// sites x F floats that carry weight, not its 128-float row; the packed row
// is read whole, being all weight. The bricked and per-corner backwards
// keep one thread per (point, level) and scalar atomics; the packed one
// runs point-fastest with the warp pre-reduction above. A deterministic
// sort-based scatter is left for later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
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

__global__ void __launch_bounds__(kThreads)
    hash_brick_bwd_kernel(const float* __restrict__ g, const float* __restrict__ coords,
                          const float* __restrict__ res, float* __restrict__ dtables, int n,
                          int levels, int bricks) {
  constexpr int F = 2;
  const size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (i >= static_cast<size_t>(n) * levels) return;
  const int p = static_cast<int>(i / levels);
  const int l = static_cast<int>(i % levels);
  const Brick k = brick_of(coords, res, p, l, bricks);
  float gv[F];
  load<F>(g, i, gv);
  float* row = dtables + k.row;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wxy = __fmul_rn(k.w[0][dx], k.w[1][dy]);
      const int site = ((k.site[0] + dx) * kBrickEdge + k.site[1] + dy) * kBrickEdge + k.site[2];
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const float w = __fmul_rn(wxy, k.w[2][dz]);
        if (w == 0.f) continue;
#pragma unroll
        for (int f = 0; f < F; ++f) atomicAdd(row + (site + dz) * F + f, __fmul_rn(gv[f], w));
      }
    }
  }
}

// --------------------------------------------------------------------------
// corner layout, F features a row

template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_corner_fwd_kernel(const float* __restrict__ tables, const float* __restrict__ coords,
                           const float* __restrict__ res, float* __restrict__ out, int n,
                           int levels, int entries) {
  const size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (i >= static_cast<size_t>(n) * levels) return;
  const int p = static_cast<int>(i / levels);
  const int l = static_cast<int>(i % levels);
  const float r = __ldg(res + l);
  Axis a[3];
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    a[axis] = axis_geometry(__ldg(coords + 3 * static_cast<size_t>(p) + axis), r);
  }
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    size_t row;
    const float w = corner_of(a, c, l, entries, &row);
    float v[F];
    load<F>(tables, row, v);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += v[f] * w;
  }
  store<F>(out, i, acc);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_corner_bwd_kernel(const float* __restrict__ g, const float* __restrict__ coords,
                           const float* __restrict__ res, float* __restrict__ dtables, int n,
                           int levels, int entries) {
  const size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (i >= static_cast<size_t>(n) * levels) return;
  const int p = static_cast<int>(i / levels);
  const int l = static_cast<int>(i % levels);
  const float r = __ldg(res + l);
  Axis a[3];
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    a[axis] = axis_geometry(__ldg(coords + 3 * static_cast<size_t>(p) + axis), r);
  }
  float gv[F];
  load<F>(g, i, gv);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    size_t row;
    const float w = corner_of(a, c, l, entries, &row);
    if (w == 0.f) continue;
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(dtables + row * F + f, __fmul_rn(gv[f], w));
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

template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_fold_fwd_kernel(const float* __restrict__ tables, const float* __restrict__ coords,
                         const float* __restrict__ res, const float* __restrict__ off,
                         float* __restrict__ out, int n, int levels, int rows) {
  const size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (i >= static_cast<size_t>(n) * levels) return;
  const int p = static_cast<int>(i / levels);
  const int l = static_cast<int>(i % levels);
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
  store<F>(out, i, acc);
}

// Kernel 9: warp = one level of a window of 32 consecutive points, lane =
// point (the block's 8 warps take neighbouring levels of one window, so
// they share its coordinates and its rows of g in L1). A ray's samples come
// one after another, so on the coarse levels neighbouring lanes often fall
// in the same voxel and so the same packed row: each run of lanes with
// equal rows sums its 8F weighted cotangents by a segmented shuffle scan
// (as many steps as the warp's longest run needs), and the run's first
// lane adds the sums to the row with 2F float4 atomics, skipping a float4
// whose four sums are all zero (a corner of zero weight contributes an
// exact zero, as the scalar kernel skipped it). Lanes past n take part in
// the shuffles with zeros and issue nothing.
template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_fold_bwd_kernel(const float* __restrict__ g, const float* __restrict__ coords,
                         const float* __restrict__ res, const float* __restrict__ off,
                         float* __restrict__ dtables, int n, int levels, int rows) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const size_t warp = (blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x) >> 5;
  if (warp >= static_cast<size_t>((n + 31) / 32) * levels) return;  // warp-uniform
  const int l = static_cast<int>(warp % levels);
  const int p = static_cast<int>(warp / levels) * 32 + lane;
  const bool valid = p < n;

  // corner c's feature f at c*F + f, as in the packed row
  float v[8 * F];
  size_t row = 0;
  uint32_t key = 0xffffffffu;  // never a row's: lanes past n form runs of their own
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

  // runs of equal keys among consecutive lanes; run_end: the run's last lane
  const uint32_t prev = __shfl_up_sync(kFull, key, 1);
  const bool head = lane == 0 || key != prev;
  const uint32_t heads = __ballot_sync(kFull, head);
  const uint32_t later = lane == 31 ? 0u : heads & (kFull << (lane + 1));
  const int run_end = later ? __ffs(later) - 2 : 31;
  const unsigned longest = __reduce_max_sync(kFull, static_cast<unsigned>(run_end - lane + 1));
  // after the step of offset o, lane i holds the sum over [i, min(i + 2o - 1, run_end)]
  for (int o = 1; o < static_cast<int>(longest); o <<= 1) {
    const bool take = lane + o <= run_end;
#pragma unroll
    for (int e = 0; e < 8 * F; ++e) {
      const float u = __shfl_down_sync(kFull, v[e], o);
      if (take) v[e] += u;
    }
  }
  if (!head || !valid) return;
  float4* dst = reinterpret_cast<float4*>(dtables + row);
#pragma unroll
  for (int q = 0; q < 2 * F; ++q) {
    const float4 s = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    if (s.x != 0.f || s.y != 0.f || s.z != 0.f || s.w != 0.f) atomicAdd(dst + q, s);
  }
}

dim3 grid_for(int n, int levels) {
  const size_t threads = static_cast<size_t>(n) * levels;
  return dim3(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
}

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

template <int F>
struct CornerFwd {
  static int run(const float* tables, const float* coords, const float* res, float* out, int n,
                 int levels, int entries, cudaStream_t stream) {
    hash_corner_fwd_kernel<F><<<grid_for(n, levels), kThreads, 0, stream>>>(
        tables, coords, res, out, n, levels, entries);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int F>
struct CornerBwd {
  static int run(const float* g, const float* coords, const float* res, float* dtables, int n,
                 int levels, int entries, cudaStream_t stream) {
    hash_corner_bwd_kernel<F><<<grid_for(n, levels), kThreads, 0, stream>>>(
        g, coords, res, dtables, n, levels, entries);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int F>
struct FoldFwd {
  static int run(const float* tables, const float* coords, const float* res, const float* off,
                 float* out, int n, int levels, int rows, cudaStream_t stream) {
    hash_fold_fwd_kernel<F><<<grid_for(n, levels), kThreads, 0, stream>>>(
        tables, coords, res, off, out, n, levels, rows);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int F>
struct FoldBwd {
  static int run(const float* g, const float* coords, const float* res, const float* off,
                 float* dtables, int n, int levels, int rows, cudaStream_t stream) {
    // one warp per (window of 32 points, level)
    hash_fold_bwd_kernel<F><<<grid_for((n + 31) / 32 * 32, levels), kThreads, 0, stream>>>(
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
// `tables` of the packed layout 16-byte aligned.

int hash_brick_fwd(const float* tables, const float* coords, const float* res, float* out, int n,
                   int levels, int bricks, void* stream) {
  hash_brick_fwd_kernel<<<grid_for(n, levels), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tables, coords, res, out, n, levels, bricks);
  return static_cast<int>(cudaGetLastError());
}

int hash_brick_bwd(const float* g, const float* coords, const float* res, float* dtables, int n,
                   int levels, int bricks, void* stream) {
  hash_brick_bwd_kernel<<<grid_for(n, levels), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
