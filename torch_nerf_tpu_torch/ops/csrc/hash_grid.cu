// Multiresolution hash-grid encodes on Hopper: the bricked and the
// per-corner table layouts, each forward and backward.
//
// Replaces four Pallas TPU kernels of the JAX package:
//   hash_brick_fwd_kernel  <- torch_nerf_tpu/ops/pallas/hash_brick.py::_fwd_kernel
//                             (reached through _fwd_pallas's pl.pallas_call)
//   hash_brick_bwd_kernel  <- hash_brick.py::_bwd_kernel (through _bwd_pallas)
//   hash_corner_fwd_kernel <- torch_nerf_tpu/ops/pallas/hash_corner.py::_fwd_kernel
//                             (through _fwd_pallas)
//   hash_corner_bwd_kernel <- hash_corner.py::_bwd_kernel (through _bwd_pallas)
//
// Both encodes blend, for every (point, level), the 8 trilinear lattice
// sites of the point's voxel, F features each, into out[point, level*F + f]
// (level-major, feature-minor: an (N, L*F) f32 array). They differ only in
// where a site's features live:
//   * bricked: one Teschner hash of the brick b = floor(floor(res*x) / 3)
//     per axis picks a row of the (L, T_b, 128) table, T_b a power of two;
//     the row holds 4^3 sites x F = 2 (lane ((sx*4 + sy)*4 + sz)*F + f),
//     and the voxel's 8 sites are local = v - 3b and local + 1 per axis;
//   * corner: each of the 8 corners hashes on its own into the (L, T, F)
//     table, row = the non-negative remainder of the int32-reinterpreted
//     hash mod T (a bitwise AND when T is a power of two).
// The weights are the JAX package's, in f32: scaled = x*res, v = floor,
// span = ceil - v, frac = scaled - v; per axis span - frac at the floor site
// and frac at the ceil site (bricked, brick_prep's select form), or
// |opposite - scaled| (corner, hash_encode's form); at an integral scaled
// coordinate span is 0 and every weight vanishes (the reference's quirk).
// x*res is taken with __fmul_rn so that it is never fused into the
// subtraction that follows, and v / 3 is an IEEE division (the build has no
// --use_fast_math).
//
// The backward scatter-adds g[point, level*F + f] * w into a zeroed f32
// table gradient with atomicAdd, skipping zero weights; corners of one point
// that share a row, and the many points of a coarse level, accumulate. The
// order of those sums changes from run to run. No gradient reaches the
// coordinates or the resolutions, as in the JAX package's custom_vjp.
//
// Bound on an H100 SXM: bytes. Each (point, level) does ~60 flops against
// a data-dependent gather of 8 x F floats from a 64 MiB table that does not
// fit in the 50 MB L2; counting each input once, one encode of 2^20 points
// moves the table (67.1 MB), the coordinates (12.6 MB) and the output or
// its cotangent (134.2 MB). Design: one thread per (point, level) with the
// level varying fastest, so a warp's loads of the coordinates broadcast and
// its F-wide stores fill whole output rows; the brick reads only the 4 runs
// of 2 sites x F floats that carry weight, not its 128-float row. Vector
// atomics, warp pre-reduction on coarse levels and a deterministic
// sort-based scatter are left for later work.

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

}  // namespace

extern "C" {

const char* hash_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launches on `stream` and returns the cudaError_t of the launch (0 on
// success). n > 0 points; `bricks` a power of two; feat in {1, 2, 4, 8}.

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

}  // extern "C"
