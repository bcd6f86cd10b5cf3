// TensoRF's vector-matrix (VM) encode on Hopper, forward and backward.
//
// Replaces no TPU kernel: the JAX package has no TensoRF field. Added for
// the port's `tensorf` preset (Chen et al., "TensoRF: Tensorial Radiance
// Fields", ECCV 2022, arXiv:2203.09507, section 4, model VM-192), whose
// encode is the heaviest memory work of its train step.
//
// What it computes, for every point x^ (normalised to [-1, 1]^3 by the
// caller) and every plane m in {0, 1, 2}, with plane axes (a, b) = (0, 1),
// (0, 2), (1, 2) and line axes c = 2, 1, 0:
//   P_m,r = the bilinear sample of plane m at (x^_a, x^_b), component r,
//   v_m,r = the linear sample of line m at x^_c, component r,
// both as grid_sample(align_corners=True) takes them: u = (x^ + 1) / 2 *
// (R - 1) texels along an axis of R texels, so -1 and +1 fall on the edge
// texels. The density output is f = sum over m and the C_d density
// components of P * v; the appearance output holds the 3 * C_a products
// P * v of the appearance factors, plane-major (index m * C_a + r). A point
// with any |x^| > 1 gives f = 0 and zero products. The backward takes the
// cotangents of both outputs and adds, for each point, w_tap * v * g into
// the four plane texels around it and w_tap * P * g into the two line
// texels, into zeroed f32 gradients of all twelve factors (no gradient
// reaches the points).
//
// Layout: plane m is (R_b, R_a, C) row-major, components fastest (texel
// (j_b, i_a) at ((j_b * R_a) + i_a) * C); line m is (R_c, C). The density
// and appearance factors are separate tensors (C_d and C_a components).
//
// Bound on an H100 SXM: bytes. At the tensorf_vm.train cell's shape (4096
// rays x 800 samples = 3,276,800 points, R = 300, C_d = 16, C_a = 48) a
// point's least traffic is its 12 bytes in, 4 bytes of f and 144 bf16
// products out (304 bytes), and the same again for the backward (the
// cotangents in): 2.0 GB a step, plus the factors (69.35 MB) read by each
// pass and their gradients (69.35 MB) written once, ~0.67 ms at 3.35 TB/s.
// Each point gathers 4 plane texels and 2 line texels of 64 components in
// each of the three planes (4.6 KB), ~15 GB of gathers a pass, which the
// caches have to serve: the factors (69 MB) do not all fit in the 50 MB L2,
// but neighbouring samples on a ray, 0.5 texel apart, read the same texels.
//
// Design: each chunk of kChunk consecutive points (the samples of one ray,
// in order) is walked, one point at a time, by ceil((C_d + C_a) / 32)
// warps: lane l of the chunk's warp g takes component 32 g + l of the 64
// (density first, then appearance; two warps a chunk at the cell's sizes),
// so that each tap of a plane or line is read by a warp as one run of
// contiguous floats and each product is written as one contiguous run;
// consecutive points re-read their texels from L1. The density sum is a
// reduction over the first warp of a chunk, which holds the C_d <= 32
// density components. The backward walks the same way and keeps, per
// plane and per line, the sums of the cell (the 2 x 2 texels) or segment
// (2 texels) its last points fell in, in registers; it adds them to device
// memory with one atomic a texel and component only when the next point
// leaves the cell, and at the end of the chunk. Along a ray, 2 to 10
// points fall in one cell, so that many fewer atomics reach L2. Their
// order changes from run to run, so a relaunch differs by f32 rounding.
//
// Precision: everything in f32; the products written in f32 or bf16
// (rounded to nearest even), the cotangents read in the same type. u is
// taken with __fmul_rn / __fadd_rn so that it is never contracted into an
// FMA, as grid_sample computes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;  // consecutive points a warp walks

struct Factors {
  const float* plane[2][3];  // [density, appearance][m]: (R_b, R_a, C)
  const float* line[2][3];   // (R_c, C)
};

struct Grads {
  float* plane[2][3];
  float* line[2][3];
};

struct Grid {
  int res[3];    // texels along x, y, z, each >= 2
  int comps[2];  // components of a density (<= 32) and an appearance factor
  int groups;    // warps a chunk: ceil((C_d + C_a) / 32)
};

// plane m spans axes (a, b); its line runs along c
__host__ __device__ constexpr int plane_a(int m) { return m == 2 ? 1 : 0; }
__host__ __device__ constexpr int plane_b(int m) { return m == 0 ? 1 : 2; }
__host__ __device__ constexpr int line_c(int m) { return 2 - m; }

// One axis: the lower texel of the pair around u and the weight of the upper
// one; i is clamped to [0, R - 2], so u = R - 1 (x^ = +1) gives i = R - 2 and
// f = 1.
struct Axis {
  int i;
  float f;
};

__device__ __forceinline__ Axis axis_of(float x, int r) {
  const float u = __fmul_rn(__fmul_rn(__fadd_rn(x, 1.f), 0.5f), static_cast<float>(r - 1));
  const int i = min(max(static_cast<int>(floorf(u)), 0), r - 2);
  return {i, __fsub_rn(u, static_cast<float>(i))};
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// This warp's chunk of points and this lane's component: warp w takes chunk
// w / groups and components 32 (w % groups) + lane of the C_d + C_a; kind 0
// (density, component k), 1 (appearance, k - C_d) or -1 (none).
struct Slot {
  size_t first, last;
  int kind, comp;
  bool sums_density;  // the warp holding the density components writes f
  __device__ __forceinline__ Slot(const Grid& g, int n) {
    const size_t warp = static_cast<size_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    const int group = static_cast<int>(warp % g.groups);
    first = (warp / g.groups) * kChunk;
    const size_t end = first + kChunk;
    last = end < static_cast<size_t>(n) ? end : static_cast<size_t>(n);
    const int k = static_cast<int>(threadIdx.x & 31) + 32 * group;
    kind = k < g.comps[0] ? 0 : (k < g.comps[0] + g.comps[1] ? 1 : -1);
    comp = kind == 0 ? k : k - g.comps[0];
    sums_density = group == 0;
  }
};

// The point's geometry: its three axes, and whether it lies in the box.
struct Point {
  Axis ax[3];
  bool inside;
};

__device__ __forceinline__ Point point_of(const float* __restrict__ xhat, size_t p, const Grid& g) {
  Point pt;
  const float x0 = __ldg(xhat + 3 * p), x1 = __ldg(xhat + 3 * p + 1), x2 = __ldg(xhat + 3 * p + 2);
  pt.inside = fabsf(x0) <= 1.f && fabsf(x1) <= 1.f && fabsf(x2) <= 1.f;
  pt.ax[0] = axis_of(x0, g.res[0]);
  pt.ax[1] = axis_of(x1, g.res[1]);
  pt.ax[2] = axis_of(x2, g.res[2]);
  return pt;
}

// Plane m's bilinear weights of its texels (j_b, i_a), (j_b, i_a + 1),
// (j_b + 1, i_a), (j_b + 1, i_a + 1), and the first texel's index.
template <int M>
__device__ __forceinline__ int plane_cell(const Point& pt, const Grid& g, float (&w)[4]) {
  const float fa = pt.ax[plane_a(M)].f, fb = pt.ax[plane_b(M)].f;
  w[0] = (1.f - fa) * (1.f - fb);
  w[1] = fa * (1.f - fb);
  w[2] = (1.f - fa) * fb;
  w[3] = fa * fb;
  return pt.ax[plane_b(M)].i * g.res[plane_a(M)] + pt.ax[plane_a(M)].i;
}

// The plane and line samples of one component: `plane` and `line` point at
// component r of texel 0 of their factor, C components a texel.
__device__ __forceinline__ float plane_sample(const float* __restrict__ plane, int cell, int ra, int c,
                                              const float (&w)[4]) {
  const float* t = plane + static_cast<size_t>(cell) * c;
  const size_t row = static_cast<size_t>(ra) * c;
  return w[0] * __ldg(t) + w[1] * __ldg(t + c) + w[2] * __ldg(t + row) + w[3] * __ldg(t + row + c);
}

__device__ __forceinline__ float line_sample(const float* __restrict__ line, int seg, int c, float f) {
  const float* t = line + static_cast<size_t>(seg) * c;
  return (1.f - f) * __ldg(t) + f * __ldg(t + c);
}

// The lane's plane and line sample of plane m (a valid slot only).
template <int M>
__device__ __forceinline__ void samples(const Factors& fac, const Grid& g, const Slot& s, int cell, int seg,
                                        const float (&w)[4], float fc, float* pv, float* lv) {
  const bool d = s.kind == 0;
  const int c = d ? g.comps[0] : g.comps[1];
  *pv = plane_sample((d ? fac.plane[0][M] : fac.plane[1][M]) + s.comp, cell, g.res[plane_a(M)], c, w);
  *lv = line_sample((d ? fac.line[0][M] : fac.line[1][M]) + s.comp, seg, c, fc);
}

template <int M, typename T>
__device__ __forceinline__ void fwd_plane(const Factors& fac, const Grid& g, const Slot& s, const Point& pt,
                                          T* __restrict__ app_row, float* dens) {
  if (s.kind < 0) return;
  float w[4], pv, lv;
  const int cell = plane_cell<M>(pt, g, w);
  samples<M>(fac, g, s, cell, pt.ax[line_c(M)].i, w, pt.ax[line_c(M)].f, &pv, &lv);
  if (s.kind == 0) {
    *dens += pv * lv;
  } else {
    app_row[M * g.comps[1] + s.comp] = from_float<T>(pv * lv);
  }
}

// Forward: f (N,) f32 and the appearance products (N, 3 C_a) in T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    vm_encode_fwd_kernel(Factors fac, Grid g, const float* __restrict__ xhat, float* __restrict__ sigma_feat,
                         T* __restrict__ app, int n) {
  const Slot s(g, n);
  if (s.first >= static_cast<size_t>(n)) return;
  const int width = 3 * g.comps[1];
  for (size_t p = s.first; p < s.last; ++p) {
    const Point pt = point_of(xhat, p, g);
    T* app_row = app + p * width;
    float dens = 0.f;
    if (pt.inside) {
      fwd_plane<0, T>(fac, g, s, pt, app_row, &dens);
      fwd_plane<1, T>(fac, g, s, pt, app_row, &dens);
      fwd_plane<2, T>(fac, g, s, pt, app_row, &dens);
    } else if (s.kind == 1) {
#pragma unroll
      for (int m = 0; m < 3; ++m) app_row[m * g.comps[1] + s.comp] = from_float<T>(0.f);
    }
    if (s.sums_density) {  // warp-uniform
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dens += __shfl_xor_sync(kFull, dens, o);
      if ((threadIdx.x & 31) == 0) sigma_feat[p] = dens;
    }
  }
}

// The backward's sums of one plane and its line, for the cell and segment
// that the warp's last points fell in (-1: none yet).
struct Sums {
  float plane[4] = {0.f, 0.f, 0.f, 0.f};
  float line[2] = {0.f, 0.f};
  int cell = -1;
  int seg = -1;
};

__device__ __forceinline__ void add(float* dst, float v) {
  if (v != 0.f) atomicAdd(dst, v);
}

template <int M>
__device__ __forceinline__ void flush_plane(const Grads& gr, const Grid& g, const Slot& s, Sums& acc) {
  if (acc.cell >= 0 && s.kind >= 0) {
    const int c = s.kind == 0 ? g.comps[0] : g.comps[1];
    float* t = (s.kind == 0 ? gr.plane[0][M] : gr.plane[1][M]) + static_cast<size_t>(acc.cell) * c + s.comp;
    const size_t row = static_cast<size_t>(g.res[plane_a(M)]) * c;
    add(t, acc.plane[0]);
    add(t + c, acc.plane[1]);
    add(t + row, acc.plane[2]);
    add(t + row + c, acc.plane[3]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) acc.plane[q] = 0.f;
}

template <int M>
__device__ __forceinline__ void flush_line(const Grads& gr, const Grid& g, const Slot& s, Sums& acc) {
  if (acc.seg >= 0 && s.kind >= 0) {
    const int c = s.kind == 0 ? g.comps[0] : g.comps[1];
    float* t = (s.kind == 0 ? gr.line[0][M] : gr.line[1][M]) + static_cast<size_t>(acc.seg) * c + s.comp;
    add(t, acc.line[0]);
    add(t + c, acc.line[1]);
  }
  acc.line[0] = acc.line[1] = 0.f;
}

template <int M, typename T>
__device__ __forceinline__ void bwd_plane(const Factors& fac, const Grads& gr, const Grid& g, const Slot& s,
                                          const Point& pt, float gs, const T* __restrict__ g_row, Sums& acc) {
  float w[4];
  const int cell = plane_cell<M>(pt, g, w);
  const int seg = pt.ax[line_c(M)].i;
  const float fc = pt.ax[line_c(M)].f;
  // warp-uniform: every lane holds the same point
  if (cell != acc.cell) {
    flush_plane<M>(gr, g, s, acc);
    acc.cell = cell;
  }
  if (seg != acc.seg) {
    flush_line<M>(gr, g, s, acc);
    acc.seg = seg;
  }
  if (s.kind < 0) return;
  const float gk = s.kind == 0 ? gs : to_float(g_row[M * g.comps[1] + s.comp]);
  if (gk == 0.f) return;
  float pv, lv;
  samples<M>(fac, g, s, cell, seg, w, fc, &pv, &lv);
  const float gl = gk * lv, gp = gk * pv;
#pragma unroll
  for (int q = 0; q < 4; ++q) acc.plane[q] += w[q] * gl;
  acc.line[0] += (1.f - fc) * gp;
  acc.line[1] += fc * gp;
}

// Backward: the cotangents of f (N,) f32 and of the products (N, 3 C_a) in
// T, added into the twelve zeroed gradients.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    vm_encode_bwd_kernel(Factors fac, Grads gr, Grid g, const float* __restrict__ xhat,
                         const float* __restrict__ g_sigma, const T* __restrict__ g_app, int n) {
  const Slot s(g, n);
  if (s.first >= static_cast<size_t>(n)) return;
  const int width = 3 * g.comps[1];
  Sums a0, a1, a2;
  for (size_t p = s.first; p < s.last; ++p) {
    const Point pt = point_of(xhat, p, g);
    if (!pt.inside) continue;  // warp-uniform
    const float gs = s.kind == 0 ? __ldg(g_sigma + p) : 0.f;
    const T* g_row = g_app + p * width;
    bwd_plane<0, T>(fac, gr, g, s, pt, gs, g_row, a0);
    bwd_plane<1, T>(fac, gr, g, s, pt, gs, g_row, a1);
    bwd_plane<2, T>(fac, gr, g, s, pt, gs, g_row, a2);
  }
  flush_plane<0>(gr, g, s, a0);
  flush_line<0>(gr, g, s, a0);
  flush_plane<1>(gr, g, s, a1);
  flush_line<1>(gr, g, s, a1);
  flush_plane<2>(gr, g, s, a2);
  flush_line<2>(gr, g, s, a2);
}

unsigned blocks_for(int n, int groups) {
  const unsigned warps = (static_cast<unsigned>(n) + kChunk - 1) / kChunk * groups;
  return (warps + kWarps - 1) / kWarps;
}

Factors factors_of(const void* const* ptrs) {
  Factors f;
  for (int kind = 0; kind < 2; ++kind) {
    for (int m = 0; m < 3; ++m) {
      f.plane[kind][m] = static_cast<const float*>(ptrs[6 * kind + m]);
      f.line[kind][m] = static_cast<const float*>(ptrs[6 * kind + 3 + m]);
    }
  }
  return f;
}

// The grid of `dims` (R_x, R_y, R_z, C_d, C_a); false where the kernels do
// not take it.
bool grid_of(const int* dims, Grid* g) {
  for (int a = 0; a < 3; ++a) g->res[a] = dims[a];
  g->comps[0] = dims[3];
  g->comps[1] = dims[4];
  g->groups = (dims[3] + dims[4] + 31) / 32;
  return dims[0] >= 2 && dims[1] >= 2 && dims[2] >= 2 && dims[3] > 0 && dims[3] <= 32 && dims[4] > 0;
}

}  // namespace

extern "C" {

const char* vm_grid_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// `factors`: 12 device pointers, the density planes m = 0..2, the density
// lines, the appearance planes, the appearance lines; `grads` the same
// order. `dims`: R_x, R_y, R_z (each >= 2), C_d (<= 32), C_a. `app_bf16`:
// the products (and their cotangents) in bf16, else f32. n > 0. Each
// launches on `stream` and returns the cudaError_t of the launch.

int vm_encode_fwd(const void* const* factors, const int* dims, const float* xhat, float* sigma_feat, void* app,
                  int app_bf16, int n, void* stream) {
  Grid g;
  if (!grid_of(dims, &g)) return static_cast<int>(cudaErrorInvalidValue);
  const Factors f = factors_of(factors);
  const auto st = static_cast<cudaStream_t>(stream);
  if (app_bf16) {
    vm_encode_fwd_kernel<__nv_bfloat16><<<blocks_for(n, g.groups), kThreads, 0, st>>>(
        f, g, xhat, sigma_feat, static_cast<__nv_bfloat16*>(app), n);
  } else {
    vm_encode_fwd_kernel<float><<<blocks_for(n, g.groups), kThreads, 0, st>>>(f, g, xhat, sigma_feat,
                                                                              static_cast<float*>(app), n);
  }
  return static_cast<int>(cudaGetLastError());
}

int vm_encode_bwd(const void* const* factors, void* const* grads, const int* dims, const float* xhat,
                  const float* g_sigma, const void* g_app, int app_bf16, int n, void* stream) {
  Grid g;
  if (!grid_of(dims, &g)) return static_cast<int>(cudaErrorInvalidValue);
  const Factors f = factors_of(factors);
  Grads gr;
  for (int kind = 0; kind < 2; ++kind) {
    for (int m = 0; m < 3; ++m) {
      gr.plane[kind][m] = static_cast<float*>(grads[6 * kind + m]);
      gr.line[kind][m] = static_cast<float*>(grads[6 * kind + 3 + m]);
    }
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (app_bf16) {
    vm_encode_bwd_kernel<__nv_bfloat16><<<blocks_for(n, g.groups), kThreads, 0, st>>>(
        f, gr, g, xhat, g_sigma, static_cast<const __nv_bfloat16*>(g_app), n);
  } else {
    vm_encode_bwd_kernel<float><<<blocks_for(n, g.groups), kThreads, 0, st>>>(f, gr, g, xhat, g_sigma,
                                                                              static_cast<const float*>(g_app), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
