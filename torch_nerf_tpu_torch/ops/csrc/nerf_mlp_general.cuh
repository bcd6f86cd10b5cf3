// The NeRF MLP's general route on Hopper in f32 on FFMA: the forward
// (kernel 1), its backward (kernel 2) and the train pass's MLP (kernel 3)
// for the f32 configs the tensor-core engine (nerf_mlp_tc.cuh: every bf16
// config off the wgmma presets, f32 at widths F % 64 == 0 up to 256) does
// not hold: any width F % 32 == 0 up to 1024 (the wrapper zero-pads other
// widths to the next multiple of 32), encodings up to 128 columns. Its
// stashes, encode VJP and dW GEMM serve the tensor-core engine too.
//
// Replaces, on those configs, the Pallas TPU kernels torch_nerf_tpu/ops/
// pallas/fused_nerf.py::_fwd_kernel and _bwd_kernel and fused_train.py::
// _train_kernel, which take any width and compute_dtype. The design is the
// training counterpart of the forward's first design, cut as the wgmma
// route is cut (an SM has 227 KB, not a TPU's VMEM):
//
//   forward_kernel  PE + the 11 layers per tile of R points (32, or 16 where
//                   32 rows of the widest layer do not fit in shared
//                   memory), every activation in shared memory; with the
//                   stash, each activation is also copied to device memory,
//                   row-major, by 16-byte vectors.
//   chain_kernel    the backward chain per tile: dz_out from the cotangents,
//                   dh = dz W^T layer by layer down to fc_in, each dh masked
//                   by the stashed activation (act > 0), each dz to the dz
//                   stash; for kernel 2 the cotangents of the encodings to
//                   device memory, then encode_vjp_kernel takes them to dpts
//                   and ddirs.
//   run_dw          dW = A^T dZ and db = sum dZ over the stashes on the
//                   tensor cores (nerf_dw_tc.cuh: TMA-loaded tiles on wgmma,
//                   the slices' partials summed in a fixed order, so two
//                   launches give the same grads bit for bit; no atomics).
//
// Products: FFMA on f32 operands, no TF32: the forward and the chain give
// each thread R/8 rows x 8 columns of a 256-column pass, A read as float4
// along K from shared memory (one address a warp), the weights staged 16
// rows at a time through a two-stage shared-memory ring by cp.async. (The
// bf16 configs ran here on mma.sync until the tensor-core engine's column
// passes took them: PERF.md, section 6.)
//
// Precision: as nerf_apply(compute_dtype=float32): acc + b in f32, no
// rounding between layers, the encode by exact sincosf
// (fused_nerf.py:180-194's f32 path).
//
// Bound on an H100 SXM: 3 x flops_per_point FLOP a point for a train pass
// at 67 TFLOP/s (FFMA). The stashes move (acts + dzs) x 4 bytes a point
// each way; the dW GEMM reads each once from device memory
// (nerf_dw_tc.cuh).
//
// Layout contract with torch_nerf_tpu_torch/ops/fused_nerf.py::
// general_matrices (F the padded width, P, D the encodings padded to 16):
//   w[l]   forward matrix (K, N): fc_in (P, F); fc_5 ([pe P | h4 F], F);
//          fc_8 (F, F + 8), the features in columns [0, F), sigma at F;
//          fc_9 ([features F | de D], F / 2); fc_out (F / 2, 8); others (F, F);
//   wt[l]  chain matrix W^T (N rounded up to 16, K): its rows the forward's
//          columns (fc_8: [features, sigma, 0...], F + 16; fc_out: 16);
//   b[l]   bias (N,); all row-major f32.
// Grads come out in the forward matrices' row order with the dz's columns
// (fc_8: F + 16, fc_out: 16); the wrapper maps them to the public layout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "nerf_dw_tc.cuh"
#include "nerf_mlp_train.cuh"

namespace nerf_general {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
using nerf_train::relu_nan;

constexpr int kLayers = 11;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;   // a block's shared memory
constexpr int kMaxFeat = 1024;
constexpr int kMaxEnc = 128;
constexpr int kPointPad = 64;     // stash rows: m rounded up to this

enum Layer { L_IN = 0, L_1, L_2, L_3, L_4, L_5, L_6, L_7, L_8, L_9, L_OUT };
// stash activations: the encodings, h0..h7 (relu outputs of fc_in..fc_7),
// fc_8's features (no relu) and h9
enum Act { A_PE = 0, A_DE = 1, A_H0 = 2, A_FEAT = 10, A_H9 = 11, kActs = 12 };

struct Dims {
  int feat;  // padded width, % 32 == 0
  int pe_dim, de_dim, pe_pad, de_pad;
  int pos_levels, dir_levels, include_input;
  __host__ __device__ int half() const { return feat / 2; }
  __host__ __device__ int z8() const { return feat + 16; }  // fc_8's dz: features, sigma, zeros
  // width of each activation in the stash
  __host__ __device__ int act_width(int a) const {
    return a == A_PE ? pe_pad : a == A_DE ? de_pad : a == A_H9 ? half() : feat;
  }
  // width of layer l's dz (its dW's columns)
  __host__ __device__ int dz_width(int l) const {
    return l == L_8 ? z8() : l == L_9 ? half() : l == L_OUT ? 16 : feat;
  }
};

struct Net {
  const void* w[kLayers];
  const void* wt[kLayers];
  const void* b[kLayers];
  Dims d;
};

template <class T>
struct Stash {
  T* act[kActs];
  T* dz[kLayers];
  float* sigma;  // (m,)
  float* rgb;    // (m, 3)
};

// ---------------------------------------------------------------------------
// element types

template <class T>
struct Elem;

// bf16: the roundings of nerf_mlp_tc.cuh's bf16 epilogues
template <>
struct Elem<bf16> {
  static __device__ __forceinline__ bf16 from(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  // bf16(bf16(acc) + b) of the column pair: a bf16x2 add rounds the exact
  // sum once, as rounding its f32 sum does
  static __device__ __forceinline__ float2 bias(float v0, float v1, const void* bias, int n) {
    return __bfloat1622float2(bias2(v0, v1, bias, n));
  }
  static __device__ __forceinline__ bf162 bias2(float v0, float v1, const void* bias, int n) {
    const bf162 b2 = *reinterpret_cast<const bf162*>(static_cast<const bf16*>(bias) + n);
    return __hadd2(__floats2bfloat162_rn(v0, v1), b2);
  }
};

template <>
struct Elem<float> {
  static constexpr int kPad = 4;
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float from(float v) { return v; }
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
  static __device__ __forceinline__ float2 bias(float v0, float v1, const void* bias, int n) {
    const float* b = static_cast<const float*>(bias);
    return make_float2(v0 + b[n], v1 + b[n + 1]);
  }
  static __device__ __forceinline__ void store_relu(float* p, float v0, float v1, const void* bias, int n) {
    const float2 y = Elem<float>::bias(v0, v1, bias, n);
    store2(p, relu_nan(y.x), relu_nan(y.y));
  }
};

// a tile's K-segment in shared memory: rows R, k columns, ld elements a row
template <class T>
struct Seg {
  const T* buf;
  int ld;
  int k;
};

// ---------------------------------------------------------------------------
// the product of an R-row tile in shared memory with a weight matrix in L2:
// out (R, n) = [s0 | s1] (R, s0.k + s1.k) x W; epi(r, c, v0, v1) takes the
// f32 sums of row r, columns c and c + 1 (c even)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the f32 product's weight ring at the start of dynamic shared memory: two
// stages of kSliceK rows x kSliceN columns
constexpr int kSliceK = 16;
constexpr int kSliceN = 256;

template <class T>
__host__ __device__ constexpr int stage_bytes() {
  return sizeof(T) == 4 ? 2 * kSliceK * kSliceN * 4 : 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// f32 on FFMA. The weights (K, n) row-major f32 go through the ring, 16
// rows x 256 columns a stage, by cp.async (columns past n read as zeros),
// so every warp reads them from shared memory. Warp y owns rows [y R/8, (y + 1) R/8)
// of each 256-column pass, lane x the columns 4x..4x+3 and 128+4x..128+4x+3.

template <int R, class Epi>
__device__ __forceinline__ void product(Seg<float> s0, Seg<float> s1, const void* w, int n, Epi epi) {
  extern __shared__ __align__(16) unsigned char general_smem[];
  constexpr int RT = R / 8;
  float* ring = reinterpret_cast<float*>(general_smem);
  const float* __restrict__ wm = static_cast<const float*>(w);
  const int ty = threadIdx.x >> 5;
  const int tx = threadIdx.x & 31;
  const int ktotal = s0.k + s1.k;
  const int slices = ktotal / kSliceK;
  for (int c0 = 0; c0 < n; c0 += kSliceN) {
    // slice s of this pass into ring stage s % 2: 16 x 64 float4s, 4 a thread
    auto load = [&](int s) {
      float* dst = ring + (s & 1) * kSliceK * kSliceN;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = threadIdx.x + j * kThreads;
        const int row = idx >> 6;
        const int col = (idx & 63) * 4;
        const bool valid = c0 + col < n;
        const float* src = valid ? wm + static_cast<size_t>(s * kSliceK + row) * n + c0 + col : wm;
        cp_async16(dst + row * kSliceN + col, src, valid);
      }
      cp_async_commit();
    };
    float acc[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    __syncthreads();  // the ring's last readers are done
    load(0);
    for (int s = 0; s < slices; ++s) {
      if (s + 1 < slices) {
        load(s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* bs = ring + (s & 1) * kSliceK * kSliceN;
      const int k = s * kSliceK;
      const bool first = k < s0.k;
      const float* abase = first ? s0.buf + k : s1.buf + (k - s0.k);
      const int ld = first ? s0.ld : s1.ld;
#pragma unroll
      for (int kk = 0; kk < kSliceK; kk += 4) {
        float4 b0[4], b1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b0[j] = *reinterpret_cast<const float4*>(bs + (kk + j) * kSliceN + 4 * tx);
          b1[j] = *reinterpret_cast<const float4*>(bs + (kk + j) * kSliceN + 128 + 4 * tx);
        }
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(abase + (ty * RT + i) * ld + kk);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][0] = fmaf(av[j], b0[j].x, acc[i][0]);
            acc[i][1] = fmaf(av[j], b0[j].y, acc[i][1]);
            acc[i][2] = fmaf(av[j], b0[j].z, acc[i][2]);
            acc[i][3] = fmaf(av[j], b0[j].w, acc[i][3]);
            acc[i][4] = fmaf(av[j], b1[j].x, acc[i][4]);
            acc[i][5] = fmaf(av[j], b1[j].y, acc[i][5]);
            acc[i][6] = fmaf(av[j], b1[j].z, acc[i][6]);
            acc[i][7] = fmaf(av[j], b1[j].w, acc[i][7]);
          }
        }
      }
      __syncthreads();  // stage s % 2 is free for slice s + 2
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 128 * h + 4 * tx;
      if (c >= n) continue;  // n % 4 == 0: a group of 4 is whole or absent
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        epi(ty * RT + i, c, acc[i][4 * h], acc[i][4 * h + 1]);
        epi(ty * RT + i, c + 2, acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tiles

// [x, sin(2^0 x), cos(2^0 x), ...] of the tile's points; rows past m encode
// zeros, columns [dim, dim_pad) are zeroed
template <class T, int R, class Value>
__device__ void encode(Value value, int row0, int m, int levels, int include_input, int dim, int dim_pad,
                       T* out, int ld) {
  const int base = include_input ? 3 : 0;
  for (int i = threadIdx.x; i < R * 3; i += kThreads) {
    const int r = i / 3;
    const int c = i - 3 * r;
    const int gr = row0 + r;
    const float v = gr < m ? value(gr, c) : 0.f;
    T* o = out + r * ld;
    if (include_input) o[c] = Elem<T>::from(v);
    for (int l = 0; l < levels; ++l) {
      float s, co;
      sincosf(v * static_cast<float>(1 << l), &s, &co);
      o[base + 6 * l + c] = Elem<T>::from(s);
      o[base + 6 * l + 3 + c] = Elem<T>::from(co);
    }
  }
  const int extra = dim_pad - dim;
  for (int i = threadIdx.x; i < R * extra; i += kThreads) {
    const int r = i / extra;
    out[r * ld + dim + (i - r * extra)] = Elem<T>::from(0.f);
  }
}

// the tile's R rows of a shared-memory buffer to rows [row0, row0 + R) of a
// row-major (m_pad, width) stash, 16 bytes a thread
template <class T, int R>
__device__ __forceinline__ void copy_out(const T* src, int ld, T* dst, int width, int row0) {
  constexpr int V = Elem<T>::kVec;
  const int per_row = width / V;
  for (int i = threadIdx.x; i < R * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * V;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + r) * width + c) =
        *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

template <class T>
__host__ __device__ inline int row_ld(int width) {
  return width + Elem<T>::kPad;
}

template <class T>
__host__ __device__ inline size_t forward_smem_bytes(const Dims& d, int rows) {
  return static_cast<size_t>(rows) *
             (row_ld<T>(d.pe_pad) + row_ld<T>(d.de_pad) + 2 * row_ld<T>(d.feat)) * sizeof(T) +
         stage_bytes<T>();
}

template <class T>
__host__ __device__ inline size_t chain_smem_bytes(const Dims& d, int rows) {
  return static_cast<size_t>(rows) * 2 * row_ld<T>(d.z8()) * sizeof(T) + stage_bytes<T>();
}

// The forward of one tile: PE + 11 layers, sigma (m,) and rgb (m, 3) out;
// with kStash every activation to the stash as well. At most 128 registers
// a thread, so that two blocks fit an SM: a bound of one block let ptxas
// take the f32 tile from 128 to 164 registers, one block an SM and its
// forward ~25% slower.
template <class T, int R, bool kStash, class In>
__global__ void __launch_bounds__(kThreads, 2)
    forward_kernel(In in, const __grid_constant__ Net net, const __grid_constant__ Stash<T> st, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Dims& d = net.d;
  const int f = d.feat;
  const int ld_pe = row_ld<T>(d.pe_pad), ld_de = row_ld<T>(d.de_pad), ld_h = row_ld<T>(f);
  T* pe = reinterpret_cast<T*>(smem_raw + stage_bytes<T>());
  T* de = pe + R * ld_pe;
  T* ha = de + R * ld_de;
  T* hb = ha + R * ld_h;
  const int row0 = blockIdx.x * R;

  encode<T, R>([&](int i, int c) { return in.pos(i, c); }, row0, m, d.pos_levels, d.include_input, d.pe_dim,
               d.pe_pad, pe, ld_pe);
  encode<T, R>([&](int i, int c) { return in.dir(i, c); }, row0, m, d.dir_levels, d.include_input, d.de_dim,
               d.de_pad, de, ld_de);
  __syncthreads();
  if constexpr (kStash) {
    copy_out<T, R>(pe, ld_pe, st.act[A_PE], d.pe_pad, row0);
    copy_out<T, R>(de, ld_de, st.act[A_DE], d.de_pad, row0);
  }

  const Seg<T> none = {nullptr, 0, 0};
  // relu(bias(in W)) of layer l into out; with the stash, to act slot a
  auto relu_layer = [&](Seg<T> s0, Seg<T> s1, int l, int n, T* out, int a) {
    const void* bias = net.b[l];
    product<R>(s0, s1, net.w[l], n, [&](int r, int c, float v0, float v1) {
      Elem<T>::store_relu(out + r * ld_h + c, v0, v1, bias, c);
    });
    __syncthreads();
    if constexpr (kStash) copy_out<T, R>(out, ld_h, st.act[a], n, row0);
  };
  const Seg<T> s_pe = {pe, ld_pe, d.pe_pad};
  const Seg<T> s_de = {de, ld_de, d.de_pad};
  const Seg<T> s_ha = {ha, ld_h, f};
  const Seg<T> s_hb = {hb, ld_h, f};

  relu_layer(s_pe, none, L_IN, f, ha, A_H0);
  relu_layer(s_ha, none, L_1, f, hb, A_H0 + 1);
  relu_layer(s_hb, none, L_2, f, ha, A_H0 + 2);
  relu_layer(s_ha, none, L_3, f, hb, A_H0 + 3);
  relu_layer(s_hb, none, L_4, f, ha, A_H0 + 4);
  relu_layer(s_pe, s_ha, L_5, f, hb, A_H0 + 5);  // the skip: fc_5 reads [pe, h4]
  relu_layer(s_hb, none, L_6, f, ha, A_H0 + 6);
  relu_layer(s_ha, none, L_7, f, hb, A_H0 + 7);

  // fc_8: the features (no relu) into ha, sigma = relu(column f)
  {
    const void* bias = net.b[L_8];
    product<R>(s_hb, none, net.w[L_8], f + 8, [&](int r, int c, float v0, float v1) {
      const float2 y = Elem<T>::bias(v0, v1, bias, c);
      if (c < f) {
        Elem<T>::store2(ha + r * ld_h + c, y.x, y.y);
      } else if (c == f && row0 + r < m) {
        st.sigma[row0 + r] = relu_nan(y.x);
      }
    });
    __syncthreads();
    if constexpr (kStash) copy_out<T, R>(ha, ld_h, st.act[A_FEAT], f, row0);
  }

  relu_layer(s_ha, s_de, L_9, d.half(), hb, A_H9);  // fc_9 reads [features, de]

  // fc_out -> sigmoid
  {
    const void* bias = net.b[L_OUT];
    const Seg<T> s_h9 = {hb, ld_h, d.half()};
    product<R>(s_h9, none, net.w[L_OUT], 8, [&](int r, int c, float v0, float v1) {
      const float2 y = Elem<T>::bias(v0, v1, bias, c);
      const float v[2] = {y.x, y.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c + e < 3 && row0 + r < m) st.rgb[static_cast<size_t>(row0 + r) * 3 + c + e] = 1.f / (1.f + expf(-v[e]));
      }
    });
  }
}

// The backward chain of one tile, from the stash and the f32 cotangents
// g_sigma (m,), g_rgb (m, 3): every dz to the dz stash; with kInputGrads
// the f32 cotangents of the encodings to dpe (m_pad, pe_pad) and dde
// (m_pad, de_pad).
template <class T, int R, bool kInputGrads>
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const __grid_constant__ Net net, const __grid_constant__ Stash<T> st,
                 const float* __restrict__ g_sigma, const float* __restrict__ g_rgb, float* __restrict__ dpe,
                 float* __restrict__ dde, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Dims& d = net.d;
  const int f = d.feat;
  const int ld = row_ld<T>(d.z8());
  T* ba = reinterpret_cast<T*>(smem_raw + stage_bytes<T>());
  T* bb = ba + R * ld;
  const int row0 = blockIdx.x * R;
  const Seg<T> none = {nullptr, 0, 0};

  // dz_out = dL/d(fc_out) = g_rgb * rgb * (1 - rgb), 16 columns
  for (int i = threadIdx.x; i < R * 16; i += kThreads) {
    const int r = i >> 4;
    const int c = i & 15;
    const int gr = row0 + r;
    float v = 0.f;
    if (c < 3 && gr < m) {
      const float y = st.rgb[static_cast<size_t>(gr) * 3 + c];
      v = g_rgb[static_cast<size_t>(gr) * 3 + c] * y * (1.f - y);
    }
    ba[r * ld + c] = Elem<T>::from(v);
  }
  __syncthreads();
  copy_out<T, R>(ba, ld, st.dz[L_OUT], 16, row0);

  // dz_in = mask(act, round(dz_out W^T)) of a relu layer into out
  auto relu_step = [&](Seg<T> in, int l, int n, T* out, int act, int out_l) {
    const T* a = st.act[act];
    product<R>(in, none, net.wt[l], n, [&](int r, int c, float v0, float v1) {
      const float2 h = Elem<T>::load2(a + static_cast<size_t>(row0 + r) * n + c);
      Elem<T>::store2(out + r * ld + c, h.x > 0.f ? Elem<T>::round(v0) : 0.f,
                      h.y > 0.f ? Elem<T>::round(v1) : 0.f);
    });
    __syncthreads();
    copy_out<T, R>(out, ld, st.dz[out_l], n, row0);
  };

  // fc_out: dz9 = mask(h9, dz_out W^T)
  relu_step(Seg<T>{ba, ld, 16}, L_OUT, d.half(), bb, A_H9, L_9);

  // fc_9: [features, de] <- dz9 W^T; dz8 = [d features, d sigma, 0...]
  product<R>(Seg<T>{bb, ld, d.half()}, none, net.wt[L_9], f + d.de_pad, [&](int r, int c, float v0, float v1) {
    if (c < f) {
      Elem<T>::store2(ba + r * ld + c, v0, v1);  // rounds to T
    } else if (kInputGrads) {
      float* o = dde + static_cast<size_t>(row0 + r) * d.de_pad + (c - f);
      o[0] = Elem<T>::round(v0);
      o[1] = Elem<T>::round(v1);
    }
  });
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int gr = row0 + r;
    const float ds = gr < m && st.sigma[gr] > 0.f ? g_sigma[gr] : 0.f;
    ba[r * ld + f] = Elem<T>::from(ds);
    for (int c = 1; c < 16; ++c) ba[r * ld + f + c] = Elem<T>::from(0.f);
  }
  __syncthreads();
  copy_out<T, R>(ba, ld, st.dz[L_8], d.z8(), row0);

  relu_step(Seg<T>{ba, ld, d.z8()}, L_8, f, bb, A_H0 + 7, L_7);
  relu_step(Seg<T>{bb, ld, f}, L_7, f, ba, A_H0 + 6, L_6);
  relu_step(Seg<T>{ba, ld, f}, L_6, f, bb, A_H0 + 5, L_5);

  // fc_5: [pe, h4] <- dz5 W^T; dpe takes the pe columns, dz4 = mask(h4, rest)
  {
    const T* a = st.act[A_H0 + 4];
    const int p = d.pe_pad;
    product<R>(Seg<T>{bb, ld, f}, none, net.wt[L_5], p + f, [&](int r, int c, float v0, float v1) {
      if (c < p) {
        if (kInputGrads) {
          float* o = dpe + static_cast<size_t>(row0 + r) * p + c;
          o[0] = Elem<T>::round(v0);
          o[1] = Elem<T>::round(v1);
        }
        return;
      }
      const int cc = c - p;
      const float2 h = Elem<T>::load2(a + static_cast<size_t>(row0 + r) * f + cc);
      Elem<T>::store2(ba + r * ld + cc, h.x > 0.f ? Elem<T>::round(v0) : 0.f, h.y > 0.f ? Elem<T>::round(v1) : 0.f);
    });
    __syncthreads();
    copy_out<T, R>(ba, ld, st.dz[L_4], f, row0);
  }

  relu_step(Seg<T>{ba, ld, f}, L_4, f, bb, A_H0 + 3, L_3);
  relu_step(Seg<T>{bb, ld, f}, L_3, f, ba, A_H0 + 2, L_2);
  relu_step(Seg<T>{ba, ld, f}, L_2, f, bb, A_H0 + 1, L_1);
  relu_step(Seg<T>{bb, ld, f}, L_1, f, ba, A_H0, L_IN);

  if constexpr (kInputGrads) {
    // fc_in: dpe += round(dz0 W^T)
    const int p = d.pe_pad;
    product<R>(Seg<T>{ba, ld, f}, none, net.wt[L_IN], p, [&](int r, int c, float v0, float v1) {
      float* o = dpe + static_cast<size_t>(row0 + r) * p + c;
      o[0] = o[0] + Elem<T>::round(v0);
      o[1] = o[1] + Elem<T>::round(v1);
    });
  }
}

// d/dx of the encoding of each point from the f32 cotangent g (m_pad, ld):
// x + sum over levels of 2^l (cos(2^l x) g_sin - sin(2^l x) g_cos), in the
// plain version's order; one thread a (point, coordinate)
template <class Value>
__device__ void encode_vjp(Value value, const float* __restrict__ g, int ld, int m, int levels, int include_input,
                           float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * 3) return;
  const int p = i / 3;
  const int c = i - 3 * p;
  const float* gp = g + static_cast<size_t>(p) * ld;
  const int base = include_input ? 3 : 0;
  const float x = value(p, c);
  float acc = include_input ? gp[c] : 0.f;
  for (int l = 0; l < levels; ++l) {
    const float fr = static_cast<float>(1 << l);
    float s, co;
    sincosf(x * fr, &s, &co);
    acc = acc + fr * (co * gp[base + 6 * l + c] - s * gp[base + 6 * l + 3 + c]);
  }
  out[i] = acc;
}

template <class In>
__global__ void encode_vjp_kernel(In in, const float* __restrict__ dpe, const float* __restrict__ dde, Dims d, int m,
                                  float* __restrict__ dpts, float* __restrict__ ddirs) {
  encode_vjp([&](int p, int c) { return in.pos(p, c); }, dpe, d.pe_pad, m, d.pos_levels, d.include_input, dpts);
  encode_vjp([&](int p, int c) { return in.dir(p, c); }, dde, d.de_pad, m, d.dir_levels, d.include_input, ddirs);
}

// ---------------------------------------------------------------------------
// host side

inline size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }
inline int padded_points(int m) { return (m + kPointPad - 1) / kPointPad * kPointPad; }
inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline Dims make_dims(int feat, int pos_levels, int dir_levels, int include_input, int pe_dim, int de_dim,
                      int pe_pad, int de_pad) {
  Dims d;
  d.feat = feat;
  d.pe_dim = pe_dim;
  d.de_dim = de_dim;
  d.pe_pad = pe_pad;
  d.de_pad = de_pad;
  d.pos_levels = pos_levels;
  d.dir_levels = dir_levels;
  d.include_input = include_input;
  return d;
}

inline bool dims_ok(const Dims& d) {
  return d.feat > 0 && d.feat % 32 == 0 && d.feat <= kMaxFeat && d.pe_pad % 16 == 0 && d.de_pad % 16 == 0 &&
         d.pe_pad <= kMaxEnc && d.de_pad <= kMaxEnc && d.pe_dim <= d.pe_pad && d.de_dim <= d.de_pad;
}

inline Net make_net(const void* const* w, const void* const* b, const void* const* wt, const Dims& d) {
  Net net;
  for (int l = 0; l < kLayers; ++l) {
    net.w[l] = w[l];
    net.b[l] = b[l];
    net.wt[l] = wt ? wt[l] : nullptr;
  }
  net.d = d;
  return net;
}

// rows a tile: 32, or 16 where 32 do not fit in shared memory (64-point
// tiles ran slower, one block of 8 warps an SM: PERF.md section 6)
template <class T>
inline int forward_rows(const Dims& d) {
  return forward_smem_bytes<T>(d, 32) <= kSmemLimit ? 32 : 16;
}

template <class T>
inline int chain_rows(const Dims& d) {
  return chain_smem_bytes<T>(d, 32) <= kSmemLimit ? 32 : 16;
}

template <class T>
inline size_t stash_bytes(int m, const Dims& d) {
  const size_t mp = padded_points(m);
  size_t n = 0;
  for (int a = 0; a < kActs; ++a) n += align256(mp * d.act_width(a) * sizeof(T));
  for (int l = 0; l < kLayers; ++l) n += align256(mp * d.dz_width(l) * sizeof(T));
  return n;
}

template <class T>
inline Stash<T> carve_stash(unsigned char* base, int m, const Dims& d, size_t* used) {
  const size_t mp = padded_points(m);
  Stash<T> st = {};
  size_t off = 0;
  for (int a = 0; a < kActs; ++a) {
    st.act[a] = reinterpret_cast<T*>(base + off);
    off += align256(mp * d.act_width(a) * sizeof(T));
  }
  for (int l = 0; l < kLayers; ++l) {
    st.dz[l] = reinterpret_cast<T*>(base + off);
    off += align256(mp * d.dz_width(l) * sizeof(T));
  }
  *used = off;
  return st;
}

// the stashes as the dW GEMM (nerf_dw_tc.cuh) reads them
template <class T>
inline nerf_dw::Stashes dw_stashes(const Stash<T>& st, const Dims& d) {
  nerf_dw::Stashes out;
  for (int a = 0; a < kActs; ++a) {
    out.act[a] = st.act[a];
    out.act_width[a] = d.act_width(a);
  }
  for (int l = 0; l < kLayers; ++l) {
    out.dz[l] = st.dz[l];
    out.dz_width[l] = d.dz_width(l);
  }
  return out;
}

// the dW GEMM's partials: one per (tile, slice)
template <class T>
inline size_t dw_ws_bytes(int m, const Dims& d) {
  return nerf_dw::ws_bytes<T>(dw_stashes<T>(Stash<T>{}, d), m);
}

// (the kernels' In types live in nerf_train, so argument-dependent lookup
// finds its set_smem: take that one)
using nerf_train::set_smem;

template <class T, int R, bool kStash, class In>
inline cudaError_t forward_r(const In& in, const Net& net, const Stash<T>& st, int m, cudaStream_t stream) {
  const size_t smem = forward_smem_bytes<T>(net.d, R);
  cudaError_t err = set_smem(forward_kernel<T, R, kStash, In>, smem);
  if (err != cudaSuccess) return err;
  forward_kernel<T, R, kStash, In><<<cdiv(m, R), kThreads, smem, stream>>>(in, net, st, m);
  return cudaGetLastError();
}

// the forward of m points (sigma, rgb to st.sigma, st.rgb; with kStash
// every activation to the stash)
template <class T, bool kStash, class In>
inline cudaError_t run_forward(const In& in, const Net& net, const Stash<T>& st, int m, cudaStream_t stream) {
  if (!dims_ok(net.d)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  if (forward_rows<T>(net.d) == 32) return forward_r<T, 32, kStash>(in, net, st, m, stream);
  return forward_r<T, 16, kStash>(in, net, st, m, stream);
}

template <class T, int R, bool kInputGrads>
inline cudaError_t chain_r(const Net& net, const Stash<T>& st, const float* g_sigma, const float* g_rgb, float* dpe,
                           float* dde, int m, cudaStream_t stream) {
  const size_t smem = chain_smem_bytes<T>(net.d, R);
  cudaError_t err = set_smem(chain_kernel<T, R, kInputGrads>, smem);
  if (err != cudaSuccess) return err;
  chain_kernel<T, R, kInputGrads><<<cdiv(m, R), kThreads, smem, stream>>>(net, st, g_sigma, g_rgb, dpe, dde, m);
  return cudaGetLastError();
}

template <class T, bool kInputGrads>
inline cudaError_t run_chain(const Net& net, const Stash<T>& st, const float* g_sigma, const float* g_rgb, float* dpe,
                             float* dde, int m, cudaStream_t stream) {
  if (chain_rows<T>(net.d) == 32) return chain_r<T, 32, kInputGrads>(net, st, g_sigma, g_rgb, dpe, dde, m, stream);
  return chain_r<T, 16, kInputGrads>(net, st, g_sigma, g_rgb, dpe, dde, m, stream);
}

// dW and db of every layer into the kernel-layout grads on the tensor
// cores (nerf_dw_tc.cuh); part: the workspace of dw_ws_bytes
template <class T>
inline cudaError_t run_dw(const Stash<T>& st, const Dims& d, int m, float* part, float* const* grads_w,
                          float* const* grads_b, cudaStream_t stream) {
  return nerf_dw::run<T>(dw_stashes<T>(st, d), m, part, grads_w, grads_b, stream);
}

}  // namespace nerf_general
