// What the general route's kernels share (nerf_mlp_tc.cuh's forward and
// chain, nerf_dw_tc.cuh's dW GEMM, the entries fused_tc_fwd.cu,
// fused_tc_bwd.cu and fused_tc_train.cu): the config's dimensions, the
// network's biases, the row-major stashes of every activation and every
// dz and their carving out of a workspace, the encode VJP and the dW GEMM's
// entry.
//
// Layout contract with torch_nerf_tpu_torch/ops/fused_nerf.py (F the padded
// width % 32 == 0 up to 1024, the encodings padded to 16, at most 128):
//   stash    each activation, then each layer's dz, (m_pad, width)
//            row-major in the compute type, 256-byte aligned, m_pad the
//            points rounded up to 64 (fused_nerf.stash_views): pe, de,
//            h0..h7 (the relu outputs of fc_in..fc_7), fc_8's features (no
//            relu), h9; dz of fc_in..fc_7 (F), fc_8 (F + 16: the features,
//            sigma, zeros), fc_9 (F / 2), fc_out (16);
//   grads    dW in each forward matrix's row order (fc_5: [pe, h4], fc_9:
//            [features, de], each segment padded to 16) by the dz's columns,
//            db by the dz's columns (fused_nerf.general_grad_shapes).
//
// Precision: as nerf_apply: bf16 rounds every layer's output and its bias
// sum, f32 keeps acc + b unrounded; the encode and its VJP by exact sincosf
// (fused_nerf.py:180-194's f32 path).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nerf_dw_tc.cuh"
#include "nerf_mlp_train.cuh"

namespace nerf_general {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kLayers = 11;
constexpr int kMaxFeat = 1024;
constexpr int kMaxEnc = 128;
constexpr int kPointPad = 64;  // stash rows: m rounded up to this

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

// the biases (the forward's column order) and the config
struct Net {
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
// element types: the roundings of the epilogues

template <class T>
struct Elem;

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
  static __device__ __forceinline__ float from(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float2 bias(float v0, float v1, const void* bias, int n) {
    const float* b = static_cast<const float*>(bias);
    return make_float2(v0 + b[n], v1 + b[n + 1]);
  }
};

// ---------------------------------------------------------------------------
// the encode VJP

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

inline Net make_net(const void* const* b, const Dims& d) {
  Net net;
  for (int l = 0; l < kLayers; ++l) net.b[l] = b[l];
  net.d = d;
  return net;
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

// dW and db of every layer into the kernel-layout grads on the tensor
// cores (nerf_dw_tc.cuh); part: the workspace of dw_ws_bytes
template <class T>
inline cudaError_t run_dw(const Stash<T>& st, const Dims& d, int m, float* part, float* const* grads_w,
                          float* const* grads_b, cudaStream_t stream) {
  return nerf_dw::run<T>(dw_stashes<T>(st, d), m, part, grads_w, grads_b, stream);
}

}  // namespace nerf_general
