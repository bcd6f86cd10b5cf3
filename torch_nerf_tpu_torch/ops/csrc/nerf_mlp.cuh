// The NeRF MLP's building blocks for the field's forward kernel on its
// mma.sync route (fused_nerf_fwd.cu's fused_nerf_fwd_mma, the widths outside
// 64, 128 and 256): the encode, the layer product of a 64-point tile on
// mma.sync and the bias epilogue. The training kernels (fused_train.cu,
// fused_nerf_bwd.cu) and the forward's wgmma route have their own design in
// nerf_mlp_train.cuh.
//
// Precision: bf16 operands, f32 accumulation; forward roundings as
// nerf_apply(compute_dtype=bf16).
//
// Weight layouts (built by torch_nerf_tpu_torch/ops/fused_nerf.py):
//   w[l]   B fragments (mma.m16n8k16) of layer l's padded weight W (K, N);
//   b[l]   bf16 bias padded with zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerf_mlp {

constexpr int kTileRows = 64;  // points per block
constexpr int kWarpsN = 8;
constexpr int kThreads = 32 * kWarpsN;
constexpr int kMTiles = kTileRows / 16;  // m16 tiles per warp
constexpr int kNTiles = 4;               // n8 tiles per warp per pass
constexpr int kRowPad = 8;               // bf16 elements
constexpr int kLayers = 11;

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

struct Net {
  const uint2* w[kLayers];
  const bf16* b[kLayers];
  int feat;
  int pos_levels, dir_levels, include_input;
  int pe_dim, de_dim, pe_pad, de_pad;
};

struct Seg {
  const bf16* buf;
  int ld;
  int ktiles;
};

// (pts, dirs) given per point
struct PointInput {
  const float* pts;
  const float* dirs;
  __device__ float pos(int i, int c) const { return pts[static_cast<size_t>(i) * 3 + c]; }
  __device__ float dir(int i, int c) const { return dirs[static_cast<size_t>(i) * 3 + c]; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// [x, sin(2^0 x), cos(2^0 x), ...] of coordinate value(i, c) for the tile's
// points; rows past m encode zeros and the padding columns are zeroed.
template <class Value>
__device__ void encode(Value value, int row0, int m, int levels, int include_input, int dim,
                       int dim_pad, bf16* out, int ld) {
  const int base = include_input ? 3 : 0;
  for (int i = threadIdx.x; i < kTileRows * 3; i += kThreads) {
    const int r = i / 3;
    const int c = i - 3 * r;
    const int gr = row0 + r;
    const float v = gr < m ? value(gr, c) : 0.f;
    bf16* o = out + r * ld;
    if (include_input) o[c] = __float2bfloat16_rn(v);
    for (int l = 0; l < levels; ++l) {
      float s, co;
      sincosf(v * static_cast<float>(1 << l), &s, &co);
      o[base + 6 * l + c] = __float2bfloat16_rn(s);
      o[base + 6 * l + 3 + c] = __float2bfloat16_rn(co);
    }
  }
  const int extra = dim_pad - dim;
  for (int i = threadIdx.x; i < kTileRows * extra; i += kThreads) {
    const int r = i / extra;
    out[r * ld + dim + (i - r * extra)] = __float2bfloat16_rn(0.f);
  }
}

// The product of one 64-row tile: in (64, K) from up to two shared-memory
// segments along K, times the fragment-ordered B (K, 8 * ntiles_total),
// for the n8 tiles [nt_begin, nt_end). Calls epi(r, n, v0, v1) with the f32
// sums of row r, columns n and n + 1 (n even). Each warp owns all 64 rows
// and 4 n8 tiles per pass, B fragments loaded two k-steps ahead in a
// register ring (the loop is unrolled by two so the ring needs no register
// moves).
template <class Epi>
__device__ __forceinline__ void tile_product(Seg s0, Seg s1, const uint2* __restrict__ wf,
                                             int ntiles_total, int nt_begin, int nt_end,
                                             Epi epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ktiles = s0.ktiles + s1.ktiles;
  const int per_pass = kWarpsN * kNTiles;
  const int lrow = lane & 15;
  const int lcol = (lane >> 4) * 8;
  const uint32_t a0 = smem_addr(s0.buf + lrow * s0.ld + lcol);
  const uint32_t a1 = s1.ktiles ? smem_addr(s1.buf + lrow * s1.ld + lcol) : 0u;
  const uint32_t mstep0 = 16u * s0.ld * sizeof(bf16);
  const uint32_t mstep1 = 16u * s1.ld * sizeof(bf16);
  const int kstride = ntiles_total * 32;

  for (int pass = 0; nt_begin + pass * per_pass < nt_end; ++pass) {
    const int nt0 = nt_begin + (pass * kWarpsN + warp) * kNTiles;
    if (nt0 >= nt_end) continue;  // warp-uniform

    float acc[kMTiles][kNTiles][4];
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const int jn = min(kNTiles, nt_end - nt0);
    const uint2* __restrict__ wlane = wf + nt0 * 32 + lane;
    auto load_b = [&](uint2 (&b)[kNTiles], int kt) {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        b[j] = j < jn ? __ldg(wlane + kt * kstride + j * 32) : make_uint2(0u, 0u);
      }
    };
    auto step = [&](const uint2 (&b)[kNTiles], int kt) {
      const bool first = kt < s0.ktiles;
      const uint32_t abase = first ? a0 + 32u * kt : a1 + 32u * (kt - s0.ktiles);
      const uint32_t mstep = first ? mstep0 : mstep1;
      uint32_t a[kMTiles][4];
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) ldmatrix_x4(a[i], abase + i * mstep);
#pragma unroll
      for (int i = 0; i < kMTiles; ++i)
#pragma unroll
        for (int j = 0; j < kNTiles; ++j)
          if (j < jn) mma_bf16(acc[i][j], a[i], b[j]);
    };

    uint2 b0[kNTiles], b1[kNTiles];
    load_b(b0, 0);
    if (ktiles > 1) load_b(b1, 1);
    for (int kt = 0; kt < ktiles; kt += 2) {
      step(b0, kt);
      if (kt + 2 < ktiles) load_b(b0, kt + 2);
      if (kt + 1 < ktiles) {
        step(b1, kt + 1);
        if (kt + 3 < ktiles) load_b(b1, kt + 3);
      }
    }

    // accumulator (i, j, h, e): row 16i + g + 8h, column 8(nt0 + j) + 2t + e
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      if (j >= jn) continue;
      const int n = 8 * (nt0 + j) + 2 * t;
#pragma unroll
      for (int i = 0; i < kMTiles; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          epi(16 * i + g + 8 * h, n, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
  }
}

__device__ __forceinline__ bf162 bias_add(float v0, float v1, const bf16* __restrict__ bias,
                                          int n) {
  // bf16(bf16(acc) + b) for the column pair: a bf16x2 add rounds the exact
  // sum once, as rounding its f32 sum does
  const bf162 b2 = *reinterpret_cast<const bf162*>(bias + n);
  return __hadd2(__floats2bfloat162_rn(v0, v1), b2);
}

// shared memory of a block: pe, de and two activation buffers, rows padded
__host__ __device__ inline size_t forward_smem_bytes(int feat, int pe_pad, int de_pad) {
  return static_cast<size_t>(kTileRows) *
         ((pe_pad + kRowPad) + (de_pad + kRowPad) + 2 * (feat + kRowPad)) * sizeof(bf16);
}

template <class Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// the third argument is not read: kernel 1 passes null in it
inline Net make_net(const void* const* wf, const void* const* bias, const void* const*, int feat,
                    int pos_levels, int dir_levels, int include_input, int pe_dim, int de_dim,
                    int pe_pad, int de_pad) {
  Net net;
  for (int l = 0; l < kLayers; ++l) {
    net.w[l] = static_cast<const uint2*>(wf[l]);
    net.b[l] = static_cast<const bf16*>(bias[l]);
  }
  net.feat = feat;
  net.pos_levels = pos_levels;
  net.dir_levels = dir_levels;
  net.include_input = include_input;
  net.pe_dim = pe_dim;
  net.de_dim = de_dim;
  net.pe_pad = pe_pad;
  net.de_pad = de_pad;
  return net;
}

}  // namespace nerf_mlp
