// The NeRF MLP's general route on Hopper's tensor cores: the forward (kernel
// 1), the forward with its stash and the backward chain (kernels 2 and 3)
// for the general configs the wgmma templates of nerf_mlp_train.cuh do not
// take, at padded widths F % 64 == 0: bf16 up to F = 512 on wgmma (route
// wgmma_general), f32 up to F = 256 on wgmma's bf16 product over three bf16
// pieces of each operand (route f32_wgmma). The stashes are
// nerf_mlp_general.cuh's, row-major: its encode VJP and its dW GEMM
// (nerf_dw_tc.cuh: wgmma on TMA-loaded stash tiles, the same three bf16
// pieces for f32, a fixed-order reduce) are used as they are.
//
// Replaces, on those configs, the Pallas TPU kernels torch_nerf_tpu/ops/
// pallas/fused_nerf.py::_fwd_kernel and _bwd_kernel and fused_train.py::
// _train_kernel, as nerf_mlp_general.cuh's mma.sync and FFMA products did
// before it; those stay for the configs this engine cannot hold.
//
// Design: nerf_mlp_train.cuh's engine carried over to any width. A CTA owns
// 64 points; a producer warpgroup streams every layer's weights, one K-slice
// (64 columns: 128 bf16 bytes of every image row) a stage, through a ring
// of 2-4 shared-memory stages by bulk asynchronous copies on mbarriers, so
// each weight is read from L2 once a tile, not by every warp. The two
// consumer warpgroups share
// the tile's 64 rows and each takes half of a layer's output columns: a
// 64 x F/2 f32 sum is at most 128 registers a thread at F = 512, where a
// 128-row tile (each warpgroup all F columns) would hold 128 KB of
// activations and need two N-passes. Each layer's output overwrites its
// input in place once both warpgroups' products are done (a barrier of the
// 256 consumer threads), then goes to the stash row-major, 16 bytes a
// thread; a relu layer's sign bits go to a bits stash, one 16-byte word a
// thread in the accumulator's order, which the chain's thread of the same
// columns reads back as its mask. The forward's fc_8 sigma group is an n8
// product beside the features' (the upper warpgroup writes it); the
// chain's input grads (kernel 2:
// fc_9's de rows, fc_5's and fc_in's pe rows) are products of their own, 64
// columns a warpgroup, the encodings padded to 128.
//
// Products. bf16: wgmma m64nNk16 with A (the activations) and B (the
// weight stage) K-major in 128-byte swizzled panels. f32: an f32 x is
// x0 + x1 + x2 exactly in three bf16 pieces (x0 = bf16(x), x1 = bf16(x -
// x0), x2 = x - x0 - x1); the weights' three piece images are built on the
// host and stream as three stages a K-slice, the activations (kept f32 in
// the tile) are split as each thread loads its A fragment into registers,
// and x w = sum over i + j <= 3 of x_i w_j: 8 of the 9 piece products
// (the dropped x2 w2 is ~2^-32 of x w), each exact in the tensor core,
// wgmma m64nNk16 with A from registers, summed as product_f32 says so that
// the accumulator's truncation stays at f32's level. Two TF32 pieces
// (3xTF32) carry 22 of f32's 24 significand bits, 2^-22 of error an
// operand: on the card its forward read 8-11x the plain f32 version's
// error and missed the f32 limit (PERF.md, section 6).
//
// Bound on an H100 SXM: flops_per_point a point a phase, at 989 TFLOP/s
// dense bf16 or, for f32_wgmma, 989 / 8 TFLOP/s (eight bf16 products). The
// weights stream from L2 once a 64-point tile, at F = 512 bf16 ~72 KB a
// point; a CTA pair multicasting the ring to halve that ran slower (a CTA
// waits on its partner's releases: PERF.md, section 6).
//
// Layout contract with torch_nerf_tpu_torch/ops/fused_nerf.py::tc_layout
// (F the padded width; each input segment padded to 64 columns):
//   fwd[l]   B = W^T (rows the layer's outputs: F; fc_8 F + 8, its features
//            then sigma; fc_9 F/2; fc_out 8; columns its inputs, fc_5's
//            [h4, pe], fc_9's [features, de]), K-slice after K-slice, each
//            slice rows x 128 bytes of bf16 at the 128-byte swizzle; f32:
//            each slice's three piece images, the smallest first;
//   chain[l] B = W (rows the layer's inputs, columns its outputs): fc_out
//            (F/2, 64); fc_9 its feature rows (F, F/2 padded); fc_8 (F, F +
//            64), sigma at column F; fc_5 its h4 rows; chain[0] fc_in's pe
//            rows (128, F); chain[11], chain[12] fc_5's pe rows and fc_9's de
//            rows (128, ...): the input-grad products;
//   b[l]     nerf_mlp_general.cuh's biases (the forward's column order).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "nerf_mlp_general.cuh"
#include "nerf_mlp_train.cuh"
#include "wgmma_ops.cuh"

namespace nerf_tc {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
namespace g = nerf_general;
using nerf_train::acc_col;
using nerf_train::acc_row;
using nerf_train::bulk_load;
using nerf_train::fence_acc;
using nerf_train::mbar_arrive;
using nerf_train::mbar_expect_tx;
using nerf_train::relu_nan;
using nerf_train::smem_u32;
using nerf_train::sw128_desc;
using nerf_train::wg_commit;
using nerf_train::wg_fence;
using nerf_train::wg_wait;
// the ring's wait that traps instead of holding the card, the consumers'
// barrier and the bf16 pair packing, shared with the dW GEMM
using nerf_dw::await_phase;
using nerf_dw::consumers_sync;
using nerf_dw::pack_bf16;

constexpr int kThreads = 384;  // two consumer warpgroups + one producer
constexpr int kConsumers = 256;
constexpr int kRows = 64;      // points a CTA
constexpr int kPanel = kRows * 128;
constexpr int kMaxStages = 4;
constexpr int kMaxSegs = 16;
constexpr int kExtra = 64;      // an input-grad product's columns a warpgroup
constexpr int kBitSlots = 9;    // h0..h7, h9
constexpr int kSmemLimit = 232448;
constexpr int kSlack = 1024 + 2 * kMaxStages * 8;  // the barriers and up to 1023 bytes to align
constexpr int kChainPe = 11, kChainDe = 12, kChainImages = 13;

template <class T>
struct Tc;
template <>
struct Tc<bf16> {
  static constexpr int kCols = 64;   // a tile panel's columns
  static constexpr int kImages = 1;  // weight images a K-slice
};
template <>
struct Tc<float> {
  static constexpr int kCols = 32;
  static constexpr int kImages = 3;  // the bf16 pieces
};
constexpr int kSliceCols = 64;  // a K-slice: 64 columns, 4 k16 steps

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// tile panels of `cols` columns
template <class T>
__host__ __device__ inline int panels(int cols) {
  return cdiv(cols, Tc<T>::kCols);
}

__host__ __device__ inline int slices(int cols) { return cdiv(cols, kSliceCols); }

// k16 steps of the last slice of a K of `cols` columns
__host__ __device__ inline int last_k(int cols) { return cdiv(cols - (slices(cols) - 1) * kSliceCols, 16); }

// shared address of K-slice s of a tile at `base`
template <class T>
__host__ __device__ inline uint32_t slice_addr(uint32_t base, int s) {
  return base + s * kPanel * (kSliceCols / Tc<T>::kCols);
}

// byte offset of element (r, c) in a 64-row tile of panels: 128 bytes a
// row, the 16-byte chunk j of row r at chunk j ^ (r % 8)
template <class T>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int PC = Tc<T>::kCols;
  const int b = (c % PC) * static_cast<int>(sizeof(T));
  return (c / PC) * kPanel + r * 128 + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15));
}

// ---------------------------------------------------------------------------
// the weight ring

// the weight slices of a kernel in the order its consumers take them:
// segment s is `slices` slices of `bytes` each from src
struct Seg {
  const unsigned char* src;
  int slices;
  uint32_t bytes;
};

struct Plan {
  Seg seg[kMaxSegs];
  int n;
  int stages;
  uint32_t stage_bytes;
};

struct Ring {
  uint64_t* full;   // the stage's copy has landed
  uint64_t* empty;  // all 8 consumer warps are done with it
  unsigned char* stage;
  uint32_t stage_bytes;
  int stages;
  int it;  // slices taken so far
};

// one producer thread: every slice of the plan into the ring, in order
__device__ __forceinline__ void produce(const Plan& plan, const Ring& ring) {
  int it = 0;
  for (int s = 0; s < plan.n; ++s) {
    const Seg& sg = plan.seg[s];
    for (int i = 0; i < sg.slices; ++i, ++it) {
      const int slot = it % ring.stages;
      if (it >= ring.stages) await_phase(&ring.empty[slot], (it / ring.stages - 1) & 1);
      mbar_expect_tx(&ring.full[slot], sg.bytes);
      bulk_load(ring.stage + slot * ring.stage_bytes, sg.src + static_cast<size_t>(i) * sg.bytes, sg.bytes,
                &ring.full[slot]);
    }
  }
}

__device__ __forceinline__ void release(const Ring& ring, int it) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.empty[it % ring.stages]);
}


// generic-proxy writes to the tile made visible to wgmma, then the barrier
__device__ __forceinline__ void publish() {
  nerf_train::fence_async_smem();
  consumers_sync();
}

// ---------------------------------------------------------------------------
// products: acc (64 x N, the warpgroup's columns) = sum over the K-slices of
// A_s (slice s of the A source) x the stage's image rows [b_row, b_row + N)
// (byte offset b_off = 128 b_row); `last` k16 steps of the last slice, 4 of
// the others. With N2 > 0, acc2 (64 x N2) takes rows at b2_off as well. Both
// warpgroups run every product (a product in a warpgroup-divergent branch
// makes ptxas serialize the kernel's wgmma), so a small product that one
// warpgroup needs (fc_out, fc_8's sigma group) is run by both.

// A's K-slices: n0 slices of the tile at base0, then those at base1 (an
// encoding, or the chain's x panel)
struct ASrc {
  uint32_t base0;
  int n0;
  uint32_t base1;
  template <class T>
  __device__ __forceinline__ uint32_t slice(int s) const {
    return s < n0 ? slice_addr<T>(base0, s) : slice_addr<T>(base1, s - n0);
  }
};

template <int N, int N2>
__device__ __forceinline__ void product_bf16(Ring& ring, const ASrc& src, int slices, int last, uint32_t b_off,
                                             uint32_t b2_off, float (&acc)[N / 2],
                                             float (&acc2)[N2 > 0 ? N2 / 2 : 1]) {
  for (int s = 0; s < slices; ++s) {
    const int slot = ring.it % ring.stages;
    await_phase(&ring.full[slot], (ring.it / ring.stages) & 1);
    const uint32_t b = smem_u32(ring.stage + slot * ring.stage_bytes);
    const uint32_t a = src.slice<bf16>(s);
    const int ks = s == slices - 1 ? last : 4;
    wg_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < ks) {
        const int scale = (s | k) != 0;
        const uint64_t da = sw128_desc(a + 32 * k, 16, 1024);
        mma_bf16<N>(acc, da, sw128_desc(b + b_off + 32 * k, 16, 1024), scale);
        if constexpr (N2 > 0) mma_bf16<N2>(acc2, da, sw128_desc(b + b2_off + 32 * k, 16, 1024), scale);
      }
    }
    wg_commit();
    if (s > 0) {
      wg_wait<1>();
      release(ring, ring.it - 1);
    }
    ++ring.it;
  }
  wg_wait<0>();
  release(ring, ring.it - 1);
  fence_acc(acc);
  if constexpr (N2 > 0) fence_acc(acc2);
}

__device__ __forceinline__ void lds_f32x2(uint32_t addr, float& x, float& y) {
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(x), "=f"(y) : "r"(addr) : "memory");
}

// the three bf16 pieces of a pair of f32 values, packed: x = x0 + x1 + x2
// exactly for a normal x (each remainder is exact in f32)
__device__ __forceinline__ void split3(float x, float y, uint32_t& p0, uint32_t& p1, uint32_t& p2) {
  const float x0 = __bfloat162float(__float2bfloat16_rn(x)), y0 = __bfloat162float(__float2bfloat16_rn(y));
  const float rx = x - x0, ry = y - y0;
  const float x1 = __bfloat162float(__float2bfloat16_rn(rx)), y1 = __bfloat162float(__float2bfloat16_rn(ry));
  p0 = pack_bf16(x0, y0);
  p1 = pack_bf16(x1, y1);
  p2 = pack_bf16(rx - x1, ry - y1);
}

// k16 step k of the warp's 16 rows of the f32 K-slice at `a` (two 32-column
// panels), as wgmma's register A fragment, in its three bf16 pieces
__device__ __forceinline__ void load_a_pieces(uint32_t a, int k, uint32_t (&q)[3][4]) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const uint32_t panel = a + (k >> 1) * kPanel;
  const int c0 = 16 * (k & 1) + 2 * (lane & 3);
  // rows r0 and r0 + 8 share r % 8, so one swizzled chunk offset serves both
  auto at = [&](int r, int c) { return panel + r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2)); };
  float v[4][2];
  lds_f32x2(at(r0, c0), v[0][0], v[0][1]);
  lds_f32x2(at(r0 + 8, c0), v[1][0], v[1][1]);
  lds_f32x2(at(r0, c0 + 8), v[2][0], v[2][1]);
  lds_f32x2(at(r0 + 8, c0 + 8), v[3][0], v[3][1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) split3(v[e][0], v[e][1], q[0][e], q[1][e], q[2][e]);
}

// the registers stay live until the products that read them are done
__device__ __forceinline__ void fence_regs(uint32_t (&r)[3][4]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// f32: each K-slice's three piece images of W come as three stages, w2, w1
// and w0, and each multiplies A's pieces i with i + j <= 3 (j the W
// piece): x0 w2, x1 w2; x0 w1, x1 w1, x2 w1; x1 w0, x2 w0 and last x0 w0,
// each k16 step's pieces loaded and split as it comes into registers that
// the next step rewrites once the products that read them are done. The
// tensor core adds each product's sums to its f32 accumulator with a
// truncation relative to the running sum: a slice's products go to a fresh
// accumulator, the 7 small ones (~2^-8 of the slice's sum) first and the
// leading x0 w0 last, four additions, and the slice is folded into acc by
// an f32 add that rounds to nearest. All 8 products in acc over the whole
// K read ~10x the plain f32 version's error on the card (PERF.md, section 6).
template <int N, int N2>
__device__ __forceinline__ void product_f32(Ring& ring, const ASrc& src, int slices, int last, uint32_t b_off,
                                            uint32_t b2_off, float (&acc)[N / 2], float (&acc2)[N2 > 0 ? N2 / 2 : 1]) {
  constexpr int M2 = N2 > 0 ? N2 / 2 : 1;
  float part[N / 2], part2[M2];
  for (int s = 0; s < slices; ++s) {
    const int ks = s == slices - 1 ? last : 4;
    const uint32_t a = src.slice<float>(s);
#pragma unroll
    for (int j = 2; j >= 0; --j) {  // W's piece in this stage
      const int slot = ring.it % ring.stages;
      await_phase(&ring.full[slot], (ring.it / ring.stages) & 1);
      const uint32_t b = smem_u32(ring.stage + slot * ring.stage_bytes);
      uint32_t q[3][4];
      // the products x_i w_j of this stage: i from 0, or from 1 when x0 w0
      // waits for its own pass below
      auto products = [&](int i0, int i1) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < ks) {
            if (k > 0) {
              wg_wait<0>();
              fence_regs(q);
            }
            load_a_pieces(a, k, q);
            wg_fence();
            const uint64_t db = sw128_desc(b + b_off + 32 * k, 16, 1024);
            const uint64_t db2 = sw128_desc(b + b2_off + 32 * k, 16, 1024);
#pragma unroll
            for (int i = i0; i <= i1; ++i) {
              const int scale = !(j == 2 && k == 0 && i == i0);  // the slice's first product starts its sums
              mma_bf16_rs<N>(part, q[i], db, scale);
              if constexpr (N2 > 0) mma_bf16_rs<N2>(part2, q[i], db2, scale);
            }
            wg_commit();
          }
        }
        wg_wait<0>();
        fence_regs(q);
      };
      if (j == 0) {
        products(1, 2);
        products(0, 0);
      } else {
        products(0, 3 - j < 2 ? 3 - j : 2);
      }
      release(ring, ring.it);
      ++ring.it;
    }
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = s == 0 ? part[i] : acc[i] + part[i];
    if constexpr (N2 > 0) {
      fence_acc(part2);
#pragma unroll
      for (int i = 0; i < M2; ++i) acc2[i] = s == 0 ? part2[i] : acc2[i] + part2[i];
    }
  }
}

// the product of one layer: b_row the warpgroup's first image row
template <class T, int N, int N2 = 0>
__device__ __forceinline__ void product(Ring& ring, const ASrc& src, int slices, int last, int b_row,
                                        float (&acc)[N / 2], float (&acc2)[N2 > 0 ? N2 / 2 : 1], int b2_row = 0) {
  if constexpr (sizeof(T) == 2) {
    product_bf16<N, N2>(ring, src, slices, last, 128u * b_row, 128u * b2_row, acc, acc2);
  } else {
    product_f32<N, N2>(ring, src, slices, last, 128u * b_row, 128u * b2_row, acc, acc2);
  }
}

// ---------------------------------------------------------------------------
// epilogues: the warpgroup's 64 x N sums (columns col0..) into the tile

template <class T>
__device__ __forceinline__ void store2(unsigned char* tile, int r, int c, float v0, float v1) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<bf162*>(tile + swz<T>(r, c)) = __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<float2*>(tile + swz<T>(r, c)) = make_float2(v0, v1);
  }
}

// relu(bias(acc)) as nerf_apply rounds it, and with kBits the sign bits
template <class T, int N, bool kBits>
__device__ __forceinline__ void relu_out(const float (&acc)[N / 2], const void* bias, int col0, unsigned char* tile,
                                         uint4* bits, int t) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int r = acc_row(t, i);
    const int c = col0 + acc_col(t, i);
    float y0, y1;
    if constexpr (sizeof(T) == 2) {
      const bf162 y = __hmax2_nan(g::Elem<bf16>::bias2(acc[i], acc[i + 1], bias, c), __float2bfloat162_rn(0.f));
      *reinterpret_cast<bf162*>(tile + swz<T>(r, c)) = y;
      y0 = __low2float(y);
      y1 = __high2float(y);
    } else {
      const float* b = static_cast<const float*>(bias);
      y0 = relu_nan(acc[i] + b[c]);
      y1 = relu_nan(acc[i + 1] + b[c + 1]);
      store2<T>(tile, r, c, y0, y1);
    }
    if constexpr (kBits) {
      w[i >> 5] |= (y0 > 0.f ? 1u : 0u) << (i & 31);
      w[(i + 1) >> 5] |= (y1 > 0.f ? 1u : 0u) << ((i + 1) & 31);
    }
  }
  if constexpr (kBits) *bits = make_uint4(w[0], w[1], w[2], w[3]);
}

// acc rounded to T, kept where the sign bits are set (all of it without
// kMask): dh masked by its input's relu
template <class T, int N, bool kMask>
__device__ __forceinline__ void dz_out(const float (&acc)[N / 2], uint4 bits, int col0, unsigned char* tile, int t) {
  const uint32_t w[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    float v0 = g::Elem<T>::round(acc[i]);
    float v1 = g::Elem<T>::round(acc[i + 1]);
    if (kMask) {
      if (!((w[i >> 5] >> (i & 31)) & 1u)) v0 = 0.f;
      if (!((w[(i + 1) >> 5] >> ((i + 1) & 31)) & 1u)) v1 = 0.f;
    }
    store2<T>(tile, acc_row(t, i), col0 + acc_col(t, i), v0, v1);
  }
}

// an input-grad product's 64 columns (col0..) to the f32 (m_pad, ld) rows
// of the tile, rounded to T; with kAdd added to what is there
template <class T, bool kAdd>
__device__ __forceinline__ void grad_out(const float (&acc)[kExtra / 2], int col0, float* out, int ld, int row0,
                                         int t) {
#pragma unroll
  for (int i = 0; i < kExtra / 2; i += 2) {
    const int c = col0 + acc_col(t, i);
    if (c >= ld) continue;
    float* o = out + static_cast<size_t>(row0 + acc_row(t, i)) * ld + c;
    const float v0 = g::Elem<T>::round(acc[i]);
    const float v1 = g::Elem<T>::round(acc[i + 1]);
    o[0] = kAdd ? o[0] + v0 : v0;
    o[1] = kAdd ? o[1] + v1 : v1;
  }
}

// ---------------------------------------------------------------------------
// tiles

// [x, sin(2^0 x), cos(2^0 x), ...] of the tile's points (rows past m encode
// zeros) into `np` panels, columns [dim, np PC) zeroed
template <class T, class Value>
__device__ void encode(Value value, int row0, int m, int levels, int include_input, int dim, int np,
                       unsigned char* tile, int tid) {
  const int base = include_input ? 3 : 0;
  auto put = [&](int r, int c, float v) { *reinterpret_cast<T*>(tile + swz<T>(r, c)) = g::Elem<T>::from(v); };
  for (int i = tid; i < kRows * 3; i += kConsumers) {
    const int r = i / 3;
    const int c = i - 3 * r;
    const float v = row0 + r < m ? value(row0 + r, c) : 0.f;
    if (include_input) put(r, c, v);
    for (int l = 0; l < levels; ++l) {
      float s, co;
      sincosf(v * static_cast<float>(1 << l), &s, &co);
      put(r, base + 6 * l + c, s);
      put(r, base + 6 * l + 3 + c, co);
    }
  }
  const int extra = np * Tc<T>::kCols - dim;
  for (int i = tid; i < kRows * extra; i += kConsumers) put(i / extra, dim + i % extra, 0.f);
}

// columns [0, width) of the tile (columns at or past `split` from tile2's
// columns from 0) to rows [row0, row0 + 64) of a row-major (m_pad, width)
// stash, 16 bytes a thread
template <class T>
__device__ __forceinline__ void copy_out(const unsigned char* tile, T* dst, int width, int row0, int tid,
                                         const unsigned char* tile2 = nullptr, int split = 1 << 30) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = width / V;
  for (int i = tid; i < kRows * per_row; i += kConsumers) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * V;
    const unsigned char* src = c < split ? tile + swz<T>(r, c) : tile2 + swz<T>(r, c - split);
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + r) * width + c) = *reinterpret_cast<const uint4*>(src);
  }
}

// a 64-row panel whose row r holds v(r, 0..2) (rounded to T) in columns
// 0..2, zeros elsewhere
template <class T, class Value>
__device__ __forceinline__ void small_panel(unsigned char* tile, int tid, Value v) {
  for (int i = tid; i < kRows * 8; i += kConsumers) {
    const int r = i >> 3;
    const int ch = i & 7;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (ch == 0) {
      float x[3];
      v(r, x);
      if constexpr (sizeof(T) == 2) {
        const bf162 a = __floats2bfloat162_rn(x[0], x[1]);
        const bf162 b = __floats2bfloat162_rn(x[2], 0.f);
        q.x = *reinterpret_cast<const uint32_t*>(&a);
        q.y = *reinterpret_cast<const uint32_t*>(&b);
      } else {
        q = make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]), 0u);
      }
    }
    *reinterpret_cast<uint4*>(tile + r * 128 + ((ch ^ (r & 7)) << 4)) = q;
  }
}

// shared memory: barriers first, then the tiles and the ring, 1024-aligned
struct Smem {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* data;
};

__device__ __forceinline__ Smem carve(unsigned char* raw, int stages) {
  Smem s;
  s.full = reinterpret_cast<uint64_t*>(raw);
  s.empty = s.full + kMaxStages;
  s.data = nerf_train::align1024(raw + 2 * kMaxStages * sizeof(uint64_t));
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      nerf_train::mbar_init(&s.full[i], 1);
      nerf_train::mbar_init(&s.empty[i], nerf_train::kConsumerWarps);
    }
    nerf_train::mbar_fence_init();
  }
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------------------
// the forward: PE + 11 layers of a 64-point tile, sigma (m,) and rgb (m, 3)
// out; with kStash every activation to the stash and the relu bits to bits


__device__ __forceinline__ uint4* bits_word(uint4* bits, int slot) {
  return bits + (static_cast<size_t>(slot) * gridDim.x + blockIdx.x) * kConsumers + threadIdx.x;
}

template <class T, int F, bool kStash, class In>
__global__ void __launch_bounds__(kThreads, 1)
    forward_kernel(In in, const __grid_constant__ g::Net net, const __grid_constant__ g::Stash<T> st, uint4* bits,
                   int m, const __grid_constant__ Plan plan) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, plan.stages);
  const g::Dims& d = net.d;
  constexpr int P = F / kSliceCols;  // K-slices of an F-wide input
  constexpr int N = F / 2;           // a warpgroup's columns of an F-wide layer
  const int pe_np = panels<T>(d.pe_dim), de_np = panels<T>(d.de_dim);
  unsigned char* act = sm.data;
  unsigned char* pe = act + panels<T>(F) * kPanel;
  unsigned char* de = pe + pe_np * kPanel;
  Ring ring = {sm.full, sm.empty, de + de_np * kPanel, plan.stage_bytes, plan.stages, 0};
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) produce(plan, ring);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x;
  const int t = tid & 127;
  const int row0 = blockIdx.x * kRows;

  encode<T>([&](int i, int c) { return in.pos(i, c); }, row0, m, d.pos_levels, d.include_input, d.pe_dim, pe_np, pe,
            tid);
  encode<T>([&](int i, int c) { return in.dir(i, c); }, row0, m, d.dir_levels, d.include_input, d.de_dim, de_np, de,
            tid);
  publish();
  if constexpr (kStash) {
    copy_out<T>(pe, st.act[g::A_PE], d.pe_pad, row0, tid);
    copy_out<T>(de, st.act[g::A_DE], d.de_pad, row0, tid);
  }

  const uint32_t act_a = smem_u32(act), pe_a = smem_u32(pe), de_a = smem_u32(de);
  float acc[N / 2];
  float unused[1];
  // A: the tile's K-slices then, where an encoding follows, the encoding's,
  // whose last slice is the product's last, read for `last` k16 steps

  // relu layers fc_in .. fc_7: fc_in reads pe, fc_5 [h4, pe], the others h
  for (int l = 0; l < 8; ++l) {
    const bool enc = l == 0 || l == 5;
    const ASrc src = {act_a, l == 0 ? 0 : P, pe_a};
    product<T, N>(ring, src, src.n0 + (enc ? slices(d.pe_dim) : 0), enc ? last_k(d.pe_dim) : 4, wg * N, acc,
                  unused);
    consumers_sync();
    relu_out<T, N, kStash>(acc, net.b[l], wg * N, act, kStash ? bits_word(bits, l) : nullptr, t);
    publish();
    if constexpr (kStash) copy_out<T>(act, st.act[g::A_H0 + l], F, row0, tid);
  }

  // fc_8: the features (no relu); sigma from the n8 group on the image's
  // rows [F, F + 8), written by the upper warpgroup
  {
    float acc8[4];
    product<T, N, 8>(ring, ASrc{act_a, P, 0}, P, 4, wg * N, acc, acc8, F);
    consumers_sync();
#pragma unroll
    for (int i = 0; i < N / 2; i += 2) {
      const int c = wg * N + acc_col(t, i);
      const float2 y = g::Elem<T>::bias(acc[i], acc[i + 1], net.b[g::L_8], c);
      store2<T>(act, acc_row(t, i), c, y.x, y.y);
    }
    if (wg == 1 && (t & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int gr = row0 + acc_row(t, i);
        const float2 y = g::Elem<T>::bias(acc8[i], acc8[i + 1], net.b[g::L_8], F);
        if (gr < m) st.sigma[gr] = relu_nan(y.x);
      }
    }
    publish();
    if constexpr (kStash) copy_out<T>(act, st.act[g::A_FEAT], F, row0, tid);
  }

  // fc_9 reads [features, de] -> h9 (F/2), a warpgroup F/4 columns
  {
    float acc9[N / 4];
    product<T, N / 2>(ring, ASrc{act_a, P, de_a}, P + slices(d.de_dim), last_k(d.de_dim), wg * (N / 2), acc9,
                      unused);
    consumers_sync();
    relu_out<T, N / 2, kStash>(acc9, net.b[g::L_9], wg * (N / 2), act, kStash ? bits_word(bits, 8) : nullptr, t);
    publish();
    if constexpr (kStash) copy_out<T>(act, st.act[g::A_H9], F / 2, row0, tid);
  }

  // fc_out -> sigmoid, written by the lower warpgroup
  {
    float acco[4];
    product<T, 8>(ring, ASrc{act_a, slices(F / 2), 0}, slices(F / 2), last_k(F / 2), 0, acco, unused);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int c = acc_col(t, i);
        const int gr = row0 + acc_row(t, i);
        const float2 y = g::Elem<T>::bias(acco[i], acco[i + 1], net.b[g::L_OUT], c);
        const float v[2] = {y.x, y.y};
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c + e < 3 && gr < m) st.rgb[static_cast<size_t>(gr) * 3 + c + e] = 1.f / (1.f + expf(-v[e]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the backward chain of a 64-point tile from the stash and the f32
// cotangents g_sigma (m,), g_rgb (m, 3): every dz to the dz stash; with
// kInputGrads the f32 cotangents of the encodings to dpe (m_pad, pe_pad)
// and dde (m_pad, de_pad)

template <class T, int F, bool kInputGrads>
__global__ void __launch_bounds__(kThreads, 1)
    chain_kernel(const __grid_constant__ g::Net net, const __grid_constant__ g::Stash<T> st,
                 const uint4* __restrict__ bits, const float* __restrict__ g_sigma, const float* __restrict__ g_rgb,
                 float* __restrict__ dpe, float* __restrict__ dde, int m, const __grid_constant__ Plan plan) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, plan.stages);
  const g::Dims& d = net.d;
  constexpr int P = F / kSliceCols;
  constexpr int N = F / 2;
  unsigned char* act = sm.data;
  unsigned char* x = act + panels<T>(F) * kPanel;
  Ring ring = {sm.full, sm.empty, x + kPanel, plan.stage_bytes, plan.stages, 0};
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) produce(plan, ring);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x;
  const int t = tid & 127;
  const int row0 = blockIdx.x * kRows;
  auto bits_of = [&](int slot) { return bits[(static_cast<size_t>(slot) * gridDim.x + blockIdx.x) * kConsumers + tid]; };
  const uint32_t act_a = smem_u32(act), x_a = smem_u32(x);
  float acc[N / 2];
  float unused[1];

  // dz_out = g_rgb rgb (1 - rgb) in x's columns 0..2
  small_panel<T>(x, tid, [&](int r, float (&v)[3]) {
    const int gr = row0 + r;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = 0.f;
      if (gr < m) {
        const size_t k = static_cast<size_t>(gr) * 3 + c;
        const float y = st.rgb[k];
        v[c] = g_rgb[k] * y * (1.f - y);
      }
    }
  });
  publish();
  copy_out<T>(x, st.dz[g::L_OUT], 16, row0, tid);

  // fc_out^T: dz9 = mask(h9, dz_out W_out^T), a warpgroup F/4 columns
  {
    float acc9[N / 4];
    const uint4 bw = bits_of(8);
    product<T, N / 2>(ring, ASrc{x_a, 1, 0}, 1, 1, wg * (N / 2), acc9, unused);
    dz_out<T, N / 2, true>(acc9, bw, wg * (N / 2), act, t);
    publish();
    copy_out<T>(act, st.dz[g::L_9], F / 2, row0, tid);
  }

  // fc_9^T: dz9 W_9^T -> the features' dh (dz8's feature columns, no
  // relu); with input grads dde from the de rows
  {
    const int np = slices(F / 2), lk = last_k(F / 2);
    const ASrc src = {act_a, np, 0};
    // the input-grad product first: its sums leave before acc's arrive
    if constexpr (kInputGrads) {
      float acce[kExtra / 2];
      product<T, kExtra>(ring, src, np, lk, wg * kExtra, acce, unused);
      grad_out<T, false>(acce, wg * kExtra, dde, d.de_pad, row0, t);
    }
    product<T, N>(ring, src, np, lk, wg * N, acc, unused);
    consumers_sync();
    dz_out<T, N, false>(acc, uint4{}, wg * N, act, t);
    // dz8's sigma column: g_sigma where sigma > 0, in x's column 0
    small_panel<T>(x, tid, [&](int r, float (&v)[3]) {
      const int gr = row0 + r;
      v[0] = gr < m && st.sigma[gr] > 0.f ? g_sigma[gr] : 0.f;
      v[1] = v[2] = 0.f;
    });
    publish();
    copy_out<T>(act, st.dz[g::L_8], F + 16, row0, tid, x, F);
  }

  // fc_8^T .. fc_1^T: dh = dz W^T masked by the relu of its input; fc_8^T
  // reads [dz8's features, x's sigma column], fc_5^T's pe rows give dpe
  for (int l = 8; l >= 1; --l) {
    const uint4 bw = bits_of(l - 1);
    const ASrc src = {act_a, P, x_a};
    if constexpr (kInputGrads) {
      if (l == 5) {
        float acce[kExtra / 2];
        product<T, kExtra>(ring, src, P, 4, wg * kExtra, acce, unused);
        grad_out<T, false>(acce, wg * kExtra, dpe, d.pe_pad, row0, t);
      }
    }
    product<T, N>(ring, src, l == 8 ? P + 1 : P, l == 8 ? 1 : 4, wg * N, acc, unused);
    consumers_sync();
    dz_out<T, N, true>(acc, bw, wg * N, act, t);
    publish();
    copy_out<T>(act, st.dz[l - 1], F, row0, tid);
  }

  if constexpr (kInputGrads) {
    // fc_in^T: dpe += round(dz0 W_in^T)
    float acce[kExtra / 2];
    product<T, kExtra>(ring, ASrc{act_a, P, 0}, P, 4, wg * kExtra, acce, unused);
    grad_out<T, true>(acce, wg * kExtra, dpe, d.pe_pad, row0, t);
  }
}

// ---------------------------------------------------------------------------
// host side

// bytes of a stage: one weight image's K-slice (the f32 route's three piece
// images are three stages), 128 bytes a row
inline uint32_t stage_of(int rows) { return static_cast<uint32_t>(rows) * 128; }

// a layer's `slices` K-slices of `rows` image rows from `image`
template <class T>
inline void add(Plan& plan, const void* image, int slices, int rows) {
  plan.seg[plan.n].src = static_cast<const unsigned char*>(image);
  plan.seg[plan.n].slices = slices * Tc<T>::kImages;
  plan.seg[plan.n].bytes = stage_of(rows);
  ++plan.n;
  plan.stage_bytes = std::max(plan.stage_bytes, stage_of(rows));
}

// the ring's depth: as many stages as fit beside the tiles, at most
// kMaxStages; fewer than 2 and the route does not take the config
inline int ring_stages(int tiles, uint32_t stage_bytes) {
  return std::min(kMaxStages, static_cast<int>((kSmemLimit - kSlack - tiles) / static_cast<int>(stage_bytes)));
}

inline size_t smem_bytes(int tiles, const Plan& plan) {
  return static_cast<size_t>(kSlack) + tiles + static_cast<size_t>(plan.stages) * plan.stage_bytes;
}

template <class T>
inline int tile_bytes(const g::Dims& d, bool forward) {
  const int p = panels<T>(d.feat);
  return (forward ? p + panels<T>(d.pe_dim) + panels<T>(d.de_dim) : p + 1) * kPanel;
}

template <class T>
inline Plan forward_plan(const void* const* fwd, const g::Dims& d) {
  const int f = d.feat, p = f / kSliceCols, pe = slices(d.pe_dim), de = slices(d.de_dim);
  Plan plan = {};
  for (int l = 0; l < 8; ++l) add<T>(plan, fwd[l], l == 0 ? pe : (l == 5 ? p + pe : p), f);
  add<T>(plan, fwd[g::L_8], p, f + 8);
  add<T>(plan, fwd[g::L_9], p + de, f / 2);
  add<T>(plan, fwd[g::L_OUT], slices(f / 2), 8);
  plan.stages = ring_stages(tile_bytes<T>(d, true), plan.stage_bytes);
  return plan;
}

template <class T>
inline Plan chain_plan(const void* const* chain, const g::Dims& d, bool input_grads) {
  const int f = d.feat, p = f / kSliceCols, h = slices(f / 2);
  Plan plan = {};
  add<T>(plan, chain[g::L_OUT], 1, f / 2);
  if (input_grads) add<T>(plan, chain[kChainDe], h, 2 * kExtra);
  add<T>(plan, chain[g::L_9], h, f);
  add<T>(plan, chain[g::L_8], p + 1, f);
  for (int l = 7; l >= 1; --l) {
    if (input_grads && l == 5) add<T>(plan, chain[kChainPe], p, 2 * kExtra);
    add<T>(plan, chain[l], p, f);
  }
  if (input_grads) add<T>(plan, chain[g::L_IN], p, 2 * kExtra);
  plan.stages = ring_stages(tile_bytes<T>(d, false), plan.stage_bytes);
  return plan;
}

// the widths this engine takes: F % 64 == 0, bf16 up to 512, f32 up to 256,
// and a ring of at least two stages beside the tiles of every kernel
template <class T>
inline bool takes(const g::Dims& d) {
  if (!g::dims_ok(d) || d.feat % 64 != 0 || d.feat > (sizeof(T) == 2 ? 512 : 256)) return false;
  const void* none[kChainImages] = {};
  return forward_plan<T>(none, d).stages >= 2 && chain_plan<T>(none, d, true).stages >= 2 &&
         chain_plan<T>(none, d, false).stages >= 2;
}

inline size_t bits_bytes(int m) {
  return g::align256(static_cast<size_t>(kBitSlots) * g::padded_points(m) / kRows * kConsumers * sizeof(uint4));
}

using nerf_train::set_smem;

template <class T, int F, bool kStash, class In>
inline cudaError_t forward_f(const In& in, const g::Net& net, const g::Stash<T>& st, uint4* bits, int m,
                             const Plan& plan, cudaStream_t stream) {
  const size_t smem = smem_bytes(tile_bytes<T>(net.d, true), plan);
  cudaError_t err = set_smem(forward_kernel<T, F, kStash, In>, smem);
  if (err != cudaSuccess) return err;
  forward_kernel<T, F, kStash, In><<<g::padded_points(m) / kRows, kThreads, smem, stream>>>(in, net, st, bits, m, plan);
  return cudaGetLastError();
}

template <class T, int F, bool kInputGrads>
inline cudaError_t chain_f(const g::Net& net, const g::Stash<T>& st, const uint4* bits, const float* g_sigma,
                           const float* g_rgb, float* dpe, float* dde, int m, const Plan& plan, cudaStream_t stream) {
  const size_t smem = smem_bytes(tile_bytes<T>(net.d, false), plan);
  cudaError_t err = set_smem(chain_kernel<T, F, kInputGrads>, smem);
  if (err != cudaSuccess) return err;
  chain_kernel<T, F, kInputGrads><<<g::padded_points(m) / kRows, kThreads, smem, stream>>>(net, st, bits, g_sigma,
                                                                                       g_rgb, dpe, dde, m, plan);
  return cudaGetLastError();
}

// F through the widths of the element type: bf16 64..512, f32 64..256
template <class T, class Fn>
inline cudaError_t by_width(int feat, Fn fn) {
  switch (feat) {
    case 64: return fn(std::integral_constant<int, 64>());
    case 128: return fn(std::integral_constant<int, 128>());
    case 192: return fn(std::integral_constant<int, 192>());
    case 256: return fn(std::integral_constant<int, 256>());
    default: break;
  }
  if constexpr (sizeof(T) == 2) {
    switch (feat) {
      case 320: return fn(std::integral_constant<int, 320>());
      case 384: return fn(std::integral_constant<int, 384>());
      case 448: return fn(std::integral_constant<int, 448>());
      case 512: return fn(std::integral_constant<int, 512>());
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

// the forward of m points: sigma, rgb to st.sigma, st.rgb; with kStash every
// activation to the stash and the relu bits to bits. fwd: the forward images.
template <class T, bool kStash, class In>
inline cudaError_t run_forward(const In& in, const g::Net& net, const void* const* fwd, const g::Stash<T>& st,
                               uint4* bits, int m, cudaStream_t stream) {
  if (!takes<T>(net.d)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const Plan plan = forward_plan<T>(fwd, net.d);
  return by_width<T>(net.d.feat, [&](auto f) {
    return forward_f<T, decltype(f)::value, kStash>(in, net, st, bits, m, plan, stream);
  });
}

template <class T, bool kInputGrads>
inline cudaError_t run_chain(const g::Net& net, const void* const* chain, const g::Stash<T>& st, const uint4* bits,
                             const float* g_sigma, const float* g_rgb, float* dpe, float* dde, int m,
                             cudaStream_t stream) {
  if (!takes<T>(net.d)) return cudaErrorInvalidValue;
  const Plan plan = chain_plan<T>(chain, net.d, kInputGrads);
  return by_width<T>(net.d.feat, [&](auto f) {
    return chain_f<T, decltype(f)::value, kInputGrads>(net, st, bits, g_sigma, g_rgb, dpe, dde, m, plan, stream);
  });
}

}  // namespace nerf_tc
