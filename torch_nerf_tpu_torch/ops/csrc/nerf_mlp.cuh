// The NeRF MLP's kernels on Hopper: the training kernels shared by
// fused_nerf_bwd.cu (the backward of the fused field) and fused_train.cu (the
// fused train pass), and the encode, layer product and bias epilogue that
// fused_nerf_fwd.cu (the field's forward) runs too.
//
// The Pallas kernels they replace keep a whole tile's activations in VMEM
// between the forward and the backward and sum the parameter gradients over
// sequential grid steps. An SM has 227 KB, not ~100 MB, and blocks run in
// parallel, so the work is cut at other boundaries here:
//
//   1. mlp_forward_stash: PE + the 11-layer forward per 64-point tile, as
//      fused_nerf_fwd.cu, but every layer's bf16 output is also written to a
//      stash in device memory (pe 64, de 32, h0..h7 8 x 256, fc_8 features
//      256, h9 128 columns: 5 KB per point at width 256), with sigma and
//      rgb. Each layer's output goes from shared memory to its own (m, width)
//      matrix by bulk asynchronous copies, a row each, once the layer is
//      complete; a relu layer's sign bits go to a third stash (272 bytes
//      per point).
//   2. mlp_backward_chain: per 64-point tile, dz_out = g_rgb rgb (1 - rgb),
//      then dh = dz W^T layer by layer down to fc_in on the tensor cores,
//      dh rounded to bf16 into shared memory; a second pass over whole rows
//      applies the relu mask (the layer's stashed sign bits, loaded while
//      the product runs) and dz goes to a second stash (4.8 KB per point);
//      optionally dpe and dde and the encode VJP to dpts and ddirs.
//   3. dw_gemm: dW = A^T dZ and db = sum dZ for each layer, a hand-written
//      split-K tensor-core GEMM over the point axis: each block owns a
//      128 x 128 tile of dW and one slice of the points, streams 64-point
//      stages of A and dZ through a 3-deep cp.async ring, and writes an f32
//      partial; dw_reduce sums the partials in a fixed order into the public
//      layout. No atomics: the sums are the same from run to run.
//
// Bound on an H100 SXM: 3 x 1,186,816 FLOP per point (forward, dh chain,
// dW) at 989 TFLOP/s dense bf16, 2.83 ms for a fine pass of 786,432
// points. The stashes cost about 21 KB of device-memory traffic per point
// (10.2 KB written, 0.3 KB read by the masks, 10.6 KB read by the GEMMs at
// least once): 16.6 GB, ~5 ms at 3.35 TB/s for that pass. So device
// memory, not the tensor cores, bounds this design; keeping activations on
// chip across the backward is the way past it.
//
// Precision: bf16 operands, f32 accumulation. Forward roundings as
// nerf_apply(compute_dtype=bf16); in the backward every dh is rounded to
// bf16 before its relu mask and its next product, dW and db are summed in
// f32 (torch_nerf_tpu/ops/pallas/fused_nerf.py::_backward_tile).
//
// Weight layouts (built by torch_nerf_tpu_torch/ops/fused_nerf.py):
//   w[l]   B fragments (mma.m16n8k16) of layer l's padded weight W (K, N);
//   wt[l]  B fragments of W^T (N padded to 16, K): the backward's operand;
//   b[l]   bf16 bias padded with zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerf_mlp {

constexpr int kTileRows = 64;  // points per block of the forward and the chain
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
  const uint2* wt[kLayers];
  int feat;
  int pos_levels, dir_levels, include_input;
  int pe_dim, de_dim, pe_pad, de_pad;
};

// The two stashes, by column of the concatenations [pe, de, h0..h7, feat,
// h9] and [dz0..dz7, dz8, dz9, dz_out]. Each segment is its own row-major
// (m, width) bf16 matrix, the segments back to back: the segment at column
// c starts at element m * c, so a tile of a layer is one contiguous block.
struct Layout {
  int f, pe_pad, de_pad;
  __host__ __device__ int act_pe() const { return 0; }
  __host__ __device__ int act_de() const { return pe_pad; }
  __host__ __device__ int act_h(int l) const { return pe_pad + de_pad + l * f; }  // l = 0..7
  __host__ __device__ int act_feat() const { return pe_pad + de_pad + 8 * f; }
  __host__ __device__ int act_h9() const { return pe_pad + de_pad + 9 * f; }
  __host__ __device__ int act_cols() const { return pe_pad + de_pad + 9 * f + f / 2; }
  __host__ __device__ int dz(int l) const { return l * f; }  // fc_in..fc_7
  __host__ __device__ int dz8() const { return 8 * f; }      // f + 8 columns, public order
  __host__ __device__ int dz9() const { return 9 * f + 8; }
  __host__ __device__ int dz_out() const { return 9 * f + 8 + f / 2; }  // 8 columns
  __host__ __device__ int dz_cols() const { return 9 * f + 16 + f / 2; }
  // relu masks of h0..h7 and h9, one bit a column (byte c/8, bit c%8), by
  // byte column, each a (bits_rows(m), width/8) byte matrix: rows padded
  // to 16 so that every segment starts 16-byte aligned
  __host__ __device__ int bits_h(int l) const { return l * (f / 8); }  // l = 0..7
  __host__ __device__ int bits_h9() const { return f; }
  __host__ __device__ int bits_cols() const { return f + f / 16; }
  __host__ __device__ static size_t bits_rows(int m) { return (static_cast<size_t>(m) + 15) / 16 * 16; }
};

struct Stash {
  bf16* acts;      // (m, act_cols)
  bf16* dz;        // (m, dz_cols)
  uint8_t* bits;   // (m, bits_cols)
  float* sigma;    // (m,)
  float* rgb;      // (m, 3)
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

// points o + t d of `samples` depths per ray (ray = point / samples)
struct RayInput {
  const float* o;
  const float* d;
  const float* t;
  int samples;
  __device__ float pos(int i, int c) const {
    const size_t r = static_cast<size_t>(i / samples);
    return __fadd_rn(o[r * 3 + c], __fmul_rn(t[i], d[r * 3 + c]));
  }
  __device__ float dir(int i, int c) const {
    return d[static_cast<size_t>(i / samples) * 3 + c];
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// 16 bytes from global to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// Stash writes are bulk asynchronous copies (cp.async.bulk, shared ->
// global), one a row, issued by warp 0 once a tile is complete in shared
// memory (after a barrier); no thread waits for them. A buffer is written
// again only after stash_wait_read (warp 0, before the barrier that hands
// the buffer over) has seen every copy read its shared memory.
__device__ __forceinline__ void stash_rows(const bf16* src, int ld_src, bf16* dst, int width,
                                           int rows) {
  if (threadIdx.x >= 32) return;
  // the tile was written through the generic proxy; the copies read it
  // through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // the stash streams through L2: evict it first, keep the weights, which
  // every block reads again
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  for (int r = threadIdx.x; r < rows; r += 32) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::"l"(
            __cvta_generic_to_global(dst + static_cast<size_t>(r) * width)),
        "r"(smem_addr(src + r * ld_src)), "r"(width * 2), "l"(policy)
        : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// bit e of the byte: element e of the 8 bf16 in v is > 0 (as a 16-bit
// integer a bf16 is > 0 exactly when its value is)
__device__ __forceinline__ uint32_t relu_bits8(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bits |= (static_cast<int16_t>(w[k] & 0xffffu) > 0 ? 1u : 0u) << (2 * k);
    bits |= (static_cast<int16_t>(w[k] >> 16) > 0 ? 1u : 0u) << (2 * k + 1);
  }
  return bits;
}

// the 32-bit word k of 8 bf16 kept where bits 2k, 2k+1 are set
__device__ __forceinline__ uint32_t keep2(uint32_t word, uint32_t bits, int k) {
  const uint32_t lo = (bits >> (2 * k)) & 1u ? 0x0000ffffu : 0u;
  const uint32_t hi = (bits >> (2 * k + 1)) & 1u ? 0xffff0000u : 0u;
  return word & (lo | hi);
}

__device__ __forceinline__ void stash_wait_read() {
  if (threadIdx.x < 32) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// before the block exits: every copy complete
__device__ __forceinline__ void stash_wait_all() {
  if (threadIdx.x < 32) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// 1. forward with a stash of every activation

__host__ __device__ inline size_t forward_smem_bytes(int feat, int pe_pad, int de_pad) {
  return static_cast<size_t>(kTileRows) *
         ((pe_pad + kRowPad) + (de_pad + kRowPad) + 2 * (feat + kRowPad)) * sizeof(bf16);
}

template <class In>
__global__ void __launch_bounds__(kThreads, 2)
    mlp_forward_stash(In in, Net net, Stash st, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f = net.feat;
  const Layout lay = {f, net.pe_pad, net.de_pad};
  const size_t mm = m;
  const int ld_pe = net.pe_pad + kRowPad;
  const int ld_de = net.de_pad + kRowPad;
  const int ld_h = f + kRowPad;
  bf16* pe = reinterpret_cast<bf16*>(smem);
  bf16* de = pe + kTileRows * ld_pe;
  bf16* ha = de + kTileRows * ld_de;
  bf16* hb = ha + kTileRows * ld_h;
  const int row0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, m - row0);

  encode([&](int i, int c) { return in.pos(i, c); }, row0, m, net.pos_levels,
         net.include_input, net.pe_dim, net.pe_pad, pe, ld_pe);
  encode([&](int i, int c) { return in.dir(i, c); }, row0, m, net.dir_levels,
         net.include_input, net.de_dim, net.de_pad, de, ld_de);
  __syncthreads();

  // each layer's output goes to the stash from shared memory once the
  // layer is complete, in whole rows, while the next product only reads it;
  // the tile of the segment at column c, `width` wide:
  auto stash = [&](int c, int width) { return st.acts + mm * c + static_cast<size_t>(row0) * width; };
  stash_rows(pe, ld_pe, stash(lay.act_pe(), net.pe_pad), net.pe_pad, rows);
  stash_rows(de, ld_de, stash(lay.act_de(), net.de_pad), net.de_pad, rows);

  const Seg none = {nullptr, 0, 0};
  const Seg s_pe = {pe, ld_pe, net.pe_pad / 16};
  const Seg s_de = {de, ld_de, net.de_pad / 16};
  const Seg s_ha = {ha, ld_h, f / 16};
  const Seg s_hb = {hb, ld_h, f / 16};
  const bf162 zero2 = __float2bfloat162_rn(0.f);

  // a relu layer's output tile (`cols` wide) to the stash, and its relu
  // bits, which the backward's masks read in place of the output (a byte
  // a thread, consecutive threads on consecutive bytes)
  const size_t bits_rows = Layout::bits_rows(m);
  auto stash_relu = [&](const bf16* out, int cols, int act_col, int bits_col) {
    stash_rows(out, ld_h, stash(act_col, cols), cols, rows);
    const int chunks = cols / 8;
    uint8_t* bits = st.bits + bits_rows * bits_col + static_cast<size_t>(row0) * chunks;
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      bits[i] = static_cast<uint8_t>(relu_bits8(
          *reinterpret_cast<const uint4*>(out + (i / chunks) * ld_h + 8 * (i % chunks))));
    }
  };

  // relu(bf16(bf16(in W) + b)) to shared memory, then to the stash
  auto relu_layer = [&](Seg a, Seg b, int l, bf16* out) {
    const bf16* bias = net.b[l];
    tile_product(a, b, net.w[l], f / 8, 0, f / 8, [&](int r, int n, float v0, float v1) {
      *reinterpret_cast<bf162*>(out + r * ld_h + n) = __hmax2(bias_add(v0, v1, bias, n), zero2);
    });
    stash_wait_read();
    __syncthreads();
    stash_relu(out, f, lay.act_h(l), lay.bits_h(l));
  };

  relu_layer(s_pe, none, 0, ha);
  relu_layer(s_ha, none, 1, hb);
  relu_layer(s_hb, none, 2, ha);
  relu_layer(s_ha, none, 3, hb);
  relu_layer(s_hb, none, 4, ha);
  relu_layer(s_pe, s_ha, 5, hb);  // skip: fc_5 reads [pe, h4]
  relu_layer(s_hb, none, 6, ha);
  relu_layer(s_ha, none, 7, hb);

  // fc_8: column 0 is sigma, columns 1..f are the features (no relu)
  {
    const bf16* bias = net.b[8];
    tile_product(s_hb, none, net.w[8], f / 8 + 1, 0, f / 8 + 1,
                 [&](int r, int n, float v0, float v1) {
                   const bf162 y = bias_add(v0, v1, bias, n);
                   const bf16 v[2] = {__low2bfloat16(y), __high2bfloat16(y)};
#pragma unroll
                   for (int e = 0; e < 2; ++e) {
                     const int c = n + e;
                     if (c == 0) {
                       if (r < rows) st.sigma[row0 + r] = fmaxf(__bfloat162float(v[e]), 0.f);
                     } else if (c <= f) {
                       ha[r * ld_h + c - 1] = v[e];
                     }
                   }
                 });
    stash_wait_read();
    __syncthreads();
    stash_rows(ha, ld_h, stash(lay.act_feat(), f), f, rows);
  }

  // fc_9 reads [feat, de]
  {
    const bf16* bias = net.b[9];
    tile_product(s_ha, s_de, net.w[9], f / 16, 0, f / 16, [&](int r, int n, float v0, float v1) {
      *reinterpret_cast<bf162*>(hb + r * ld_h + n) = __hmax2(bias_add(v0, v1, bias, n), zero2);
    });
    stash_wait_read();
    __syncthreads();
    stash_relu(hb, f / 2, lay.act_h9(), lay.bits_h9());
  }

  // fc_out -> sigmoid
  {
    const bf16* bias = net.b[10];
    const Seg s_h9 = {hb, ld_h, f / 32};
    tile_product(s_h9, none, net.w[10], 1, 0, 1, [&](int r, int n, float v0, float v1) {
      const bf162 y = bias_add(v0, v1, bias, n);
      const float v[2] = {__low2float(y), __high2float(y)};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n + e;
        if (c < 3 && r < rows) {
          st.rgb[static_cast<size_t>(row0 + r) * 3 + c] = 1.f / (1.f + expf(-v[e]));
        }
      }
    });
  }
  stash_wait_all();
}

// ---------------------------------------------------------------------------
// 2. the backward chain

__host__ __device__ inline int chain_ld(int feat) { return feat + 16 + kRowPad; }

// two dz buffers, dsig, the tile of a layer's relu bits, then dpe and dde
// with input grads
__host__ __device__ inline size_t chain_smem_bytes(int feat, int pe_pad, int de_pad,
                                                   bool input_grads) {
  size_t bytes = 2u * kTileRows * chain_ld(feat) * sizeof(bf16) + kTileRows * sizeof(float) +
                 kTileRows * feat / 8;
  if (input_grads) bytes += static_cast<size_t>(kTileRows) * (pe_pad + de_pad) * sizeof(float);
  return bytes;
}

// g_sigma (m,), g_rgb (m, 3): cotangents of sigma and rgb. With kInputGrads,
// in gives the points and dpts, ddirs (m, 3) receive the input grads.
template <bool kInputGrads, class In>
__global__ void __launch_bounds__(kThreads, 2)
    mlp_backward_chain(In in, Net net, Stash st, const float* __restrict__ g_sigma,
                       const float* __restrict__ g_rgb, float* __restrict__ dpts,
                       float* __restrict__ ddirs, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f = net.feat;
  const Layout lay = {f, net.pe_pad, net.de_pad};
  const size_t mm = m;
  const int ld = chain_ld(f);
  bf16* bufa = reinterpret_cast<bf16*>(smem);
  bf16* bufb = bufa + kTileRows * ld;
  float* dsig = reinterpret_cast<float*>(bufb + kTileRows * ld);
  uint8_t* mbits = reinterpret_cast<uint8_t*>(dsig + kTileRows);  // (64, f/8)
  float* dpe = reinterpret_cast<float*>(mbits + kTileRows * f / 8);  // (64, pe_pad), kInputGrads only
  float* dde = dpe + kTileRows * net.pe_pad;   // (64, de_pad), kInputGrads only
  const int row0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, m - row0);
  const bf16 zero = __float2bfloat16_rn(0.f);
  const Seg none = {nullptr, 0, 0};

  // the tile of the dz segment at column c, `width` wide
  auto dz_tile = [&](int c, int width) { return st.dz + mm * c + static_cast<size_t>(row0) * width; };

  // dz_out = bf16(g_rgb rgb (1 - rgb)), 16 columns for the k16 product;
  // dsig = g_sigma where sigma > 0
  for (int i = threadIdx.x; i < kTileRows * 16; i += kThreads) {
    const int r = i >> 4;
    const int c = i & 15;
    float v = 0.f;
    if (c < 3 && r < rows) {
      const size_t k = static_cast<size_t>(row0 + r) * 3 + c;
      const float y = st.rgb[k];
      v = g_rgb[k] * y * (1.f - y);
    }
    bufa[r * ld + c] = __float2bfloat16_rn(v);
  }
  for (int r = threadIdx.x; r < kTileRows; r += kThreads) {
    dsig[r] = (r < rows && st.sigma[row0 + r] > 0.f) ? g_sigma[row0 + r] : 0.f;
  }
  __syncthreads();
  stash_rows(bufa, ld, dz_tile(lay.dz_out(), 8), 8, rows);

  // the products' epilogues round dh to bf16 into shared memory; the relu
  // masks then go over whole rows, 16 bytes a thread, and the rows to the
  // stash
  auto to_smem = [&](bf16* out) {
    return [=](int r, int n, float v0, float v1) {
      *reinterpret_cast<bf162*>(out + r * ld + n) = __floats2bfloat162_rn(v0, v1);
    };
  };
  // the relu bits of a layer (`cols` wide, at byte column bits_col) into
  // mbits while its product runs; done by cp_async_wait<0> before the
  // barrier after the product
  auto load_bits = [&](int cols, int bits_col) {
    const int bytes = kTileRows * cols / 8;
    const uint8_t* src = st.bits + Layout::bits_rows(m) * bits_col + static_cast<size_t>(row0) * (cols / 8);
    const int valid = rows * cols / 8;
    for (int i = threadIdx.x; 16 * i < bytes; i += kThreads) {
      cp_async16(smem_addr(mbits + 16 * i), 16 * i < valid ? src + 16 * i : src, 16 * i < valid ? 16 : 0);
    }
    cp_async_commit();
  };
  // dz = dh where the layer's relu output > 0 (its bits in mbits), in
  // place, then to the dz stash; rows past m are zeroed
  auto mask_rows = [&](bf16* buf, int cols, int dz_col) {
    const int chunks = cols / 8;
#pragma unroll 4
    for (int i = threadIdx.x; i < kTileRows * chunks; i += kThreads) {
      const int r = i / chunks;
      uint4* s = reinterpret_cast<uint4*>(buf + r * ld + 8 * (i - r * chunks));
      const uint32_t bits = r < rows ? mbits[i] : 0u;
      uint4 v = *s;
      v.x = keep2(v.x, bits, 0);
      v.y = keep2(v.y, bits, 1);
      v.z = keep2(v.z, bits, 2);
      v.w = keep2(v.w, bits, 3);
      *s = v;
    }
    stash_wait_read();
    __syncthreads();
    stash_rows(buf, ld, dz_tile(dz_col, cols), cols, rows);
  };
  // dh = in W_l^T for a relu layer l, then its mask: in -> out
  auto relu_layer = [&](bf16* in, int ktiles, int l, bf16* out) {
    load_bits(f, lay.bits_h(l));
    tile_product(Seg{in, ld, ktiles}, none, net.wt[l + 1], f / 8, 0, f / 8, to_smem(out));
    cp_async_wait<0>();
    __syncthreads();
    mask_rows(out, f, lay.dz(l));
  };

  // fc_out^T: (64, 16) x (16, f/2) -> mask h9 -> dz9
  load_bits(f / 2, lay.bits_h9());
  tile_product(Seg{bufa, ld, 1}, none, net.wt[10], f / 16, 0, f / 16, to_smem(bufb));
  cp_async_wait<0>();
  __syncthreads();
  mask_rows(bufb, f / 2, lay.dz9());

  // fc_9^T: (64, f/2) x (f/2, f + de_pad): dfeat -> dz8 columns 1..f, dde
  tile_product(Seg{bufb, ld, f / 32}, none, net.wt[9], (f + net.de_pad) / 8, 0,
               kInputGrads ? (f + net.de_pad) / 8 : f / 8,
               [&](int r, int n, float v0, float v1) {
                 const bf162 y = __floats2bfloat162_rn(v0, v1);
                 const bf16 v[2] = {__low2bfloat16(y), __high2bfloat16(y)};
#pragma unroll
                 for (int e = 0; e < 2; ++e) {
                   const int c = n + e;
                   if (c < f) {
                     bufa[r * ld + c + 1] = v[e];
                   } else if (kInputGrads) {
                     dde[r * net.de_pad + c - f] = __bfloat162float(v[e]);
                   }
                 }
               });
  // dz8 column 0 is dsig; columns f+1.. pad the k16 product with zeros
  for (int i = threadIdx.x; i < kTileRows * 16; i += kThreads) {
    const int r = i >> 4;
    const int c = i & 15;
    bufa[r * ld + (c == 0 ? 0 : f + c)] = c == 0 ? __float2bfloat16_rn(dsig[r]) : zero;
  }
  stash_wait_read();
  __syncthreads();
  stash_rows(bufa, ld, dz_tile(lay.dz8(), f + 8), f + 8, rows);

  // fc_8^T: (64, f + 16) x (f + 16, f) -> mask h7 -> dz7, then fc_7^T, fc_6^T
  relu_layer(bufa, f / 16 + 1, 7, bufb);
  relu_layer(bufb, f / 16, 6, bufa);
  relu_layer(bufa, f / 16, 5, bufb);

  // fc_5^T: (64, f) x (f, pe_pad + f): columns < pe_pad are dpe (skip), the
  // rest dh4 -> mask h4 -> dz4
  {
    const int pe_pad = net.pe_pad;
    load_bits(f, lay.bits_h(4));
    tile_product(Seg{bufb, ld, f / 16}, none, net.wt[5], (pe_pad + f) / 8,
                 kInputGrads ? 0 : pe_pad / 8, (pe_pad + f) / 8,
                 [&](int r, int n, float v0, float v1) {
                   const bf162 y = __floats2bfloat162_rn(v0, v1);
                   if (n >= pe_pad) {
                     *reinterpret_cast<bf162*>(bufa + r * ld + n - pe_pad) = y;
                   } else if (kInputGrads) {
                     dpe[r * pe_pad + n] = __low2float(y);
                     dpe[r * pe_pad + n + 1] = __high2float(y);
                   }
                 });
    cp_async_wait<0>();
    __syncthreads();
    mask_rows(bufa, f, lay.dz(4));
  }
  relu_layer(bufa, f / 16, 3, bufb);
  relu_layer(bufb, f / 16, 2, bufa);
  relu_layer(bufa, f / 16, 1, bufb);
  relu_layer(bufb, f / 16, 0, bufa);

  if (kInputGrads) {
    // fc_in^T: dpe += bf16(dz0 W_in^T)
    const int pe_pad = net.pe_pad;
    tile_product(Seg{bufa, ld, f / 16}, none, net.wt[0], pe_pad / 8, 0, pe_pad / 8,
                 [&](int r, int n, float v0, float v1) {
                   const bf162 y = __floats2bfloat162_rn(v0, v1);
                   dpe[r * pe_pad + n] += __low2float(y);
                   dpe[r * pe_pad + n + 1] += __high2float(y);
                 });
    __syncthreads();

    // encode VJP: d/dx sin(2^l x) = 2^l cos(2^l x), d/dx cos(2^l x) = -2^l sin(2^l x)
    const int base = net.include_input ? 3 : 0;
    for (int i = threadIdx.x; i < rows * 6; i += kThreads) {
      const int r = i / 6;
      const int c = i - 6 * r;
      const bool pos = c < 3;
      const int cc = pos ? c : c - 3;
      const float x = pos ? in.pos(row0 + r, cc) : in.dir(row0 + r, cc);
      const float* g = pos ? dpe + r * net.pe_pad : dde + r * net.de_pad;
      const int levels = pos ? net.pos_levels : net.dir_levels;
      float acc = net.include_input ? g[cc] : 0.f;
      for (int l = 0; l < levels; ++l) {
        const float fr = static_cast<float>(1 << l);
        float s, co;
        sincosf(x * fr, &s, &co);
        acc += fr * (co * g[base + 6 * l + cc] - s * g[base + 6 * l + 3 + cc]);
      }
      (pos ? dpts : ddirs)[static_cast<size_t>(row0 + r) * 3 + cc] = acc;
    }
  }
  stash_wait_all();
}

// ---------------------------------------------------------------------------
// 3. dW = A^T dZ and db = sum dZ, split along the points

constexpr int kGT = 128;         // dW tile: 128 rows (k) x 128 columns (n)
constexpr int kGM = 64;          // points per pipeline stage
constexpr int kGStages = 3;      // cp.async stages in flight
constexpr int kGLd = kGT + 8;    // shared-memory row stride (bf16): 272 bytes
constexpr int kGThreads = 256;   // 2 (k) x 4 (n) warps, each 64 x 32 of the tile
constexpr int kGBlocks = 264;    // blocks to aim for per job: one wave of 2 per SM

__host__ __device__ inline size_t gemm_smem_bytes() {
  return static_cast<size_t>(kGStages) * 2 * kGM * kGLd * sizeof(bf16);
}

// One layer's dW (or a row block of it, for a concatenated input) and db.
struct GemmJob {
  int a_col, k;       // A: the (m, k) activation segment at column a_col
  int dz_col, n;      // dZ: the (m, n) dz segment at column dz_col
  float* out;         // public dW (rows, out_ld) f32
  int out_ld, out_row0, rows_valid, cols_valid;
  float* db_out;      // public db, or null
  int tiles_k, tiles_n;
  int splits, chunk;  // the points split into `splits` slices of `chunk`
  float* ws;          // (splits, tiles_k * 128, tiles_n * 128) partials
  float* ws_db;       // (splits, tiles_n * 128) partials, when db_out
};

__global__ void __launch_bounds__(kGThreads, 2)
    dw_gemm(GemmJob job, const bf16* __restrict__ acts, const bf16* __restrict__ dz, int m) {
  extern __shared__ __align__(16) unsigned char gsmem[];
  bf16* sa = reinterpret_cast<bf16*>(gsmem);  // [stage][kGM][kGLd] points x k
  bf16* sd = sa + kGStages * kGM * kGLd;      // [stage][kGM][kGLd] points x n
  __shared__ float red[kGThreads];
  const int tk = blockIdx.x / job.tiles_n;
  const int tn = blockIdx.x - tk * job.tiles_n;
  const int k0 = tk * kGT;
  const int n0 = tn * kGT;
  const int mbeg = blockIdx.y * job.chunk;
  const int mend = min(m, mbeg + job.chunk);
  const int steps = mend > mbeg ? (mend - mbeg + kGM - 1) / kGM : 0;
  const bool do_db = job.db_out != nullptr && tk == 0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wk = warp >> 2;
  const int wn = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;

  // A and dZ: the (m, k) and (m, n) matrices of the job's segments
  const bf16* a_mat = acts + static_cast<size_t>(m) * job.a_col;
  const bf16* d_mat = dz + static_cast<size_t>(m) * job.dz_col;
  auto load = [&](int stage, int p0) {
    bf16* a_st = sa + stage * kGM * kGLd;
    bf16* d_st = sd + stage * kGM * kGLd;
    for (int c = tid; c < kGM * (kGT / 8); c += kGThreads) {
      const int r = c >> 4;
      const int cc = (c & 15) * 8;
      const int p = p0 + r;
      const bool va = p < mend && k0 + cc < job.k;
      const bf16* src = va ? a_mat + static_cast<size_t>(p) * job.k + k0 + cc : acts;
      cp_async16(smem_addr(a_st + r * kGLd + cc), src, va ? 16 : 0);
      const bool vd = p < mend && n0 + cc < job.n;
      src = vd ? d_mat + static_cast<size_t>(p) * job.n + n0 + cc : dz;
      cp_async16(smem_addr(d_st + r * kGLd + cc), src, vd ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float colsum = 0.f;

  // ldmatrix lanes: A^T fragments (rows k, columns points) and dZ fragments
  // (rows points, columns n), both from row-major (points, columns) tiles
  const int a_p = (lane & 7) + ((lane >> 4) << 3);
  const int a_k = ((lane >> 3) & 1) << 3;
  const int d_p = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int d_n = (lane >> 4) << 3;

  // stages s .. s + kGStages - 2 are in flight when stage s is consumed
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < steps) load(s, mbeg + s * kGM);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();
    // the stage consumed in the previous iteration is free for a new load
    const int next = s + kGStages - 1;
    if (next < steps) load(next % kGStages, mbeg + next * kGM);
    cp_async_commit();

    const bf16* A = sa + (s % kGStages) * kGM * kGLd;
    const bf16* D = sd + (s % kGStages) * kGM * kGLd;
#pragma unroll
    for (int j = 0; j < kGM / 16; ++j) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4_trans(a[i], smem_addr(A + (16 * j + a_p) * kGLd + wk * 64 + 16 * i + a_k));
#pragma unroll
      for (int q = 0; q < 2; ++q)
        ldmatrix_x4_trans(b[q], smem_addr(D + (16 * j + d_p) * kGLd + wn * 32 + 16 * q + d_n));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          mma_bf16(acc[i][2 * q], a[i], make_uint2(b[q][0], b[q][1]));
          mma_bf16(acc[i][2 * q + 1], a[i], make_uint2(b[q][2], b[q][3]));
        }
    }
    if (do_db) {
      const int col = tid & (kGT - 1);
      const int half = tid / kGT;
#pragma unroll
      for (int r = 0; r < kGM / 2; ++r) colsum += __bfloat162float(D[(half * (kGM / 2) + r) * kGLd + col]);
    }
  }
  cp_async_wait<0>();

  const int ld_ws = job.tiles_n * kGT;
  float* ws = job.ws + (static_cast<size_t>(blockIdx.y) * job.tiles_k * kGT) * ld_ws;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = k0 + wk * 64 + 16 * i + g + 8 * h;
        const int col = n0 + wn * 32 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(ws + static_cast<size_t>(row) * ld_ws + col) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  if (do_db) {
    red[tid] = colsum;
    __syncthreads();
    if (tid < kGT) {
      job.ws_db[static_cast<size_t>(blockIdx.y) * ld_ws + n0 + tid] = red[tid] + red[tid + kGT];
    }
  }
}

// out[(row0 + r) * out_ld + c] = sum over splits of ws[s][r][c], in split order
__global__ void dw_reduce(const float* __restrict__ ws, int splits, int ws_rows, int ws_cols,
                          float* __restrict__ out, int out_ld, int row0, int rows, int cols) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * cols) return;
  const int r = idx / cols;
  const int c = idx - r * cols;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += ws[(static_cast<size_t>(sp) * ws_rows + r) * ws_cols + c];
  out[static_cast<size_t>(row0 + r) * out_ld + c] = s;
}

// ---------------------------------------------------------------------------
// host side

inline size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// Split m points for a job of `tiles` dW tiles: about kGBlocks blocks, at
// least 512 points a slice, slices a multiple of the pipeline stage.
inline void gemm_splits(int m, int tiles, int* splits, int* chunk) {
  int s = (kGBlocks + tiles - 1) / tiles;
  const int most = (m + 511) / 512;
  if (s > most) s = most;
  if (s < 1) s = 1;
  int c = (m + s - 1) / s;
  c = (c + kGM - 1) / kGM * kGM;
  *chunk = c;
  *splits = c > 0 ? (m + c - 1) / c : 1;
  if (*splits < 1) *splits = 1;
}

// The 13 GEMM jobs of the 11 layers for m points (fc_5 and fc_9 read two
// stashed segments each). grads_w/grads_b: the public f32 gradients.
// ws == null only counts the partials' floats (db partials for every job).
inline int make_jobs(const Net& net, int m, float* const* grads_w, float* const* grads_b,
                     float* ws, GemmJob* jobs, size_t* ws_floats) {
  const int f = net.feat;
  const Layout lay = {f, net.pe_pad, net.de_pad};
  int n = 0;
  auto add = [&](int a_col, int k, int dz_col, int nn, int layer, int out_ld, int row0,
                 int rows_valid, int cols_valid, bool with_db) {
    GemmJob j;
    j.a_col = a_col;
    j.k = k;
    j.dz_col = dz_col;
    j.n = nn;
    j.out = grads_w ? grads_w[layer] : nullptr;
    j.out_ld = out_ld;
    j.out_row0 = row0;
    j.rows_valid = rows_valid;
    j.cols_valid = cols_valid;
    j.db_out = with_db && grads_b ? grads_b[layer] : nullptr;
    j.tiles_k = (k + kGT - 1) / kGT;
    j.tiles_n = (nn + kGT - 1) / kGT;
    gemm_splits(m, j.tiles_k * j.tiles_n, &j.splits, &j.chunk);
    j.ws = nullptr;
    j.ws_db = nullptr;
    jobs[n++] = j;
  };
  add(lay.act_pe(), net.pe_pad, lay.dz(0), f, 0, f, 0, net.pe_dim, f, true);
  for (int l = 1; l <= 4; ++l) add(lay.act_h(l - 1), f, lay.dz(l), f, l, f, 0, f, f, true);
  add(lay.act_pe(), net.pe_pad, lay.dz(5), f, 5, f, 0, net.pe_dim, f, true);
  add(lay.act_h(4), f, lay.dz(5), f, 5, f, net.pe_dim, f, f, false);
  add(lay.act_h(5), f, lay.dz(6), f, 6, f, 0, f, f, true);
  add(lay.act_h(6), f, lay.dz(7), f, 7, f, 0, f, f, true);
  add(lay.act_h(7), f, lay.dz8(), f + 8, 8, f + 1, 0, f, f + 1, true);
  add(lay.act_feat(), f, lay.dz9(), f / 2, 9, f / 2, 0, f, f / 2, true);
  add(lay.act_de(), net.de_pad, lay.dz9(), f / 2, 9, f / 2, f, net.de_dim, f / 2, false);
  add(lay.act_h9(), f / 2, lay.dz_out(), 8, 10, 3, 0, f / 2, 3, true);
  size_t total = 0;
  for (int i = 0; i < n; ++i) {
    GemmJob& j = jobs[i];
    const size_t w = static_cast<size_t>(j.splits) * j.tiles_k * kGT * j.tiles_n * kGT;
    const size_t b = j.db_out || !grads_b ? static_cast<size_t>(j.splits) * j.tiles_n * kGT : 0;
    if (ws) {
      j.ws = ws + total;
      j.ws_db = b ? ws + total + w : nullptr;
    }
    total += align256(w + b);
  }
  *ws_floats = total;
  return n;
}

// Bytes of the two stashes and sigma, rgb for m points.
inline size_t stash_bytes(int m, int feat, int pe_pad, int de_pad) {
  const Layout lay = {feat, pe_pad, de_pad};
  return align256(static_cast<size_t>(m) * lay.act_cols() * sizeof(bf16)) +
         align256(static_cast<size_t>(m) * lay.dz_cols() * sizeof(bf16)) +
         align256(Layout::bits_rows(m) * lay.bits_cols()) +
         align256(static_cast<size_t>(m) * sizeof(float)) +
         align256(static_cast<size_t>(m) * 3 * sizeof(float));
}

inline size_t gemm_ws_bytes(const Net& net, int m) {
  GemmJob jobs[16];
  size_t floats = 0;
  make_jobs(net, m, nullptr, nullptr, nullptr, jobs, &floats);
  return floats * sizeof(float);
}

inline Stash carve_stash(unsigned char* base, int m, int feat, int pe_pad, int de_pad,
                         size_t* used) {
  const Layout lay = {feat, pe_pad, de_pad};
  Stash st;
  size_t off = 0;
  st.acts = reinterpret_cast<bf16*>(base + off);
  off += align256(static_cast<size_t>(m) * lay.act_cols() * sizeof(bf16));
  st.dz = reinterpret_cast<bf16*>(base + off);
  off += align256(static_cast<size_t>(m) * lay.dz_cols() * sizeof(bf16));
  st.bits = base + off;
  off += align256(Layout::bits_rows(m) * lay.bits_cols());
  st.sigma = reinterpret_cast<float*>(base + off);
  off += align256(static_cast<size_t>(m) * sizeof(float));
  st.rgb = reinterpret_cast<float*>(base + off);
  off += align256(static_cast<size_t>(m) * 3 * sizeof(float));
  *used = off;
  return st;
}

template <class Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The dW/db GEMMs of every layer, then the reductions into the public grads.
inline cudaError_t run_gemms(const Net& net, const Stash& st, int m, float* ws,
                             float* const* grads_w, float* const* grads_b, cudaStream_t stream) {
  GemmJob jobs[16];
  size_t floats = 0;
  const int n = make_jobs(net, m, grads_w, grads_b, ws, jobs, &floats);
  cudaError_t err = set_smem(dw_gemm, gemm_smem_bytes());
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n; ++i) {
    const GemmJob& j = jobs[i];
    dim3 grid(j.tiles_k * j.tiles_n, j.splits);
    dw_gemm<<<grid, kGThreads, gemm_smem_bytes(), stream>>>(j, st.acts, st.dz, m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  for (int i = 0; i < n; ++i) {
    const GemmJob& j = jobs[i];
    const int ws_rows = j.tiles_k * kGT;
    const int ws_cols = j.tiles_n * kGT;
    const int count = j.rows_valid * j.cols_valid;
    dw_reduce<<<(count + 255) / 256, 256, 0, stream>>>(j.ws, j.splits, ws_rows, ws_cols, j.out,
                                                       j.out_ld, j.out_row0, j.rows_valid,
                                                       j.cols_valid);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (j.db_out) {
      dw_reduce<<<(j.cols_valid + 255) / 256, 256, 0, stream>>>(j.ws_db, j.splits, 1, ws_cols,
                                                                j.db_out, j.cols_valid, 0, 1,
                                                                j.cols_valid);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

inline Net make_net(const void* const* wf, const void* const* bias, const void* const* wt, int feat,
                    int pos_levels, int dir_levels, int include_input, int pe_dim, int de_dim,
                    int pe_pad, int de_pad) {
  Net net;
  for (int l = 0; l < kLayers; ++l) {
    net.w[l] = static_cast<const uint2*>(wf[l]);
    net.b[l] = static_cast<const bf16*>(bias[l]);
    net.wt[l] = wt ? static_cast<const uint2*>(wt[l]) : nullptr;
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

// forward with stash, then the backward chain: the part both kernels share
template <class In>
inline cudaError_t run_forward(const In& in, const Net& net, const Stash& st, int m,
                               cudaStream_t stream) {
  const size_t smem = forward_smem_bytes(net.feat, net.pe_pad, net.de_pad);
  cudaError_t err = set_smem(mlp_forward_stash<In>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kTileRows - 1) / kTileRows);
  mlp_forward_stash<In><<<grid, kThreads, smem, stream>>>(in, net, st, m);
  return cudaGetLastError();
}

template <bool kInputGrads, class In>
inline cudaError_t run_chain(const In& in, const Net& net, const Stash& st, const float* g_sigma,
                             const float* g_rgb, float* dpts, float* ddirs, int m,
                             cudaStream_t stream) {
  const size_t smem = chain_smem_bytes(net.feat, net.pe_pad, net.de_pad, kInputGrads);
  cudaError_t err = set_smem(mlp_backward_chain<kInputGrads, In>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kTileRows - 1) / kTileRows);
  mlp_backward_chain<kInputGrads, In>
      <<<grid, kThreads, smem, stream>>>(in, net, st, g_sigma, g_rgb, dpts, ddirs, m);
  return cudaGetLastError();
}

}  // namespace nerf_mlp
