// The NeRF MLP's general route on Hopper's tensor cores: the forward (kernel
// 1), the forward with its stash and the backward chain (kernels 2 and 3)
// for every config the wgmma templates of nerf_mlp_train.cuh do not take:
// bf16 at every padded width F % 32 == 0 up to 1024 with encodings up to
// 128 wide (route wgmma_general), and f32 at the same widths and encodings
// on wgmma's bf16 product over three bf16 pieces of each operand (route
// f32_wgmma). The stashes are nerf_stash.cuh's, row-major: its encode VJP
// and its dW GEMM (nerf_dw_tc.cuh: wgmma on TMA-loaded stash tiles, the
// same three bf16 pieces for f32, a fixed-order reduce) are used as they are.
//
// Replaces, on those configs, the Pallas TPU kernels torch_nerf_tpu/ops/
// pallas/fused_nerf.py::_fwd_kernel and _bwd_kernel and fused_train.py::
// _train_kernel.
//
// Design: nerf_mlp_train.cuh's engine carried over to any width. A CTA owns
// 64 points; a producer warpgroup streams every layer's weights, one K-slice
// (64 columns: 128 bf16 bytes of every image row of the current pass) a
// stage, through a ring of 2-4 shared-memory stages by bulk asynchronous
// copies on mbarriers, so each weight is read from L2 once a tile, not by
// every warp. The two consumer warpgroups share the tile's 64 rows and
// take a layer's output columns in column passes: pass p of an F-wide
// layer is columns [2p NP, 2p NP + 2 NP), NP of them a warpgroup, so a
// warpgroup's 64 x NP f32 sum is NP / 2 registers a thread whatever F is
// (NP a template value, F a runtime one; kernel 1-3's plan picks NP and
// the passes, nerf_mlp_tc.cuh::choose). A layer's output overwrites its
// input in place, so the outputs of a layer's earlier passes wait in
// registers (bf16 packed in pairs) until both warpgroups are done with its
// last pass (a barrier of the 256 consumer threads): at F = 1024, NP = 128,
// 3 x 32 held registers beside a 64-register sum, where a second 128 KB
// activation tile does not fit beside the ring. Then they go to the tile
// and on to the stash row-major, 16 bytes a thread; a relu layer's sign
// bits go to a bits stash, one word a thread per 32 sums of a pass in the
// accumulator's order, which the chain's thread of the same columns reads
// back as its mask. The two encodings share one tile: fc_9's direction
// encoding is written where fc_in and fc_5's position encoding was, once
// fc_5 is done with it. The forward's fc_8 sigma group is an n8 product
// beside each pass's features (the upper warpgroup writes it on the first
// pass); fc_9 (F / 2 outputs) takes the same passes at NP / 2 columns a
// warpgroup; the chain's input grads (kernel 2: fc_9's de rows, fc_5's
// and fc_in's pe rows) are products of their own, 64 columns a warpgroup,
// the encodings padded to 128. A width off the 64s ends each trunk input
// on a half K-slice, read for its two k16 steps only: the activation
// tile's columns past F are never read.
//
// f32 keeps 4 bytes a column: its tile holds as bf16's does up to F = 512
// (128 KB), an earlier pass's outputs held as f32 (NP / 2 registers a
// pass beside the NP of a pass's sums and its slice's fold), so a kernel
// of NP columns holds at most f32_pass_cap(NP) passes. Past 512 a 64-point
// f32 tile (256 KB at 1024) does not fit a block's 227 KB, and the
// kernels stream (kStream): each layer's outputs go straight from the
// registers to device memory, the stash (kernels 2-3) or two scratch
// buffers in turn and one for h9 (kernel 1), and the next layer's A comes
// back from there (L2) into registers, a K-slice whole while the slice
// before it is multiplied (product_f32_raw); shared memory holds the
// encodings, the chain's x panel and the ring. No layer overwrites its
// input, so nothing is held. (A 2-CTA cluster holding half the tile each
// would read half of every A from its partner by DSMEM and wait on it
// twice a layer, and its halves split fc_9's F / 2 columns off the
// panels: PERF.md, section 6.)
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
// weights stream from L2 once a 64-point tile: 2 x 64 x F^2 FLOP over F^2
// weights, 64 FLOP a byte at every width; a CTA pair multicasting the ring
// to halve that ran slower (a CTA waits on its partner's releases:
// PERF.md, section 6).
//
// Layout contract with torch_nerf_tpu_torch/ops/fused_nerf.py::tc_layout
// (F the padded width; every K segment padded to 64 columns; a layer's
// image pass after pass, each pass's rows K-slice after K-slice):
//   fwd[l]   B = W^T (rows the layer's outputs, 2 NP a pass, the rows past
//            F zero; fc_8 2 NP + 8 a pass, its features then sigma; fc_9
//            NP a pass over F/2; fc_out 8), columns its inputs (fc_5's
//            [h4, pe], fc_9's [features, de]), each slice rows x 128 bytes
//            of bf16 at the 128-byte swizzle; f32: each slice's three piece
//            images, the smallest first;
//   chain[l] B = W (rows the layer's inputs, 2 NP a pass; columns its
//            outputs): fc_out (NP a pass over F/2, 64); fc_9 its feature
//            rows (F, F/2 padded); fc_8 (F, F padded + 64), sigma in the
//            last slice's first column; fc_5 its h4 rows; chain[0] fc_in's
//            pe rows (128, F); chain[11], chain[12] fc_5's pe rows and
//            fc_9's de rows (128, ...): the input-grad products;
//   b[l]     nerf_stash.cuh's Net: the biases in the forward's column
//            order, zero-padded to every column of their layer's passes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "nerf_mlp_train.cuh"
#include "nerf_stash.cuh"
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
constexpr int kSmemLimit = 232448;  // a block's shared memory
constexpr int kSmemPerSM = 233472;  // an SM's, 1 KB of it reserved a block
constexpr int kSlack = 1024 + 2 * kMaxStages * 8;  // the barriers and up to 1023 bytes to align
constexpr int kChainPe = 11, kChainDe = 12, kChainImages = 13;
constexpr int kMaxPasses = 4;   // column passes of a tile kernel's layer: F = 1024 at 128 columns a warpgroup
constexpr int kPassCap = 128;   // a warpgroup's columns a pass where a layer takes several
constexpr int kPassMin = 96;    // ... and at least this many
constexpr int kPairMax = 80;    // the widest bf16 pass width two CTAs an SM hold
constexpr int kSigmaRows = 8;   // fc_8's sigma group beside each pass's features
constexpr int kF32TileMax = 512;  // the widest f32 config whose 64-point tile fits a block
constexpr int kTrash = kConsumers * 8;  // a streaming kernel's per-thread sink for padding columns

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

// passes of a layer that a bf16 kernel of pass width NP holds: several at
// kPassMin..kPassCap columns a warpgroup (their outputs wait in registers
// as packed bf16), else one
__host__ __device__ constexpr int bf16_pass_cap(int np) { return np >= kPassMin && np <= kPassCap ? kMaxPasses : 1; }

// ... and an f32 kernel of several passes: the earlier passes' outputs
// wait as f32, NP / 2 registers each, beside a pass's NP / 2 sums and its
// slice's NP / 2 (product_f32): (cap + 1) x NP / 2 <= 160, as bf16's 1024
// (64 + 96); 0 where no kernel of several passes is built at NP
__host__ __device__ constexpr int f32_pass_cap(int np) { return np == 64 ? 4 : np == 80 ? 3 : np == 96 ? 2 : 0; }

// CTAs an SM: two at a narrow bf16 pass (a small layer's barriers and ring
// waits in one CTA overlap the other's products; each then has 96
// registers a consumer thread and half an SM's shared memory), else one.
// The chain with input grads keeps one: its input-grad products' sums
// beside a pass's spill at 96 registers.
template <class T, int NP, bool kInputGrads = false>
__host__ __device__ constexpr int ctas() {
  return sizeof(T) == 2 && NP <= kPairMax && !kInputGrads ? 2 : 1;
}

// a consumer thread's registers after setmaxnreg (the producer keeps 40):
// one CTA an SM, 232; two, 96 (384 threads x 80 at launch, the producer's
// 40 freed to the consumers)
template <class T, int NP, bool kInputGrads = false>
__host__ __device__ constexpr int consumer_regs() {
  return ctas<T, NP, kInputGrads>() == 2 ? 96 : 232;
}

// a block's shared memory at `ctas` CTAs an SM
__host__ __device__ constexpr int block_smem(int ctas) { return ctas == 2 ? kSmemPerSM / 2 - 1024 : kSmemLimit; }

// A kernel of several passes (its F a runtime value) gives both encodings
// one tile, de written where pe was once fc_5 is done with it: without it
// 1024 with two 128-wide encodings gets one ring stage. A kernel of one
// pass keeps a tile each, both encoded at the start, and reads every
// trunk input to its pass's width 2 NP (F itself, or F and the zero
// columns of the pass's padding): its K-slice loops then have compile-time
// trip counts. Encoding de between the products, or loops whose trip
// counts follow a runtime F, made ptxas serialize the wgmma of such a
// kernel (warnings C7520, C7512) and cost path B's kernel 2 ~16% (PERF.md,
// section 6). A streaming kernel keeps a tile each (its shared memory
// holds no activations).

// sign-bit words of a pass a thread: one for each 32 of its n / 2 sums
__host__ __device__ constexpr int bit_words(int n) { return cdiv(n / 2, 32); }

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
  int np;      // a warpgroup's columns a pass of an F-wide layer
  int passes;  // column passes of a layer
  int words;   // sign-bit words a slot a thread: passes x bit_words(np)
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
// A_s (slice s of the A source, read for its k16 steps) x the stage's image
// rows [b_row, b_row + N) (byte offset b_off = 128 b_row). With N2 > 0,
// acc2 (64 x N2) takes rows at b2_off as well. Both warpgroups run every
// product (a product in a warpgroup-divergent branch makes ptxas serialize
// the kernel's wgmma), so a small product that one warpgroup needs
// (fc_out, fc_8's sigma group) is run by both.

// A's K-slices: the n0 slices of the tile at base0, the last of them read
// for k0 k16 steps, then the n1 slices at base1 (an encoding, or the
// chain's x panel), the last read for k1. A trunk input of a width off the
// 64s ends on a half slice, read for its two k16 steps: the tile's columns
// past F are never read. A streaming kernel's first n0 slices are a
// row-major f32 buffer in device memory instead (g: the tile's first row,
// gld floats a row; null for a tile).
struct ASrc {
  uint32_t base0;
  int n0, k0;
  uint32_t base1;
  int n1, k1;
  const float* g;
  int gld;
  __device__ __forceinline__ int count() const { return n0 + n1; }
  template <class T>
  __device__ __forceinline__ uint32_t slice(int s) const {
    return s < n0 ? slice_addr<T>(base0, s) : slice_addr<T>(base1, s - n0);
  }
  __device__ __forceinline__ int steps(int s) const { return s == n0 - 1 ? k0 : s == n0 + n1 - 1 ? k1 : 4; }
};

// the `cols` columns of the tile at base, then those of a second
__device__ __forceinline__ ASrc a_of(uint32_t base, int cols, uint32_t base1 = 0u, int cols1 = 0) {
  return {base, slices(cols), last_k(cols), base1, cols1 > 0 ? slices(cols1) : 0, cols1 > 0 ? last_k(cols1) : 4,
          nullptr, 0};
}

// the `cols` columns of rows [row0, row0 + 64) of a row-major (m_pad, ld)
// buffer, then those of the tile at base1
__device__ __forceinline__ ASrc a_rows(const float* buf, int ld, int row0, int cols, uint32_t base1 = 0u,
                                       int cols1 = 0) {
  ASrc a = a_of(0u, cols, base1, cols1);
  a.g = buf + static_cast<size_t>(row0) * ld;
  a.gld = ld;
  return a;
}

template <int N, int N2>
__device__ __forceinline__ void product_bf16(Ring& ring, const ASrc& src, uint32_t b_off, uint32_t b2_off,
                                             float (&acc)[N / 2], float (&acc2)[N2 > 0 ? N2 / 2 : 1]) {
  const int slices = src.count();
  for (int s = 0; s < slices; ++s) {
    const int slot = ring.it % ring.stages;
    await_phase(&ring.full[slot], (ring.it / ring.stages) & 1);
    const uint32_t b = smem_u32(ring.stage + slot * ring.stage_bytes);
    const uint32_t a = src.slice<bf16>(s);
    const int ks = src.steps(s);
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
// panels): the four pairs of wgmma's register A fragment, {(r0, c0), (r0 +
// 8, c0), (r0, c0 + 8), (r0 + 8, c0 + 8)}
__device__ __forceinline__ void lds_fragment(uint32_t a, int k, float2 (&v)[4]) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const uint32_t panel = a + (k >> 1) * kPanel;
  const int c0 = 16 * (k & 1) + 2 * (lane & 3);
  // rows r0 and r0 + 8 share r % 8, so one swizzled chunk offset serves both
  auto at = [&](int r, int c) { return panel + r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2)); };
  lds_f32x2(at(r0, c0), v[0].x, v[0].y);
  lds_f32x2(at(r0 + 8, c0), v[1].x, v[1].y);
  lds_f32x2(at(r0, c0 + 8), v[2].x, v[2].y);
  lds_f32x2(at(r0 + 8, c0 + 8), v[3].x, v[3].y);
}

// ... as wgmma's register A fragment, in its three bf16 pieces
__device__ __forceinline__ void load_a_pieces(uint32_t a, int k, uint32_t (&q)[3][4]) {
  float2 v[4];
  lds_fragment(a, k, v);
#pragma unroll
  for (int e = 0; e < 4; ++e) split3(v[e].x, v[e].y, q[0][e], q[1][e], q[2][e]);
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
template <int N, int N2, class Load>
__device__ __forceinline__ void stage_products(int j, int ks, uint32_t b, uint32_t b_off, uint32_t b2_off,
                                               float (&part)[N / 2], float (&part2)[N2 > 0 ? N2 / 2 : 1],
                                               Load load) {
  uint32_t q[3][4];
  // the products x_i w_j of this stage: i from 0, or from 1 when x0 w0
  // waits for its own pass below; load(k, q) puts k16 step k's A pieces in q
  auto products = [&](int i0, int i1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < ks) {
        if (k > 0) {
          wg_wait<0>();
          fence_regs(q);
        }
        load(k, q);
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
}

// a K-slice's three stages (W's pieces w2, w1, w0) into a fresh
// accumulator, folded into acc (s the slice's index: slice 0 starts acc);
// load(k, q) puts the slice's k16 step k's A pieces in q
template <int N, int N2, class Load>
__device__ __forceinline__ void slice_products(Ring& ring, int s, int ks, uint32_t b_off, uint32_t b2_off,
                                               float (&acc)[N / 2], float (&acc2)[N2 > 0 ? N2 / 2 : 1],
                                               Load load) {
  constexpr int M2 = N2 > 0 ? N2 / 2 : 1;
  float part[N / 2], part2[M2];
#pragma unroll
  for (int j = 2; j >= 0; --j) {  // W's piece in this stage
    const int slot = ring.it % ring.stages;
    await_phase(&ring.full[slot], (ring.it / ring.stages) & 1);
    stage_products<N, N2>(j, ks, smem_u32(ring.stage + slot * ring.stage_bytes), b_off, b2_off, part, part2, load);
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

template <int N, int N2>
__device__ __forceinline__ void product_f32(Ring& ring, const ASrc& src, uint32_t b_off, uint32_t b2_off,
                                            float (&acc)[N / 2], float (&acc2)[N2 > 0 ? N2 / 2 : 1]) {
  const int slices = src.count();
  for (int s = 0; s < slices; ++s) {
    const uint32_t a = src.slice<float>(s);
    slice_products<N, N2>(ring, s, src.steps(s), b_off, b2_off, acc, acc2,
                          [&](int k, uint32_t (&q)[3][4]) { load_a_pieces(a, k, q); });
  }
}

// a K-slice of A as the warp's raw f32 fragments: k16 step k's four pairs
// {(r0, c0), (r0 + 8, c0), (r0, c0 + 8), (r0 + 8, c0 + 8)} (lds_fragment's
// order), from device memory for a streaming kernel's first segment, else
// from the tile; the steps past the slice's are not read
__device__ __forceinline__ void load_raw(const ASrc& src, int s, float2 (&v)[4][4]) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const int ks = src.steps(s);
  if (src.g != nullptr && s < src.n0) {
    const float* p = src.g + static_cast<size_t>(r0) * src.gld + kSliceCols * s + 2 * (lane & 3);
    const size_t r8 = static_cast<size_t>(8) * src.gld;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < ks) {
        v[k][0] = *reinterpret_cast<const float2*>(p + 16 * k);
        v[k][1] = *reinterpret_cast<const float2*>(p + r8 + 16 * k);
        v[k][2] = *reinterpret_cast<const float2*>(p + 16 * k + 8);
        v[k][3] = *reinterpret_cast<const float2*>(p + r8 + 16 * k + 8);
      }
    }
  } else {
    const uint32_t a = src.slice<float>(s);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < ks) lds_fragment(a, k, v[k]);
  }
}

// f32 for a streaming kernel: product_f32's products in its order (the
// same sums bit for bit), each K-slice's raw A loaded whole before the
// slice's products and split into pieces at each k16 step, the next
// slice's loads issued as this one's products start, so that a slice's
// reads from device memory (L2) wait behind the products of the slice
// before it, not in front of each k16 step
template <int N, int N2>
__device__ __forceinline__ void product_f32_raw(Ring& ring, const ASrc& src, uint32_t b_off, uint32_t b2_off,
                                                float (&acc)[N / 2], float (&acc2)[N2 > 0 ? N2 / 2 : 1]) {
  float2 cur[4][4], nxt[4][4];
  const int slices = src.count();
  load_raw(src, 0, cur);
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) load_raw(src, s + 1, nxt);
    slice_products<N, N2>(ring, s, src.steps(s), b_off, b2_off, acc, acc2, [&](int k, uint32_t (&q)[3][4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) split3(cur[k][e].x, cur[k][e].y, q[0][e], q[1][e], q[2][e]);
    });
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) cur[k][e] = nxt[k][e];
  }
}

// the product of one layer: b_row the warpgroup's first image row; a
// streaming kernel's (kStream) f32 products read A as product_f32_raw does
template <class T, int N, int N2 = 0, bool kStream = false>
__device__ __forceinline__ void product(Ring& ring, const ASrc& src, int b_row, float (&acc)[N / 2],
                                        float (&acc2)[N2 > 0 ? N2 / 2 : 1], int b2_row = 0) {
  if constexpr (sizeof(T) == 2) {
    product_bf16<N, N2>(ring, src, 128u * b_row, 128u * b2_row, acc, acc2);
  } else if constexpr (kStream) {
    product_f32_raw<N, N2>(ring, src, 128u * b_row, 128u * b2_row, acc, acc2);
  } else {
    product_f32<N, N2>(ring, src, 128u * b_row, 128u * b2_row, acc, acc2);
  }
}

// ---------------------------------------------------------------------------
// epilogues: the warpgroup's 64 x N sums of a pass (columns col0..) into
// the tile. Every column is written, those past the layer's width too (the
// last pass's padding: the tile and the biases cover every pass's columns,
// and no product reads them): a store under a thread-dependent branch
// draws the sums' reads into it, and ptxas then serializes the kernel's
// wgmma behind an arrive in that branch.

// a thread's sign-bit words of one (slot, pass): word j at b[j * stride],
// stride a word for each consumer thread of the grid
__device__ __forceinline__ size_t bits_stride() { return static_cast<size_t>(gridDim.x) * kConsumers; }

// slot `slot` (the forward layer whose relu it is), pass p of this CTA's
// thread: `words` words a slot, bit_words(NP) a pass
template <int NP>
__device__ __forceinline__ uint32_t* bits_at(const uint32_t* bits, int words, int slot, int p) {
  return const_cast<uint32_t*>(bits) + static_cast<size_t>(slot * words + p * bit_words(NP)) * bits_stride() +
         static_cast<size_t>(blockIdx.x) * kConsumers + threadIdx.x;
}

template <int W>
__device__ __forceinline__ void store_bits(uint32_t* b, const uint32_t (&w)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) b[j * bits_stride()] = w[j];
}

template <int W>
__device__ __forceinline__ void load_bits(const uint32_t* b, uint32_t (&w)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) w[j] = b[j * bits_stride()];
}

__device__ __forceinline__ bool bit(const uint32_t* w, int i) { return (w[i >> 5] >> (i & 31)) & 1u; }

__device__ __forceinline__ void set_bits(uint32_t* w, int i, float y0, float y1) {
  w[i >> 5] |= (y0 > 0.f ? 1u : 0u) << (i & 31);
  w[(i + 1) >> 5] |= (y1 > 0.f ? 1u : 0u) << ((i + 1) & 31);
}

template <class T>
__device__ __forceinline__ void store2(unsigned char* tile, int r, int c, float v0, float v1) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<bf162*>(tile + swz<T>(r, c)) = __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<float2*>(tile + swz<T>(r, c)) = make_float2(v0, v1);
  }
}

// where an epilogue's pairs go: the tile's swizzled panels ...
struct TileOut {
  unsigned char* tile;
  template <class T>
  __device__ __forceinline__ void put(int r, int c, float v0, float v1) const {
    store2<T>(tile, r, c, v0, v1);
  }
};

// ... or, in a streaming kernel, rows [row0, row0 + 64) of a row-major f32
// (m_pad, ld) buffer (p: row row0): a pass's padding columns, at or past
// `width`, go to the thread's sink by a select of the address, not a
// branch (see above)
struct RowOut {
  float* p;
  int ld, width;
  float2* trash;
  template <class T>
  __device__ __forceinline__ void put(int r, int c, float v0, float v1) const {
    float2* dst = c < width ? reinterpret_cast<float2*>(p + static_cast<size_t>(r) * ld + c) : trash;
    *dst = make_float2(v0, v1);
  }
};

// relu(bias(acc)) as nerf_apply rounds it, and with kBits the sign bits
template <class T, int N, bool kBits, class Out>
__device__ __forceinline__ void relu_out(const float (&acc)[N / 2], const void* bias, int col0, const Out& out,
                                         uint32_t* bits, int t) {
  uint32_t w[bit_words(N)] = {};
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int r = acc_row(t, i);
    const int c = col0 + acc_col(t, i);
    float y0, y1;
    if constexpr (sizeof(T) == 2) {
      const bf162 y = __hmax2_nan(g::Elem<bf16>::bias2(acc[i], acc[i + 1], bias, c), __float2bfloat162_rn(0.f));
      *reinterpret_cast<bf162*>(out.tile + swz<T>(r, c)) = y;
      y0 = __low2float(y);
      y1 = __high2float(y);
    } else {
      const float* b = static_cast<const float*>(bias);
      y0 = relu_nan(acc[i] + b[c]);
      y1 = relu_nan(acc[i + 1] + b[c + 1]);
      out.template put<T>(r, c, y0, y1);
    }
    if constexpr (kBits) set_bits(w, i, y0, y1);
  }
  if constexpr (kBits) store_bits(bits, w);
}

// acc rounded to T, kept where the sign bits w are set (all of it without
// kMask): dh masked by its input's relu
template <class T, int N, bool kMask, class Out>
__device__ __forceinline__ void dz_out(const float (&acc)[N / 2], const uint32_t (&w)[bit_words(N)], int col0,
                                       const Out& out, int t) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    float v0 = g::Elem<T>::round(acc[i]);
    float v1 = g::Elem<T>::round(acc[i + 1]);
    if (kMask) {
      if (!bit(w, i)) v0 = 0.f;
      if (!bit(w, i + 1)) v1 = 0.f;
    }
    out.template put<T>(acc_row(t, i), col0 + acc_col(t, i), v0, v1);
  }
}

// ---------------------------------------------------------------------------
// the outputs of a layer's earlier passes, held in registers until both
// warpgroups are done with its last pass (the layer overwrites its input):
// slot q holds pass q's N columns a warpgroup, a pair of sums a word,
// packed bf16 or, in f32, as they are

template <class T>
using HeldWord = std::conditional_t<sizeof(T) == 2, uint32_t, float2>;

template <class T, int N, int kP>
struct Held {
  HeldWord<T> v[kP > 1 ? kP - 1 : 1][N / 4];
};

// y(i), the pair of sums i and i + 1 of pass p, into slot p: p is a
// runtime value and v a register array, so each slot takes it under a
// predicate
template <class T, int N, int kP, class Y>
__device__ __forceinline__ void hold(Held<T, N, kP>& h, int p, Y y) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const HeldWord<T> v = y(i);
#pragma unroll
    for (int q = 0; q < kP - 1; ++q)
      if (q == p) h.v[q][i >> 1] = v;
  }
}

// slots 0 .. n - 2 to the tile, pass q at columns col(q)..
template <class T, int N, int kP, class Col>
__device__ __forceinline__ void unhold(const Held<T, N, kP>& h, int n, unsigned char* tile, int t, Col col) {
#pragma unroll
  for (int q = 0; q < kP - 1; ++q) {
    if (q < n - 1) {
      const int col0 = col(q);
#pragma unroll
      for (int i = 0; i < N / 2; i += 2)
        *reinterpret_cast<HeldWord<T>*>(tile + swz<T>(acc_row(t, i), col0 + acc_col(t, i))) = h.v[q][i >> 1];
    }
  }
}

// relu_out's pairs (and sign bits) of pass p, held
template <class T, int N, int kP, bool kBits>
__device__ __forceinline__ void hold_relu(Held<T, N, kP>& h, int p, const float (&acc)[N / 2], const void* bias,
                                          int col0, uint32_t* bits, int t) {
  uint32_t w[bit_words(N)] = {};
  hold(h, p, [&](int i) {
    if constexpr (sizeof(T) == 2) {
      const bf162 y = __hmax2_nan(g::Elem<bf16>::bias2(acc[i], acc[i + 1], bias, col0 + acc_col(t, i)),
                                  __float2bfloat162_rn(0.f));
      if constexpr (kBits) set_bits(w, i, __low2float(y), __high2float(y));
      return nerf_train::bits_of(y);
    } else {
      const float* b = static_cast<const float*>(bias);
      const int c = col0 + acc_col(t, i);
      const float2 y = make_float2(relu_nan(acc[i] + b[c]), relu_nan(acc[i + 1] + b[c + 1]));
      if constexpr (kBits) set_bits(w, i, y.x, y.y);
      return y;
    }
  });
  if constexpr (kBits) store_bits(bits, w);
}

// the bias sums of pass p (fc_8's features: bf16(bf16(acc) + b) in bf16),
// held
template <class T, int N, int kP>
__device__ __forceinline__ void hold_bias(Held<T, N, kP>& h, int p, const float (&acc)[N / 2], const void* bias,
                                          int col0, int t) {
  hold(h, p, [&](int i) {
    if constexpr (sizeof(T) == 2) {
      return nerf_train::bits_of(g::Elem<bf16>::bias2(acc[i], acc[i + 1], bias, col0 + acc_col(t, i)));
    } else {
      return g::Elem<float>::bias(acc[i], acc[i + 1], bias, col0 + acc_col(t, i));
    }
  });
}

// dz_out's pairs of pass p, held
template <class T, int N, int kP, bool kMask>
__device__ __forceinline__ void hold_dz(Held<T, N, kP>& h, int p, const float (&acc)[N / 2],
                                        const uint32_t (&w)[bit_words(N)]) {
  hold(h, p, [&](int i) {
    const float v0 = !kMask || bit(w, i) ? acc[i] : 0.f;
    const float v1 = !kMask || bit(w, i + 1) ? acc[i + 1] : 0.f;
    if constexpr (sizeof(T) == 2) {
      return nerf_train::bits_of(__floats2bfloat162_rn(v0, v1));
    } else {
      return make_float2(v0, v1);
    }
  });
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
// stash, 16 bytes a thread: thread tid's chunks are tid, tid + 256, ... of
// the tile's row-major chunks, their (row, chunk) stepped on without a
// division by the runtime width in the loop
template <class T>
__device__ __forceinline__ void copy_out(const unsigned char* tile, T* dst, int width, int row0, int tid,
                                         const unsigned char* tile2 = nullptr, int split = 1 << 30) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = width / V;
  const int dr = kConsumers / per_row, dc = kConsumers - dr * per_row;
  int r = tid / per_row, j = tid - r * per_row;
  while (r < kRows) {
    const int c = j * V;
    const unsigned char* src = c < split ? tile + swz<T>(r, c) : tile2 + swz<T>(r, c - split);
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + r) * width + c) = *reinterpret_cast<const uint4*>(src);
    r += dr;
    j += dc;
    if (j >= per_row) {
      j -= per_row;
      ++r;
    }
  }
}

// an f32 panel's columns [0, 16) to columns [col, col + 16) of rows [row0,
// row0 + 64) of a row-major (m_pad, ld) buffer, 16 bytes a thread
__device__ __forceinline__ void copy_strip(const unsigned char* panel, float* dst, int ld, int col, int row0,
                                           int tid) {
  const int r = tid >> 2, j = tid & 3;
  *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + r) * ld + col + 4 * j) =
      *reinterpret_cast<const uint4*>(panel + swz<float>(r, 4 * j));
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

// the activation tile's panels: every pass's columns, a width off the
// passes too
template <class T>
__host__ __device__ inline int act_panels(int feat, int np, int passes) {
  return panels<T>(feat > 2 * np * passes ? feat : 2 * np * passes);
}

// A kernel's shape: NP columns a warpgroup a pass; kP the passes its tile
// holds (1: one pass, its trunk read to 2 NP); kStream: f32 past the tile,
// every layer through device memory (any number of passes, nothing held).
// A kernel of one pass reads its trunk to 2 NP, one of several (or a
// streaming one) to F.
template <int kP, bool kStream>
__host__ __device__ constexpr bool multi() {
  return kP > 1 || kStream;
}

template <class T, int NP, int kP, bool kStream, bool kStash, class In>
__global__ void __launch_bounds__(kThreads, ctas<T, NP>())
    forward_kernel(In in, const __grid_constant__ g::Net net, const __grid_constant__ g::Stash<T> st, uint32_t* bits,
                   int m, const __grid_constant__ Plan plan) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, plan.stages);
  const g::Dims& d = net.d;
  constexpr int N9 = NP / 2;  // fc_9's columns a warpgroup a pass
  constexpr bool kShared = kP > 1 && !kStream;
  // the passes: one, known here, where the pass width holds one (choose);
  // the trunk inputs' K
  const int F = d.feat, n = multi<kP, kStream>() ? plan.passes : 1;
  const int K = multi<kP, kStream>() ? F : 2 * NP;
  const int pe_np = panels<T>(d.pe_dim), de_np = panels<T>(d.de_dim);
  unsigned char* act = sm.data;
  // pe (and with kShared, from fc_8 on, de): after the activation tile, where there is one
  unsigned char* enc = act + (kStream ? 0 : act_panels<T>(F, NP, n) * kPanel);
  unsigned char* enc_de = kShared ? enc : enc + pe_np * kPanel;
  Ring ring = {sm.full, sm.empty, enc + (kShared ? (pe_np > de_np ? pe_np : de_np) : pe_np + de_np) * kPanel,
               plan.stage_bytes, plan.stages, 0};
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) produce(plan, ring);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(consumer_regs<T, NP>()));
  const int tid = threadIdx.x;
  const int t = tid & 127;
  const int row0 = blockIdx.x * kRows;
  // the warpgroup's first column of pass p of an F-wide layer, of fc_9
  auto col = [&](int p) { return (2 * p + wg) * NP; };
  auto col9 = [&](int p) { return (2 * p + wg) * N9; };
  auto bits_for = [&](int slot, int p) { return kStash ? bits_at<NP>(bits, plan.words, slot, p) : nullptr; };
  // streaming: activation a in device memory, as a layer's input and as
  // its output (the sink after the ring)
  float2* trash = reinterpret_cast<float2*>(ring.stage + plan.stages * plan.stage_bytes) + tid;
  auto rows_of = [&](int a) { return reinterpret_cast<const float*>(st.act[a]); };
  auto out_of = [&](int a) {
    const int w = d.act_width(a);
    return RowOut{reinterpret_cast<float*>(st.act[a]) + static_cast<size_t>(row0) * w, w, w, trash};
  };

  auto encode_de = [&] {
    encode<T>([&](int i, int c) { return in.dir(i, c); }, row0, m, d.dir_levels, d.include_input, d.de_dim, de_np,
              enc_de, tid);
  };
  encode<T>([&](int i, int c) { return in.pos(i, c); }, row0, m, d.pos_levels, d.include_input, d.pe_dim, pe_np, enc,
            tid);
  if constexpr (!kShared) encode_de();
  publish();
  if constexpr (kStash) {
    copy_out<T>(enc, st.act[g::A_PE], d.pe_pad, row0, tid);
    if constexpr (!kShared) copy_out<T>(enc_de, st.act[g::A_DE], d.de_pad, row0, tid);
  }

  const uint32_t act_a = smem_u32(act), enc_a = smem_u32(enc), de_a = smem_u32(enc_de);
  float unused[1];

  // relu layers fc_in .. fc_7: fc_in reads pe, fc_5 [h4, pe], the others h
  for (int l = 0; l < 8; ++l) {
    const int pe5 = l == 5 ? d.pe_dim : 0;
    float acc[NP / 2];
    if constexpr (kStream) {
      const ASrc src = l == 0 ? a_of(enc_a, d.pe_dim) : a_rows(rows_of(g::A_H0 + l - 1), F, row0, K, enc_a, pe5);
      const RowOut out = out_of(g::A_H0 + l);
      for (int p = 0; p < n; ++p) {
        product<T, NP, 0, true>(ring, src, wg * NP, acc, unused);
        relu_out<T, NP, kStash>(acc, net.b[l], col(p), out, bits_for(l, p), t);
      }
      consumers_sync();
    } else {
      const ASrc src = l == 0 ? a_of(enc_a, d.pe_dim) : a_of(act_a, K, enc_a, pe5);
      Held<T, NP, kP> held;
      for (int p = 0; p < n; ++p) {
        product<T, NP>(ring, src, wg * NP, acc, unused);
        if constexpr (kP > 1) {
          if (p < n - 1) hold_relu<T, NP, kP, kStash>(held, p, acc, net.b[l], col(p), bits_for(l, p), t);
        }
      }
      consumers_sync();
      if constexpr (kP > 1) unhold(held, n, act, t, col);
      relu_out<T, NP, kStash>(acc, net.b[l], col(n - 1), TileOut{act}, bits_for(l, n - 1), t);
      publish();
      if constexpr (kStash) copy_out<T>(act, st.act[g::A_H0 + l], F, row0, tid);
    }
  }

  // fc_5 was pe's last reader: de takes its tile (fc_8's barriers publish
  // it before fc_9 reads it)
  if constexpr (kShared) encode_de();

  // fc_8: the features (no relu); sigma from the n8 group on each pass's
  // rows [2 NP, 2 NP + 8), the same in every pass, written by the upper
  // warpgroup from the last
  {
    float acc[NP / 2], acc8[4];
    auto features = [&](int p, const auto& out) {
#pragma unroll
      for (int i = 0; i < NP / 2; i += 2) {
        const int c = col(p) + acc_col(t, i);
        const float2 y = g::Elem<T>::bias(acc[i], acc[i + 1], net.b[g::L_8], c);
        out.template put<T>(acc_row(t, i), c, y.x, y.y);
      }
    };
    if constexpr (kStream) {
      const ASrc src = a_rows(rows_of(g::A_H0 + 7), F, row0, K);
      const RowOut out = out_of(g::A_FEAT);
      for (int p = 0; p < n; ++p) {
        product<T, NP, kSigmaRows, true>(ring, src, wg * NP, acc, acc8, 2 * NP);
        features(p, out);
      }
    } else {
      Held<T, NP, kP> held;
      const ASrc src = a_of(act_a, K);
      for (int p = 0; p < n; ++p) {
        product<T, NP, kSigmaRows>(ring, src, wg * NP, acc, acc8, 2 * NP);
        if constexpr (kP > 1) {
          if (p < n - 1) hold_bias<T, NP, kP>(held, p, acc, net.b[g::L_8], col(p), t);
        }
      }
      consumers_sync();
      if constexpr (kP > 1) unhold(held, n, act, t, col);
      features(n - 1, TileOut{act});
    }
    if (wg == 1 && (t & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int gr = row0 + acc_row(t, i);
        const float2 y = g::Elem<T>::bias(acc8[i], acc8[i + 1], net.b[g::L_8], F);
        if (gr < m) st.sigma[gr] = relu_nan(y.x);
      }
    }
    if constexpr (kStream) {
      consumers_sync();
    } else {
      publish();
      if constexpr (kStash) {
        copy_out<T>(act, st.act[g::A_FEAT], F, row0, tid);
        if constexpr (kShared) copy_out<T>(enc_de, st.act[g::A_DE], d.de_pad, row0, tid);
      }
    }
  }

  // fc_9 reads [features, de] -> h9 (F/2), NP / 2 columns a warpgroup a pass
  {
    float acc9[N9 / 2];
    if constexpr (kStream) {
      const ASrc src = a_rows(rows_of(g::A_FEAT), F, row0, K, de_a, d.de_dim);
      const RowOut out = out_of(g::A_H9);
      for (int p = 0; p < n; ++p) {
        product<T, N9, 0, true>(ring, src, wg * N9, acc9, unused);
        relu_out<T, N9, kStash>(acc9, net.b[g::L_9], col9(p), out, bits_for(8, p), t);
      }
      consumers_sync();
    } else {
      Held<T, N9, kP> held;
      const ASrc src = a_of(act_a, K, de_a, d.de_dim);
      for (int p = 0; p < n; ++p) {
        product<T, N9>(ring, src, wg * N9, acc9, unused);
        if constexpr (kP > 1) {
          if (p < n - 1) hold_relu<T, N9, kP, kStash>(held, p, acc9, net.b[g::L_9], col9(p), bits_for(8, p), t);
        }
      }
      consumers_sync();
      if constexpr (kP > 1) unhold(held, n, act, t, col9);
      relu_out<T, N9, kStash>(acc9, net.b[g::L_9], col9(n - 1), TileOut{act}, bits_for(8, n - 1), t);
      publish();
      if constexpr (kStash) copy_out<T>(act, st.act[g::A_H9], F / 2, row0, tid);
    }
  }

  // fc_out -> sigmoid, written by the lower warpgroup
  {
    float acco[4];
    const ASrc src = kStream ? a_rows(rows_of(g::A_H9), F / 2, row0, K / 2) : a_of(act_a, K / 2);
    product<T, 8, 0, kStream>(ring, src, 0, acco, unused);
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
// and dde (m_pad, de_pad). A pass's mask words are read before its product.
// A streaming kernel reads each dz back from the stash as the next step's A.

template <class T, int NP, int kP, bool kStream, bool kInputGrads>
__global__ void __launch_bounds__(kThreads, ctas<T, NP, kInputGrads>())
    chain_kernel(const __grid_constant__ g::Net net, const __grid_constant__ g::Stash<T> st,
                 const uint32_t* __restrict__ bits, const float* __restrict__ g_sigma,
                 const float* __restrict__ g_rgb, float* __restrict__ dpe, float* __restrict__ dde, int m,
                 const __grid_constant__ Plan plan) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, plan.stages);
  const g::Dims& d = net.d;
  constexpr int N9 = NP / 2;
  const int F = d.feat, n = multi<kP, kStream>() ? plan.passes : 1;
  const int K = multi<kP, kStream>() ? F : 2 * NP;  // the dz inputs' K, as the forward's
  unsigned char* act = sm.data;
  unsigned char* x = act + (kStream ? 0 : act_panels<T>(F, NP, n) * kPanel);
  Ring ring = {sm.full, sm.empty, x + kPanel, plan.stage_bytes, plan.stages, 0};
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) produce(plan, ring);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(consumer_regs<T, NP, kInputGrads>()));
  const int tid = threadIdx.x;
  const int t = tid & 127;
  const int row0 = blockIdx.x * kRows;
  auto col = [&](int p) { return (2 * p + wg) * NP; };
  auto col9 = [&](int p) { return (2 * p + wg) * N9; };
  auto bits_for = [&](int slot, int p) { return bits_at<NP>(bits, plan.words, slot, p); };
  const uint32_t act_a = smem_u32(act), x_a = smem_u32(x);
  float unused[1];
  // streaming: layer l's dz in the stash, as the next step's input and as
  // a step's output (its columns past `width` to the sink after the ring)
  float2* trash = reinterpret_cast<float2*>(ring.stage + plan.stages * plan.stage_bytes) + tid;
  auto dz_rows = [&](int l) { return reinterpret_cast<const float*>(st.dz[l]); };
  auto dz_of = [&](int l, int width) {
    const int w = d.dz_width(l);
    return RowOut{reinterpret_cast<float*>(st.dz[l]) + static_cast<size_t>(row0) * w, w, width, trash};
  };

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

  // fc_out^T: dz9 = mask(h9, dz_out W_out^T), NP / 2 columns a warpgroup a
  // pass; this product does not read the tile, so each pass goes straight
  // to it
  {
    float acc9[N9 / 2];
    for (int p = 0; p < n; ++p) {
      uint32_t w[bit_words(N9)];
      load_bits(bits_for(8, p), w);
      product<T, N9, 0, kStream>(ring, a_of(x_a, 16), wg * N9, acc9, unused);
      if constexpr (kStream) {
        dz_out<T, N9, true>(acc9, w, col9(p), dz_of(g::L_9, F / 2), t);
      } else {
        dz_out<T, N9, true>(acc9, w, col9(p), TileOut{act}, t);
      }
    }
    if constexpr (kStream) {
      consumers_sync();
    } else {
      publish();
      copy_out<T>(act, st.dz[g::L_9], F / 2, row0, tid);
    }
  }

  // fc_9^T: dz9 W_9^T -> the features' dh (dz8's feature columns, no
  // relu); with input grads dde from the de rows
  {
    const ASrc src = kStream ? a_rows(dz_rows(g::L_9), F / 2, row0, K / 2) : a_of(act_a, K / 2);
    // the input-grad product first: its sums leave before acc's arrive
    if constexpr (kInputGrads) {
      float acce[kExtra / 2];
      product<T, kExtra, 0, kStream>(ring, src, wg * kExtra, acce, unused);
      grad_out<T, false>(acce, wg * kExtra, dde, d.de_pad, row0, t);
    }
    const uint32_t none[bit_words(NP)] = {};
    float acc[NP / 2];
    if constexpr (kStream) {
      const RowOut out = dz_of(g::L_8, F);
      for (int p = 0; p < n; ++p) {
        product<T, NP, 0, true>(ring, src, wg * NP, acc, unused);
        dz_out<T, NP, false>(acc, none, col(p), out, t);
      }
    } else {
      Held<T, NP, kP> held;
      for (int p = 0; p < n; ++p) {
        product<T, NP>(ring, src, wg * NP, acc, unused);
        if constexpr (kP > 1) {
          if (p < n - 1) hold_dz<T, NP, kP, false>(held, p, acc, none);
        }
      }
      consumers_sync();
      if constexpr (kP > 1) unhold(held, n, act, t, col);
      dz_out<T, NP, false>(acc, none, col(n - 1), TileOut{act}, t);
    }
    // dz8's sigma column: g_sigma where sigma > 0, in x's column 0
    small_panel<T>(x, tid, [&](int r, float (&v)[3]) {
      const int gr = row0 + r;
      v[0] = gr < m && st.sigma[gr] > 0.f ? g_sigma[gr] : 0.f;
      v[1] = v[2] = 0.f;
    });
    publish();
    if constexpr (kStream) {
      copy_strip(x, reinterpret_cast<float*>(st.dz[g::L_8]), F + 16, F, row0, tid);
    } else {
      copy_out<T>(act, st.dz[g::L_8], F + 16, row0, tid, x, F);
    }
  }

  // fc_8^T .. fc_1^T: dh = dz W^T masked by the relu of its input; fc_8^T
  // reads [dz8's features, x's sigma column], fc_5^T's pe rows give dpe
  for (int l = 8; l >= 1; --l) {
    const int xs = l == 8 ? 16 : 0;
    const ASrc src = kStream ? a_rows(dz_rows(l), d.dz_width(l), row0, K, x_a, xs) : a_of(act_a, K, x_a, xs);
    if constexpr (kInputGrads) {
      if (l == 5) {
        float acce[kExtra / 2];
        product<T, kExtra, 0, kStream>(ring, src, wg * kExtra, acce, unused);
        grad_out<T, false>(acce, wg * kExtra, dpe, d.pe_pad, row0, t);
      }
    }
    float acc[NP / 2];
    uint32_t w[bit_words(NP)];
    if constexpr (kStream) {
      const RowOut out = dz_of(l - 1, F);
      for (int p = 0; p < n; ++p) {
        load_bits(bits_for(l - 1, p), w);
        product<T, NP, 0, true>(ring, src, wg * NP, acc, unused);
        dz_out<T, NP, true>(acc, w, col(p), out, t);
      }
      consumers_sync();
    } else {
      Held<T, NP, kP> held;
      for (int p = 0; p < n; ++p) {
        load_bits(bits_for(l - 1, p), w);
        product<T, NP>(ring, src, wg * NP, acc, unused);
        if constexpr (kP > 1) {
          if (p < n - 1) hold_dz<T, NP, kP, true>(held, p, acc, w);
        }
      }
      consumers_sync();
      if constexpr (kP > 1) unhold(held, n, act, t, col);
      dz_out<T, NP, true>(acc, w, col(n - 1), TileOut{act}, t);
      publish();
      copy_out<T>(act, st.dz[l - 1], F, row0, tid);
    }
  }

  if constexpr (kInputGrads) {
    // fc_in^T: dpe += round(dz0 W_in^T)
    float acce[kExtra / 2];
    const ASrc src = kStream ? a_rows(dz_rows(g::L_IN), F, row0, K) : a_of(act_a, K);
    product<T, kExtra, 0, kStream>(ring, src, wg * kExtra, acce, unused);
    grad_out<T, true>(acce, wg * kExtra, dpe, d.pe_pad, row0, t);
  }
}

// ---------------------------------------------------------------------------
// host side

// a layer's column passes: NP columns a warpgroup a pass (the kernels' pass
// width), n passes; stream: f32 past kF32TileMax, every layer through
// device memory; multi: a tile kernel of several passes (its trunk read to
// F, its earlier passes' outputs held), at n = 1 too
struct Passes {
  int np;
  int n;
  bool stream;
  bool multi;
};

// bytes of a stage: one weight image's K-slice of a pass's rows (the f32
// route's three piece images are three stages), 128 bytes a row
inline uint32_t stage_of(int rows) { return static_cast<uint32_t>(rows) * 128; }

// a layer's `passes` x `slices` K-slices of `rows` image rows a pass
template <class T>
inline void add(Plan& plan, const void* image, int passes, int slices, int rows) {
  plan.seg[plan.n].src = static_cast<const unsigned char*>(image);
  plan.seg[plan.n].slices = passes * slices * Tc<T>::kImages;
  plan.seg[plan.n].bytes = stage_of(rows);
  ++plan.n;
  plan.stage_bytes = std::max(plan.stage_bytes, stage_of(rows));
}

// the ring's depth: as many stages as fit beside the tiles in a block's
// shared memory at `ctas` CTAs an SM, at most kMaxStages; fewer than 2 and
// the route does not take the config
inline int ring_stages(int tiles, uint32_t stage_bytes, int ctas) {
  return std::min(kMaxStages, static_cast<int>((block_smem(ctas) - kSlack - tiles) / static_cast<int>(stage_bytes)));
}

// CTAs an SM of a pass width (ctas<T, NP, kInputGrads> at run time)
template <class T>
inline int ctas_of(int np, bool input_grads = false) {
  return sizeof(T) == 2 && np <= kPairMax && !input_grads ? 2 : 1;
}

inline size_t smem_bytes(int tiles, const Plan& plan) {
  return static_cast<size_t>(kSlack) + tiles + static_cast<size_t>(plan.stages) * plan.stage_bytes;
}

// a kernel of several passes (multi<kP, kStream> at run time): its trunk
// read to F
template <class T>
inline bool multi_of(Passes ps) {
  return ps.stream || ps.multi;
}

// the forward's tiles: the activations (every pass's columns) and the
// encodings (one tile for both in a tile kernel of several passes); the
// chain's: the dz tile and one panel. A streaming kernel's: no
// activations, its sink after the ring.
template <class T>
inline int tile_bytes(const g::Dims& d, Passes ps, bool forward) {
  const int p = ps.stream ? 0 : act_panels<T>(d.feat, ps.np, ps.n);
  const int pe = panels<T>(d.pe_dim), de = panels<T>(d.de_dim);
  const bool shared = multi_of<T>(ps) && !ps.stream;
  return (forward ? p + (shared ? std::max(pe, de) : pe + de) : p + 1) * kPanel + (ps.stream ? kTrash : 0);
}

// the K of a trunk input (a kernel of several passes: F, else the pass's
// width)
template <class T>
inline int trunk_k(const g::Dims& d, Passes ps) {
  return multi_of<T>(ps) ? d.feat : 2 * ps.np;
}

template <class T>
inline void set_passes(Plan& plan, Passes ps) {
  plan.np = ps.np;
  plan.passes = ps.n;
  plan.words = ps.n * bit_words(ps.np);
}

template <class T>
inline Plan forward_plan(const void* const* fwd, const g::Dims& d, Passes ps) {
  const int f = trunk_k<T>(d, ps), k = slices(f), pe = slices(d.pe_dim), de = slices(d.de_dim);
  Plan plan = {};
  for (int l = 0; l < 8; ++l) add<T>(plan, fwd[l], ps.n, l == 0 ? pe : (l == 5 ? k + pe : k), 2 * ps.np);
  add<T>(plan, fwd[g::L_8], ps.n, k, 2 * ps.np + kSigmaRows);
  add<T>(plan, fwd[g::L_9], ps.n, k + de, ps.np);
  add<T>(plan, fwd[g::L_OUT], 1, slices(f / 2), 8);
  set_passes<T>(plan, ps);
  plan.stages = ring_stages(tile_bytes<T>(d, ps, true), plan.stage_bytes, ctas_of<T>(ps.np));
  return plan;
}

template <class T>
inline Plan chain_plan(const void* const* chain, const g::Dims& d, bool input_grads, Passes ps) {
  const int f = trunk_k<T>(d, ps), k = slices(f), h = slices(f / 2);
  Plan plan = {};
  add<T>(plan, chain[g::L_OUT], ps.n, 1, ps.np);
  if (input_grads) add<T>(plan, chain[kChainDe], 1, h, 2 * kExtra);
  add<T>(plan, chain[g::L_9], ps.n, h, 2 * ps.np);
  add<T>(plan, chain[g::L_8], ps.n, k + 1, 2 * ps.np);
  for (int l = 7; l >= 1; --l) {
    if (input_grads && l == 5) add<T>(plan, chain[kChainPe], 1, k, 2 * kExtra);
    add<T>(plan, chain[l], ps.n, k, 2 * ps.np);
  }
  if (input_grads) add<T>(plan, chain[g::L_IN], 1, k, 2 * kExtra);
  set_passes<T>(plan, ps);
  plan.stages = ring_stages(tile_bytes<T>(d, ps, false), plan.stage_bytes, ctas_of<T>(ps.np, input_grads));
  return plan;
}

// every kernel's ring at least two stages deep beside its tiles
template <class T>
inline bool fits(const g::Dims& d, Passes ps) {
  const void* none[kChainImages] = {};
  return forward_plan<T>(none, d, ps).stages >= 2 && chain_plan<T>(none, d, true, ps).stages >= 2 &&
         chain_plan<T>(none, d, false, ps).stages >= 2;
}

// f32's column passes, F = 2 C: at F % 64 == 0 up to 256 one pass of C
// (paths A's engine as it was); else up to kF32TileMax the kernel of
// several passes (NP 64, 80 or 96, at most f32_pass_cap(NP) of them) that
// covers C in the fewest columns, on a tie the fewest passes; past it, or
// where no tile plan fits, streaming at NP 96 or 64, whichever covers C in
// fewer columns (96 on a tie)
inline Passes choose_f32(const g::Dims& d) {
  const int c = d.feat / 2;
  if (d.feat % 64 == 0 && c <= kPassCap && fits<float>(d, {c, 1, false, false})) return {c, 1, false, false};
  if (d.feat <= kF32TileMax) {
    Passes best = {0, 0, false, true};
    for (int np : {64, 80, 96}) {
      const int n = cdiv(c, np);
      if (n > f32_pass_cap(np)) continue;
      if (best.n == 0 || np * n < best.np * best.n || (np * n == best.np * best.n && n < best.n)) {
        best = {np, n, false, true};
      }
    }
    if (best.n > 0 && fits<float>(d, best)) return best;
  }
  const Passes s = cdiv(c, 96) * 96 <= cdiv(c, 64) * 64 ? Passes{96, cdiv(c, 96), true, false}
                                                        : Passes{64, cdiv(c, 64), true, false};
  return fits<float>(d, s) ? s : Passes{0, 0, false, false};
}

// the column passes of a config, {0, 0} where this engine does not take
// it. bf16, any padded width F % 32 == 0 up to 1024, C = F / 2 columns a
// warpgroup: up to 128 one pass of C rounded up to 16 (two CTAs an SM up
// to 80); else ceil(C / 128) passes of C / passes rounded up to 16, at
// least kPassMin, the widths of two passes of 128 (480, 512) in one pass
// of 256 for the forward with its stash and the chain where its ring keeps
// two stages (path B's engine as it was; kernel 1, the forward alone,
// reads faster in the two passes and kernels 2-3 slower: PERF.md, section
// 6). f32: choose_f32, every padded width up to 1024.
template <class T>
inline Passes choose(const g::Dims& d, bool stash = true) {
  const Passes none = {0, 0, false, false};
  if (!g::dims_ok(d)) return none;
  if constexpr (sizeof(T) == 4) {
    return choose_f32(d);
  } else {
    const int c = d.feat / 2;
    Passes ps;
    if (c <= kPassCap) {
      ps = {cdiv(c, 16) * 16, 1, false, false};
    } else {
      const int n = cdiv(c, kPassCap);
      ps = {std::max(kPassMin, cdiv(cdiv(c, n), 16) * 16), n, false, false};
      const Passes merged = {2 * kPassCap, 1, false, false};
      if (stash && n == 2 && ps.np == kPassCap && fits<T>(d, merged)) return merged;
    }
    ps.multi = bf16_pass_cap(ps.np) > 1;
    return fits<T>(d, ps) ? ps : none;
  }
}

template <class T>
inline bool takes(const g::Dims& d) {
  return choose<T>(d).n > 0;
}

// the relu bits of m points: 9 slots of every tile's threads' words. The
// workspace is sized from the padded encodings (the entries' workspace
// queries know only those): they take the tile panels, and so the passes,
// of the encodings themselves.
template <class T>
inline size_t bits_bytes(int m, const g::Dims& d) {
  g::Dims padded = d;
  padded.pe_dim = d.pe_pad;
  padded.de_dim = d.de_pad;
  const Passes ps = choose<T>(padded);
  return g::align256(static_cast<size_t>(kBitSlots) * ps.n * bit_words(ps.np) * (g::padded_points(m) / kRows) *
                     kConsumers * sizeof(uint32_t));
}

// kernel 1's scratch where it streams: two row-major (m_pad, F) f32
// buffers the layers write in turn (h0, h2, .., h6 and the features to the
// first, h1, .., h7 to the second), and h9's (m_pad, F / 2) of its own (at
// its own row pitch in either buffer, a tile's h9 rows would overwrite
// another tile's rows that its layers have still to read)
template <class T>
inline size_t scratch_bytes(int m, const g::Dims& d) {
  g::Dims padded = d;
  padded.pe_dim = d.pe_pad;
  padded.de_dim = d.de_pad;
  if (!choose<T>(padded, false).stream) return 0;
  const size_t mp = g::padded_points(m);
  return 2 * g::align256(mp * d.feat * sizeof(float)) + g::align256(mp * d.half() * sizeof(float));
}

using nerf_train::set_smem;

template <class T, int NP, int kP, bool kStream, bool kStash, class In>
inline cudaError_t forward_shape(const In& in, const g::Net& net, const g::Stash<T>& st, uint32_t* bits, int m,
                                 const Plan& plan, Passes ps, cudaStream_t stream) {
  const size_t smem = smem_bytes(tile_bytes<T>(net.d, ps, true), plan);
  cudaError_t err = set_smem(forward_kernel<T, NP, kP, kStream, kStash, In>, smem);
  if (err != cudaSuccess) return err;
  forward_kernel<T, NP, kP, kStream, kStash, In>
      <<<g::padded_points(m) / kRows, kThreads, smem, stream>>>(in, net, st, bits, m, plan);
  return cudaGetLastError();
}

template <class T, int NP, int kP, bool kStream, bool kInputGrads>
inline cudaError_t chain_shape(const g::Net& net, const g::Stash<T>& st, const uint32_t* bits, const float* g_sigma,
                               const float* g_rgb, float* dpe, float* dde, int m, const Plan& plan, Passes ps,
                               cudaStream_t stream) {
  const size_t smem = smem_bytes(tile_bytes<T>(net.d, ps, false), plan);
  cudaError_t err = set_smem(chain_kernel<T, NP, kP, kStream, kInputGrads>, smem);
  if (err != cudaSuccess) return err;
  chain_kernel<T, NP, kP, kStream, kInputGrads>
      <<<g::padded_points(m) / kRows, kThreads, smem, stream>>>(net, st, bits, g_sigma, g_rgb, dpe, dde, m, plan);
  return cudaGetLastError();
}

// the kernel shapes built: fn(NP, kP, kStream) as integral constants.
// bf16: NP 16..128 by 16 and 256, kP bf16_pass_cap(NP); f32: one pass at
// NP 32..128 by 32, several at NP 64, 80, 96 (kP f32_pass_cap), streaming
// at NP 64 and 96
template <int NP, int kP, bool kStream, class Fn>
inline cudaError_t shape(Fn& fn) {
  return fn(std::integral_constant<int, NP>(), std::integral_constant<int, kP>(),
            std::integral_constant<bool, kStream>());
}

template <class T, class Fn>
inline cudaError_t by_shape(Passes ps, Fn fn) {
  if constexpr (sizeof(T) == 2) {
    switch (ps.np) {
      case 16: return shape<16, 1, false>(fn);
      case 32: return shape<32, 1, false>(fn);
      case 48: return shape<48, 1, false>(fn);
      case 64: return shape<64, 1, false>(fn);
      case 80: return shape<80, 1, false>(fn);
      case 96: return shape<96, bf16_pass_cap(96), false>(fn);
      case 112: return shape<112, bf16_pass_cap(112), false>(fn);
      case 128: return shape<128, bf16_pass_cap(128), false>(fn);
      case 256: return shape<256, 1, false>(fn);
      default: return cudaErrorInvalidValue;
    }
  } else if (ps.stream) {
    switch (ps.np) {
      case 64: return shape<64, 1, true>(fn);
      case 96: return shape<96, 1, true>(fn);
      default: return cudaErrorInvalidValue;
    }
  } else if (ps.multi) {
    switch (ps.np) {
      case 64: return shape<64, f32_pass_cap(64), false>(fn);
      case 80: return shape<80, f32_pass_cap(80), false>(fn);
      case 96: return shape<96, f32_pass_cap(96), false>(fn);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (ps.np) {
      case 32: return shape<32, 1, false>(fn);
      case 64: return shape<64, 1, false>(fn);
      case 96: return shape<96, 1, false>(fn);
      case 128: return shape<128, 1, false>(fn);
      default: return cudaErrorInvalidValue;
    }
  }
}

// the forward of m points: sigma, rgb to st.sigma, st.rgb; with kStash every
// activation to the stash and the relu bits to bits (bits_bytes). fwd: the
// forward images; scratch: kernel 1's scratch_bytes where it streams. A
// config the engine does not take is refused. (run_forward and run_chain
// are not inline: an entry source declares its f32 instances extern and a
// part of its own instantiates them, so that nvcc compiles the f32
// kernels beside the bf16 ones; ops/build.py links both.)
template <class T, bool kStash, class In>
cudaError_t run_forward(const In& in, const g::Net& net, const void* const* fwd, g::Stash<T> st,
                               uint32_t* bits, int m, cudaStream_t stream, void* scratch = nullptr) {
  const Passes ps = choose<T>(net.d, kStash);
  if (ps.n == 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  if (!kStash && ps.stream) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    const size_t buffer = g::align256(static_cast<size_t>(g::padded_points(m)) * net.d.feat * sizeof(float));
    unsigned char* base = static_cast<unsigned char*>(scratch);
    for (int a = g::A_H0; a < g::kActs; ++a)
      st.act[a] = reinterpret_cast<T*>(base + (a == g::A_H9 ? 2 : (a - g::A_H0) % 2) * buffer);
  }
  const Plan plan = forward_plan<T>(fwd, net.d, ps);
  return by_shape<T>(ps, [&](auto np, auto kp, auto stream_) {
    return forward_shape<T, decltype(np)::value, decltype(kp)::value, decltype(stream_)::value, kStash>(
        in, net, st, bits, m, plan, ps, stream);
  });
}

template <class T, bool kInputGrads>
cudaError_t run_chain(const g::Net& net, const void* const* chain, const g::Stash<T>& st, const uint32_t* bits,
                             const float* g_sigma, const float* g_rgb, float* dpe, float* dde, int m,
                             cudaStream_t stream) {
  const Passes ps = choose<T>(net.d);
  if (ps.n == 0) return cudaErrorInvalidValue;
  const Plan plan = chain_plan<T>(chain, net.d, kInputGrads, ps);
  return by_shape<T>(ps, [&](auto np, auto kp, auto stream_) {
    return chain_shape<T, decltype(np)::value, decltype(kp)::value, decltype(stream_)::value, kInputGrads>(
        net, st, bits, g_sigma, g_rgb, dpe, dde, m, plan, ps, stream);
  });
}

// the plan of a config for its Python twin (fused_nerf.tc_plan): out[0..9]
// = NP, passes, the forward's, the chain's and the chain with input
// grads' stages, their shared-memory bytes, sign-bit words a slot, CTAs an
// SM; out[10..11] kernel 1's NP and passes; out[12] 1 where the kernels
// stream; zeros where the engine does not take the config
template <class T>
inline void plan_of(const g::Dims& d, long long* out) {
  for (int i = 0; i < 13; ++i) out[i] = 0;
  const Passes ps = choose<T>(d);
  if (ps.n == 0) return;
  const void* none[kChainImages] = {};
  const Plan f = forward_plan<T>(none, d, ps), c = chain_plan<T>(none, d, false, ps),
             ci = chain_plan<T>(none, d, true, ps);
  out[0] = ps.np;
  out[1] = ps.n;
  out[2] = f.stages;
  out[3] = c.stages;
  out[4] = ci.stages;
  out[5] = static_cast<long long>(smem_bytes(tile_bytes<T>(d, ps, true), f));
  out[6] = static_cast<long long>(smem_bytes(tile_bytes<T>(d, ps, false), c));
  out[7] = static_cast<long long>(smem_bytes(tile_bytes<T>(d, ps, false), ci));
  out[8] = f.words;
  out[9] = ctas_of<T>(ps.np);
  const Passes alone = choose<T>(d, false);
  out[10] = alone.np;
  out[11] = alone.n;
  out[12] = ps.stream;
}

}  // namespace nerf_tc
