// The NeRF MLP's training kernels on Hopper, shared by fused_nerf_bwd.cu (the
// backward of the fused field) and fused_train.cu (the fused train pass);
// fused_nerf_fwd.cu (kernel 1, the field's forward) runs the forward below
// without its stash.
//
// The Pallas kernels they replace keep a whole tile's activations in VMEM
// between the forward and the backward and sum the parameter gradients over
// sequential grid steps. An SM has 227 KB, not ~100 MB, and blocks run in
// parallel, so the work is cut into three kernels here, each built on
// wgmma.mma_async (bf16 operands from shared memory, f32 accumulators):
//
//   1. mlp_forward_stash: PE + the 11-layer forward per 128-point tile. Two
//      consumer warpgroups own 64 rows each and hold a layer's 64 x F sums
//      in registers; a producer warpgroup streams every layer's weights
//      through a ring of shared-memory stages, one 64-wide K-slice a stage,
//      by bulk asynchronous copies that complete on mbarriers. A layer's
//      output overwrites its input tile in place once the warpgroup's
//      products are done, goes to the activation stash in device memory by
//      bulk copies, and a relu layer's sign bits go to a third stash, one
//      16-byte word a thread in the accumulator's own order.
//   2. mlp_backward_chain: the same tile, ring and product for dh = dz W^T
//      from dz_out down to fc_in, every dh rounded to bf16 and masked by the
//      thread's own sign bits; each dz to the dz stash by bulk copies;
//      optionally dpe and dde (kept in registers) and the encode VJP.
//   3. dw_gemm: dW = A^T dZ and db = sum dZ, a split-K GEMM over the points
//      on wgmma with both operands MN-major: a CTA owns a 128 x up-to-256
//      tile of dW and one slice of the points, and a producer streams
//      64-point stages of A and dZ from the stashes through a 4-deep ring;
//      dw_reduce sums the partials in a fixed order into the public layout.
//      No atomics: the sums are the same from launch to launch.
//
// Tiles in shared memory and in the stashes use wgmma's canonical 128-byte
// swizzle: a "panel" is 64 bf16 columns of every row, 128 bytes a row, and
// the 16-byte chunk j of row r sits at chunk j ^ (r % 8); panels start
// 1024-byte aligned. A stash holds each 64-column panel of an activation
// (or dz) as its own (m_pad, 64) block, 64-row tiles back to back, byte for
// byte the image of a warpgroup's rows of the shared-memory tile. Read back
// with points as the reduction axis, that image is the MN-major swizzled
// operand the dW GEMM needs, so the GEMM copies it as it is.
//
// Weight images (built by torch_nerf_tpu_torch/ops/fused_nerf.py::
// training_layout): each layer's matrix in K-major swizzled panels, one
// K-slice after another (slice s: every image row's columns [64s, 64s+64)):
//   fwd[l]    W^T (rows N: the layer's outputs; fc_8's sigma moved to row F),
//   chain[l]  W   (rows K: the layer's inputs, fc_5's and fc_9's skip
//             inputs last; columns fc_8's outputs with sigma at column F),
//   b[l]      bf16 bias in the forward image's row order.
//
// Bound on an H100 SXM: 3 x 1,186,816 FLOP per point (forward, dh chain,
// dW) at 989 TFLOP/s dense bf16, 2.83 ms for a fine pass of 786,432
// points. The stashes move about 5 KB per point each way and the GEMM reads
// A once and dZ once per 128-row tile of dW: ~20 KB a point, ~16 GB or
// ~4.8 ms at 3.35 TB/s for that pass, above the operations bound.
//
// Precision: bf16 operands, f32 accumulation. Forward roundings as
// nerf_apply(compute_dtype=bf16): bf16(bf16(acc) + b); in the backward every
// dh is rounded to bf16 before its relu mask and its next product, dW and db
// are summed in f32 (torch_nerf_tpu/ops/pallas/fused_nerf.py::_backward_tile).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerf_train {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kLayers = 11;
constexpr int kRows = 128;                 // points per CTA of the forward and the chain
constexpr int kThreads = 384;              // two consumer warpgroups + one producer
constexpr int kPanel = kRows * 128;        // a 64-column panel of the 128-row tile
constexpr int kBlock = 64 * 128;           // a warpgroup's 64 rows of it; a stash block
constexpr int kStages = 3;                 // weight ring depth
constexpr int kMaxSlices = 48;
constexpr int kConsumerWarps = 8;

// ---------------------------------------------------------------------------
// barriers, bulk copies, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// global -> shared, completing `bytes` on the barrier
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global in the thread's bulk group; the stash streams through L2,
// evict it first and keep the weights
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// the thread's copies have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// generic-proxy writes to shared memory made visible to wgmma and bulk copies
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of warpgroup `wg` (barrier 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators are written by the tensor cores until wg_wait: keep the
// compiler from moving their reads above it
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
// K-major: sbo = 1024 (8 rows of 128 bytes), lbo unused; MN-major: lbo =
// the stride between 64-element panels along M or N, sbo = 1024 (8 rows
// along K).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// byte offset of element (row, col) in a tile of 64-column panels,
// `panel` bytes apart, 128 bytes a row, 128-byte swizzle
__host__ __device__ __forceinline__ uint32_t swizzle128(int row, int col, int panel) {
  return (col >> 6) * panel + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, both operands from shared
// memory; TA / TB: 1 for an MN-major A / B. scale_d 0 starts the sums.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB)
      : "memory");
}


template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 256) wgmma_n256<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 128) wgmma_n128<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_n64<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_n32<TA, TB>(d, da, db, scale_d);
  else wgmma_n8<TA, TB>(d, da, db, scale_d);
}

// accumulator i of thread t (of its warpgroup) holds row acc_row, column
// acc_col of the warpgroup's 64 x N sums; i and i + 1 (i even) are
// neighbouring columns of one row
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int i) { return 8 * (i >> 2) + 2 * (t & 3) + (i & 1); }

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ uint32_t bits_of(bf162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// relu that keeps a NaN, as torch.relu and jnp.maximum do (fmaxf and
// __hmax2 return the other operand): a non-finite input, as NDC rays from
// an origin on the z = 0 plane give, stays non-finite in the outputs
__device__ __forceinline__ float relu_nan(float v) { return v != v ? v : fmaxf(v, 0.f); }

__device__ __forceinline__ bf162 bias_add(float v0, float v1, const bf16* __restrict__ bias, int n) {
  // bf16(bf16(acc) + b) for the column pair: a bf16x2 add rounds the exact
  // sum once, as rounding its f32 sum does
  const bf162 b2 = *reinterpret_cast<const bf162*>(bias + n);
  return __hadd2(__floats2bfloat162_rn(v0, v1), b2);
}

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
  __device__ float dir(int i, int c) const { return d[static_cast<size_t>(i / samples) * 3 + c]; }
};

// The network: weight images and biases as the header note gives them.
struct Net {
  const unsigned char* fwd[kLayers];
  const unsigned char* chain[kLayers];
  const bf16* b[kLayers];
  int pos_levels, dir_levels, include_input, pe_dim, de_dim;
};

// Stash panels (64 columns each) of a width-F network: the activations
// [pe, de, h0..h7, feat, h9] and the dz's [dz0..dz7, dz8 (features, then
// sigma's panel), dz9, dz_out].
struct Panels {
  int p, h;  // panels of a width-F and of the width-F/2 activation
  __host__ __device__ explicit Panels(int f) : p(f / 64), h(f >= 128 ? f / 128 : 1) {}
  __host__ __device__ int pe() const { return 0; }
  __host__ __device__ int de() const { return 1; }
  __host__ __device__ int act(int l) const { return 2 + p * l; }  // h_l, l = 0..7
  __host__ __device__ int feat() const { return 2 + 8 * p; }
  __host__ __device__ int h9() const { return 2 + 9 * p; }
  __host__ __device__ int acts() const { return 2 + 9 * p + h; }
  __host__ __device__ int dz(int l) const { return p * l; }  // fc_in .. fc_7
  __host__ __device__ int dz8() const { return 8 * p; }
  __host__ __device__ int dz9() const { return 9 * p + 1; }
  __host__ __device__ int dz_out() const { return 9 * p + 1 + h; }
  __host__ __device__ int dzs() const { return 9 * p + 2 + h; }
};

struct Stash {
  unsigned char* acts;  // (acts panels, m_pad, 64) bf16
  unsigned char* dz;    // (dzs panels, m_pad, 64) bf16
  uint4* bits;          // (9, m_pad / 64, 128): relu bits of h0..h7, h9 per thread
  float* sigma;         // (m,)
  float* rgb;           // (m, 3)
  int m_pad;            // m rounded up to the 128-point tile
  // the 64-row block of stash panel `panel` at row0
  __device__ unsigned char* block(unsigned char* base, int panel, int row0) const {
    return base + (static_cast<size_t>(panel) * m_pad + row0) * 128;
  }
  __device__ uint4* bits_word(int slot, int tile64, int t) const {
    return bits + (static_cast<size_t>(slot) * (m_pad / 64) + tile64) * 128 + t;
  }
};

// ---------------------------------------------------------------------------
// the weight ring

// the weight slices of a kernel, in the order its consumers take them
struct Plan {
  const unsigned char* src[kMaxSlices];
  uint32_t bytes[kMaxSlices];
  int n;
};

struct Ring {
  uint64_t* full;        // [kStages]: the stage's copy has landed
  uint64_t* empty;       // [kStages]: every consumer warp is done with it
  unsigned char* stage;  // kStages stages of stage_bytes
  int stage_bytes;
  int it;                // slices taken so far
};

__host__ __device__ inline int stage_bytes(int feat) { return (feat + 64) * 128; }

// one producer thread: every slice of the plan into the ring, in order
__device__ __forceinline__ void produce(const Plan& plan, const Ring& ring) {
  for (int i = 0; i < plan.n; ++i) {
    const int slot = i % kStages;
    if (i >= kStages) mbar_wait(&ring.empty[slot], (i / kStages - 1) & 1);
    mbar_expect_tx(&ring.full[slot], plan.bytes[i]);
    bulk_load(ring.stage + slot * ring.stage_bytes, plan.src[i], plan.bytes[i], &ring.full[slot]);
  }
}

__device__ __forceinline__ void release(const Ring& ring, int it) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.empty[it % kStages]);
}

// acc (64 x N) = sum over `slices` weight slices of A_s x B_s: A_s the
// warpgroup's 64 rows of the panel at shared address a[s] (K-major), B_s
// the stage's image rows [0, N) (K-major); `last_k` k16 steps of the last
// slice, 4 of the others. With `second`, acc2 (64 x N2) takes the stage's
// rows [b2_row, b2_row + N2) too. Each stage goes back to the producer once
// the products that read it are done.
template <int N, int N2>
__device__ __forceinline__ void product(Ring& ring, const uint32_t* a, int slices, int last_k,
                                        bool second, int b2_row, float (&acc)[N / 2],
                                        float (&acc2)[N2 > 0 ? N2 / 2 : 1]) {
  for (int s = 0; s < slices; ++s) {
    const int slot = ring.it % kStages;
    mbar_wait(&ring.full[slot], (ring.it / kStages) & 1);
    const uint32_t b = smem_u32(ring.stage + slot * ring.stage_bytes);
    const int ks = s == slices - 1 ? last_k : 4;
    wg_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < ks) {
        const int scale = (s | k) != 0;
        const uint64_t da = sw128_desc(a[s] + 32 * k, 16, 1024);
        wgmma<N>(acc, da, sw128_desc(b + 32 * k, 16, 1024), scale);
        if constexpr (N2 > 0) {
          if (second) wgmma<N2>(acc2, da, sw128_desc(b + b2_row * 128 + 32 * k, 16, 1024), scale);
        }
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

// [x, sin(2^0 x), cos(2^0 x), ...] of the warpgroup's 64 points (rows past
// m encode zeros) into its block of a panel, columns [dim, 64) zeroed
template <class Value>
__device__ void encode(Value value, int row0, int m, int levels, int include_input, int dim,
                       unsigned char* block, int t) {
  const int base = include_input ? 3 : 0;
  auto put = [&](int r, int col, float x) {
    *reinterpret_cast<bf16*>(block + swizzle128(r, col, 0)) = __float2bfloat16_rn(x);
  };
  for (int i = t; i < 64 * 3; i += 128) {
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
  const int extra = 64 - dim;
  for (int i = t; i < 64 * extra; i += 128) put(i / extra, dim + i % extra, 0.f);
}

// d/dx of the encoding of the warpgroup's points, from the f32 cotangent g
// of its 64 columns held as n64 accumulators: thread t has the rows
// acc_row(t, 0) and acc_row(t, 2); the four threads of a row sum their
// parts. out (m, 3).
template <class Value>
__device__ void encode_vjp(const float (&g)[32], Value value, int row0, int m, int levels,
                           int include_input, int dim, float* __restrict__ out, int t) {
  const int base = include_input ? 3 : 0;
  float x[2][3], sum[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + acc_row(t, 2 * h);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[h][c] = gr < m ? value(gr, c) : 0.f;
      sum[h][c] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    const int col = acc_col(t, i);
    if (col >= dim) continue;
    float d;
    int c;
    if (col < base) {
      c = col;
      d = g[i];
    } else {
      const int k = col - base;
      const int level = k / 6;
      const int j = k - 6 * level;
      c = j % 3;
      const float fr = static_cast<float>(1 << level);
      const float xc = c == 0 ? x[h][0] : (c == 1 ? x[h][1] : x[h][2]);
      float s, co;
      sincosf(xc * fr, &s, &co);
      // d/dx sin(2^l x) = 2^l cos(2^l x), d/dx cos(2^l x) = -2^l sin(2^l x)
      d = j < 3 ? fr * co * g[i] : -(fr * s) * g[i];
    }
#pragma unroll
    for (int cc = 0; cc < 3; ++cc)
      if (c == cc) sum[h][cc] += d;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sum[h][c] += __shfl_xor_sync(0xffffffffu, sum[h][c], 1);
      sum[h][c] += __shfl_xor_sync(0xffffffffu, sum[h][c], 2);
    }
  if ((t & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + acc_row(t, 2 * h);
      if (gr < m)
#pragma unroll
        for (int c = 0; c < 3; ++c) out[static_cast<size_t>(gr) * 3 + c] = sum[h][c];
    }
  }
}

// ---------------------------------------------------------------------------
// epilogues: a warpgroup's 64 x N sums into its block of the tile (panels
// kPanel apart); for N == 32 the panel's other 32 columns are zeroed

template <int N>
__device__ __forceinline__ void zero_upper_half(unsigned char* tile, int t) {
  if constexpr (N == 32) {
#pragma unroll
    for (int i = 0; i < 16; i += 2)
      *reinterpret_cast<uint32_t*>(tile + swizzle128(acc_row(t, i), acc_col(t, i) + 32, kPanel)) = 0u;
  }
}

// relu(bf16(bf16(acc) + b)), and with kBits its relu bits (bit i of the
// thread's words: accumulator i > 0)
template <int N, bool kBits>
__device__ __forceinline__ void relu_epilogue(const float (&acc)[N / 2], const bf16* __restrict__ bias,
                                              unsigned char* tile, uint4* bits, int t) {
  const bf162 zero2 = __float2bfloat162_rn(0.f);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int c = acc_col(t, i);
    const bf162 y = __hmax2_nan(bias_add(acc[i], acc[i + 1], bias, c), zero2);
    *reinterpret_cast<bf162*>(tile + swizzle128(acc_row(t, i), c, kPanel)) = y;
    if constexpr (kBits) {
      w[i >> 5] |= (__low2float(y) > 0.f ? 1u : 0u) << (i & 31);
      w[i >> 5] |= (__high2float(y) > 0.f ? 1u : 0u) << ((i + 1) & 31);
    }
  }
  if constexpr (kBits) *bits = make_uint4(w[0], w[1], w[2], w[3]);
  zero_upper_half<N>(tile, t);
}

// bf16(acc), kept where the relu bits are set (all of it without bits)
template <int N, bool kMask>
__device__ __forceinline__ void dz_epilogue(const float (&acc)[N / 2], uint4 bits, unsigned char* tile,
                                            int t) {
  const uint32_t w[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    uint32_t v = bits_of(__floats2bfloat162_rn(acc[i], acc[i + 1]));
    if (kMask) {
      const uint32_t lo = (w[i >> 5] >> (i & 31)) & 1u ? 0x0000ffffu : 0u;
      const uint32_t hi = (w[i >> 5] >> ((i + 1) & 31)) & 1u ? 0xffff0000u : 0u;
      v &= lo | hi;
    }
    *reinterpret_cast<uint32_t*>(tile + swizzle128(acc_row(t, i), acc_col(t, i), kPanel)) = v;
  }
  zero_upper_half<N>(tile, t);
}

// The per-warpgroup steps around a layer's epilogue. before_write: the
// warpgroup's products are done and its stash copies have read the tile.
// publish: the epilogue's writes are visible to wgmma and bulk copies.
// store: n panels of the warpgroup's block at src (kPanel apart) to stash
// panels panel0.. by one thread's bulk copies.
struct Warpgroup {
  int wg, t, tile64, row0;
  __device__ void before_write() const {
    if (t == 0) bulk_wait_read();
    wg_sync(wg);
  }
  __device__ void publish() const {
    fence_async_smem();
    wg_sync(wg);
  }
  __device__ void store(const Stash& st, unsigned char* base, int panel0, const unsigned char* src,
                        int n) const {
    if (t == 0) {
      for (int p = 0; p < n; ++p) bulk_store(st.block(base, panel0 + p, row0), src + p * kPanel, kBlock);
      bulk_commit();
    }
  }
};

// shared memory of a kernel: barriers first, then the tiles and the ring,
// 1024-byte aligned
struct Smem {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* data;
};

__device__ __forceinline__ Smem carve_smem(unsigned char* raw, int stages) {
  Smem s;
  s.full = reinterpret_cast<uint64_t*>(raw);
  s.empty = s.full + stages;
  s.data = align1024(raw + 2 * stages * sizeof(uint64_t));
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return s;
}

__host__ __device__ inline size_t smem_slack(int stages) { return 1024 + 2 * stages * sizeof(uint64_t); }

// ---------------------------------------------------------------------------
// 1. the forward, with a stash of every activation (kernels 2 and 3) or
//    without (kernel 1, fused_nerf_fwd.cu: sigma and rgb only)

__host__ __device__ inline size_t forward_smem_bytes(int feat) {
  return static_cast<size_t>(feat / 64 + 2) * kPanel + kStages * stage_bytes(feat) + smem_slack(kStages);
}

// With kStash every activation goes to st.acts and the relu bits to
// st.bits; without, only st.sigma and st.rgb are written (the other stash
// pointers are not read). The products and roundings are the same.
template <int F, bool kStash, class In>
__device__ __forceinline__ void forward_consumer(const In& in, const Net& net, const Stash& st, int m,
                                                 unsigned char* act, unsigned char* pe, unsigned char* de,
                                                 Ring& ring, const Warpgroup& g) {
  constexpr int P = F / 64;
  constexpr int H = F >= 128 ? F / 128 : 1;
  const Panels pn(F);
  const int t = g.t;
  act += g.wg * kBlock;
  pe += g.wg * kBlock;
  de += g.wg * kBlock;

  encode([&](int i, int c) { return in.pos(i, c); }, g.row0, m, net.pos_levels, net.include_input,
         net.pe_dim, pe, t);
  encode([&](int i, int c) { return in.dir(i, c); }, g.row0, m, net.dir_levels, net.include_input,
         net.de_dim, de, t);
  g.publish();
  if constexpr (kStash) {
    g.store(st, st.acts, pn.pe(), pe, 1);
    g.store(st, st.acts, pn.de(), de, 1);
  }

  uint32_t a[P + 1];
  const uint32_t act_a = smem_u32(act);
  float acc[F / 2];
  float unused[1];

  // relu layers: h_l = relu(bf16(bf16(in W_l) + b_l)) in place, to the
  // stash with its bits; fc_in reads pe, fc_5 [pe, h4], the others h
  for (int l = 0; l < 8; ++l) {
    int n = 0;
    if (l == 0 || l == 5) a[n++] = smem_u32(pe);
    if (l != 0)
      for (int p = 0; p < P; ++p) a[n++] = act_a + p * kPanel;
    product<F, 0>(ring, a, n, 4, false, 0, acc, unused);
    g.before_write();
    relu_epilogue<F, kStash>(acc, net.b[l], act, kStash ? st.bits_word(l, g.tile64, t) : nullptr, t);
    g.publish();
    if constexpr (kStash) g.store(st, st.acts, pn.act(l), act, P);
  }

  // fc_8: the features (no relu) in place, sigma from the n8 group on the
  // image's rows [F, F + 8): its column F
  {
    float acc8[4];
    product<F, 8>(ring, a, P, 4, true, F, acc, acc8);
    g.before_write();
#pragma unroll
    for (int i = 0; i < F / 2; i += 2) {
      const int c = acc_col(t, i);
      *reinterpret_cast<bf162*>(act + swizzle128(acc_row(t, i), c, kPanel)) =
          bias_add(acc[i], acc[i + 1], net.b[8], c);
    }
    if ((t & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int gr = g.row0 + acc_row(t, i);
        const bf162 y = bias_add(acc8[i], acc8[i + 1], net.b[8], F);
        if (gr < m) st.sigma[gr] = relu_nan(__low2float(y));
      }
    }
    g.publish();
    if constexpr (kStash) g.store(st, st.acts, pn.feat(), act, P);
  }

  // fc_9 reads [feat, de] -> h9 (F/2) in place
  float acc9[F / 4];
  {
    for (int p = 0; p < P; ++p) a[p] = act_a + p * kPanel;
    a[P] = smem_u32(de);
    product<F / 2, 0>(ring, a, P + 1, 4, false, 0, acc9, unused);
    g.before_write();
    relu_epilogue<F / 2, kStash>(acc9, net.b[9], act, kStash ? st.bits_word(8, g.tile64, t) : nullptr, t);
    g.publish();
    if constexpr (kStash) g.store(st, st.acts, pn.h9(), act, H);
  }

  // fc_out -> sigmoid
  {
    float acco[4];
    for (int p = 0; p < H; ++p) a[p] = act_a + p * kPanel;
    product<8, 0>(ring, a, H, F / 2 >= 64 ? 4 : 2, false, 0, acco, unused);
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int c = acc_col(t, i);
      const int gr = g.row0 + acc_row(t, i);
      const bf162 y = bias_add(acco[i], acco[i + 1], net.b[10], c);
      const float v[2] = {__low2float(y), __high2float(y)};
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (c + e < 3 && gr < m) st.rgb[static_cast<size_t>(gr) * 3 + c + e] = 1.f / (1.f + expf(-v[e]));
    }
  }
  if constexpr (kStash) {
    if (t == 0) bulk_wait_all();
  }
}

// one 128-point CTA of the forward: the producer warpgroup streams the plan's
// weight slices, the two consumer warpgroups run forward_consumer
template <int F, bool kStash, class In>
__device__ __forceinline__ void forward_block(const In& in, const Net& net, const Stash& st, int m,
                                              const Plan& plan) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve_smem(smem_raw, kStages);
  unsigned char* act = sm.data;
  unsigned char* pe = act + (F / 64) * kPanel;
  unsigned char* de = pe + kPanel;
  Ring ring = {sm.full, sm.empty, de + kPanel, stage_bytes(F), 0};
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) produce(plan, ring);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tile64 = 2 * blockIdx.x + wg;
    const Warpgroup g = {wg, static_cast<int>(threadIdx.x & 127), tile64, 64 * tile64};
    forward_consumer<F, kStash>(in, net, st, m, act, pe, de, ring, g);
  }
}

template <int F, class In>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_forward_stash(In in, const __grid_constant__ Net net, const __grid_constant__ Stash st, int m,
                      const __grid_constant__ Plan plan) {
  forward_block<F, true>(in, net, st, m, plan);
}

// ---------------------------------------------------------------------------
// 2. the backward chain

// the dz tile (F columns) and the x panel (dz_out, then dz8's sigma panel)
__host__ __device__ inline size_t chain_smem_bytes(int feat) {
  return static_cast<size_t>(feat / 64 + 1) * kPanel + kStages * stage_bytes(feat) + smem_slack(kStages);
}

// g_sigma (m,), g_rgb (m, 3): cotangents of sigma and rgb. With kInputGrads,
// dpts, ddirs (m, 3) receive the input grads.
template <int F, bool kInputGrads, class In>
__device__ __forceinline__ void chain_consumer(const In& in, const Net& net, const Stash& st,
                                               const float* __restrict__ g_sigma,
                                               const float* __restrict__ g_rgb, float* __restrict__ dpts,
                                               float* __restrict__ ddirs, int m, unsigned char* act,
                                               unsigned char* x, Ring& ring, const Warpgroup& g) {
  constexpr int P = F / 64;
  constexpr int H = F >= 128 ? F / 128 : 1;
  const Panels pn(F);
  const int t = g.t;
  act += g.wg * kBlock;
  x += g.wg * kBlock;
  uint32_t a[P + 1];
  const uint32_t act_a = smem_u32(act);
  float acc[F / 2];
  float unused[1];
  auto act_panels = [&](int n) {
    for (int p = 0; p < n; ++p) a[p] = act_a + p * kPanel;
  };

  // dz_out = bf16(g_rgb rgb (1 - rgb)) in x's columns 0..2, zeros elsewhere
  for (int i = t; i < 64 * 8; i += 128) {
    const int r = i >> 3;
    const int ch = i & 7;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    const int gr = g.row0 + r;
    if (ch == 0 && gr < m) {
      float d[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const size_t k = static_cast<size_t>(gr) * 3 + c;
        const float y = st.rgb[k];
        d[c] = g_rgb[k] * y * (1.f - y);
      }
      v.x = bits_of(__floats2bfloat162_rn(d[0], d[1]));
      v.y = bits_of(__floats2bfloat162_rn(d[2], 0.f));
    }
    *reinterpret_cast<uint4*>(x + swizzle128(r, ch * 8, kPanel)) = v;
  }
  g.publish();
  g.store(st, st.dz, pn.dz_out(), x, 1);

  // fc_out^T: dz_out (one k16 step) x W_out -> dh9 (F/2) -> mask h9 -> dz9
  {
    float acc9[F / 4];
    const uint4 bits = *st.bits_word(8, g.tile64, t);
    a[0] = smem_u32(x);
    product<F / 2, 0>(ring, a, 1, 1, false, 0, acc9, unused);
    g.before_write();
    dz_epilogue<F / 2, true>(acc9, bits, act, t);
    g.publish();
    g.store(st, st.dz, pn.dz9(), act, H);
  }

  // fc_9^T: dz9 x W9 (rows [feat, de]) -> dfeat, dz8's feature columns;
  // dde from the n64 group on rows [F, F + 64) -> ddirs
  {
    float acc_de[32];
    act_panels(H);
    product<F, 64>(ring, a, H, F / 2 >= 64 ? 4 : 2, kInputGrads, F, acc, acc_de);
    g.before_write();
    dz_epilogue<F, false>(acc, uint4{}, act, t);
    // dz8's sigma panel: dsig = g_sigma where sigma > 0, in column 0
    for (int i = t; i < 64 * 8; i += 128) {
      const int r = i >> 3;
      const int ch = i & 7;
      const int gr = g.row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ch == 0 && gr < m && st.sigma[gr] > 0.f) v.x = bits_of(__floats2bfloat162_rn(g_sigma[gr], 0.f));
      *reinterpret_cast<uint4*>(x + swizzle128(r, ch * 8, kPanel)) = v;
    }
    if (kInputGrads) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_de[i] = __bfloat162float(__float2bfloat16_rn(acc_de[i]));
      encode_vjp(acc_de, [&](int i, int c) { return in.dir(i, c); }, g.row0, m, net.dir_levels,
                 net.include_input, net.de_dim, ddirs, t);
    }
    g.publish();
    g.store(st, st.dz, pn.dz8(), act, P);
    g.store(st, st.dz, pn.dz8() + P, x, 1);
  }

  // dh = dz W^T for fc_8 .. fc_1, masked by the relu bits of its input:
  // fc_8^T reads dz8 (F + one k16 step of the sigma panel), fc_5^T also
  // gives dpe (n64 group on rows [F, F + 64)), kept in bf16
  uint32_t dpe_keep[16];
  for (int l = 8; l >= 1; --l) {
    const uint4 bits = *st.bits_word(l - 1, g.tile64, t);
    act_panels(P);
    int slices = P, last_k = 4;
    if (l == 8) {
      a[P] = smem_u32(x);
      slices = P + 1;
      last_k = 1;
    }
    if (l == 5) {
      float acc_pe[32];
      product<F, 64>(ring, a, slices, last_k, kInputGrads, F, acc, acc_pe);
      if (kInputGrads)
#pragma unroll
        for (int i = 0; i < 16; ++i)
          dpe_keep[i] = bits_of(__floats2bfloat162_rn(acc_pe[2 * i], acc_pe[2 * i + 1]));
    } else {
      product<F, 0>(ring, a, slices, last_k, false, 0, acc, unused);
    }
    g.before_write();
    dz_epilogue<F, true>(acc, bits, act, t);
    g.publish();
    g.store(st, st.dz, pn.dz(l - 1), act, P);
  }

  if (kInputGrads) {
    // fc_in^T: dpe = bf16(dz5 W_5^T)[pe] + bf16(dz0 W_in^T) -> dpts
    float acc_in[32];
    act_panels(P);
    product<64, 0>(ring, a, P, 4, false, 0, acc_in, unused);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      bf162 kept = *reinterpret_cast<const bf162*>(&dpe_keep[i]);
      acc_in[2 * i] = __low2float(kept) + __bfloat162float(__float2bfloat16_rn(acc_in[2 * i]));
      acc_in[2 * i + 1] = __high2float(kept) + __bfloat162float(__float2bfloat16_rn(acc_in[2 * i + 1]));
    }
    encode_vjp(acc_in, [&](int i, int c) { return in.pos(i, c); }, g.row0, m, net.pos_levels,
               net.include_input, net.pe_dim, dpts, t);
  }
  if (t == 0) bulk_wait_all();
}

template <int F, bool kInputGrads, class In>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_backward_chain(In in, const __grid_constant__ Net net, const __grid_constant__ Stash st,
                       const float* __restrict__ g_sigma, const float* __restrict__ g_rgb,
                       float* __restrict__ dpts, float* __restrict__ ddirs, int m,
                       const __grid_constant__ Plan plan) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve_smem(smem_raw, kStages);
  unsigned char* act = sm.data;
  unsigned char* x = act + (F / 64) * kPanel;
  Ring ring = {sm.full, sm.empty, x + kPanel, stage_bytes(F), 0};
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) produce(plan, ring);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tile64 = 2 * blockIdx.x + wg;
    const Warpgroup g = {wg, static_cast<int>(threadIdx.x & 127), tile64, 64 * tile64};
    chain_consumer<F, kInputGrads>(in, net, st, g_sigma, g_rgb, dpts, ddirs, m, act, x, ring, g);
  }
}

// ---------------------------------------------------------------------------
// 3. dW = A^T dZ and db = sum dZ, split along the points

constexpr int kGStages = 4;
constexpr int kGA = 2 * kBlock;        // a stage's A: two 64-feature panels of 64 points
constexpr int kGStage = kGA + 4 * kBlock;  // and up to four 64-column panels of dZ
constexpr int kGemmCtas = 8 * 132;     // about eight waves of one CTA per SM
constexpr int kMaxTiles = 32;

// A CTA's work: rows [0, 128) of its dW tile are the features of stash
// panels a_panel (64 each; -1: none), its columns the `width` columns of dz
// stash panels d_panel.. . Partials: split s's at ws + s * split_w, row
// stride ld; db's at ws_db + s * split_db (null: another tile sums them).
struct GemmTile {
  int a_panel[2];
  int d_panel, width;
  float* ws;
  float* ws_db;
  int ld;
  int split_w, split_db;
};

struct GemmTiles {
  GemmTile t[kMaxTiles];
  int n, chunk;  // tiles; points a split (a multiple of 64)
};

__host__ __device__ inline size_t gemm_smem_bytes() {
  return static_cast<size_t>(kGStages) * kGStage + smem_slack(kGStages);
}

template <int W>
__device__ __forceinline__ void gemm_consumer(const GemmTile& tl, unsigned char* stages, uint64_t* full,
                                              uint64_t* empty, int steps) {
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x & 127;
  const bool has_a = tl.a_panel[wg] >= 0;
  const int col = threadIdx.x;  // the db column this thread sums
  const bool do_db = tl.ws_db != nullptr && col < W;
  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  float colsum = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int slot = s % kGStages;
    mbar_wait(&full[slot], (s / kGStages) & 1);
    unsigned char* stage = stages + slot * kGStage;
    const uint32_t base = smem_u32(stage);
    if (has_a) {
      // A^T (features x points) and dZ (points x columns), both MN-major:
      // 16 points = two 8-point atoms of 1024 bytes a k16 step
      wg_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma<W, 1, 1>(acc, sw128_desc(base + wg * kBlock + 2048 * k, kBlock, 1024),
                       sw128_desc(base + kGA + 2048 * k, kBlock, 1024), 1);
      }
      wg_commit();
    }
    if (do_db) {
      const unsigned char* d = stage + kGA;
#pragma unroll 8
      for (int r = 0; r < 64; ++r)
        colsum += __bfloat162float(*reinterpret_cast<const bf16*>(d + swizzle128(r, col, kBlock)));
    }
    if (has_a) wg_wait<1>();
    if (s > 0 && (threadIdx.x & 31) == 0) mbar_arrive(&empty[(s - 1) % kGStages]);
  }
  if (has_a) wg_wait<0>();
  fence_acc(acc);
  if (steps > 0 && (threadIdx.x & 31) == 0) mbar_arrive(&empty[(steps - 1) % kGStages]);

  if (has_a) {
    float* ws = tl.ws + static_cast<size_t>(blockIdx.y) * tl.split_w + static_cast<size_t>(wg) * 64 * tl.ld;
#pragma unroll
    for (int i = 0; i < W / 2; i += 2)
      *reinterpret_cast<float2*>(ws + static_cast<size_t>(acc_row(t, i)) * tl.ld + acc_col(t, i)) =
          make_float2(acc[i], acc[i + 1]);
  }
  if (do_db) tl.ws_db[static_cast<size_t>(blockIdx.y) * tl.split_db + col] = colsum;
}

// grid (tiles, splits): each CTA one tile over one slice of the points of
// the stashes; acts / dz as Stash, m_pad their rows. (This kernel and
// dw_reduce are static: a library of several translation units that
// include this header holds one of each a unit.)
static __global__ void __launch_bounds__(kThreads, 1)
    dw_gemm(const __grid_constant__ GemmTiles tiles, const unsigned char* __restrict__ acts,
            const unsigned char* __restrict__ dz, int m, int m_pad) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve_smem(smem_raw, kGStages);
  const GemmTile& tl = tiles.t[blockIdx.x];
  const int p_begin = blockIdx.y * tiles.chunk;
  const int p_end = min((m + 63) / 64 * 64, p_begin + tiles.chunk);
  const int steps = p_end > p_begin ? (p_end - p_begin) / 64 : 0;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      const int na = (tl.a_panel[0] >= 0) + (tl.a_panel[1] >= 0);
      const uint32_t bytes = na * kBlock + tl.width * 128;
      for (int s = 0; s < steps; ++s) {
        const int slot = s % kGStages;
        if (s >= kGStages) mbar_wait(&sm.empty[slot], (s / kGStages - 1) & 1);
        mbar_expect_tx(&sm.full[slot], bytes);
        unsigned char* stage = sm.data + slot * kGStage;
        const size_t p0 = p_begin + 64 * s;
        for (int w = 0; w < 2; ++w)
          if (tl.a_panel[w] >= 0)
            bulk_load(stage + w * kBlock, acts + (static_cast<size_t>(tl.a_panel[w]) * m_pad + p0) * 128, kBlock,
                      &sm.full[slot]);
        for (int d = 0; d < tl.width / 64; ++d)
          bulk_load(stage + kGA + d * kBlock, dz + (static_cast<size_t>(tl.d_panel + d) * m_pad + p0) * 128,
                    kBlock, &sm.full[slot]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    if (tl.width == 256) gemm_consumer<256>(tl, sm.data, sm.full, sm.empty, steps);
    else if (tl.width == 128) gemm_consumer<128>(tl, sm.data, sm.full, sm.empty, steps);
    else gemm_consumer<64>(tl, sm.data, sm.full, sm.empty, steps);
  }
}

// One layer's partials (splits, rows_pad, cols_pad) and db partials
// (splits, cols_pad), and where each 64-row and 64-column panel of them
// lands in the public (rows, out_ld) dW and db.
struct ReduceJob {
  const float* ws;
  const float* ws_db;
  int rows_pad, cols_pad;
  int a_row0[5], a_valid[5];
  int d_col0[5], d_valid[5];
  float* out;
  float* db_out;
  int out_ld;
};

struct ReduceJobs {
  ReduceJob j[kLayers];
  int splits;
};

// grid (blocks, layers): out = sum over splits of the partials, in split order
static __global__ void dw_reduce(const __grid_constant__ ReduceJobs jobs) {
  const ReduceJob& j = jobs.j[blockIdx.y];
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (j.rows_pad + 1) * j.cols_pad) return;
  const int r = idx / j.cols_pad;  // row rows_pad: db
  const int c = idx - r * j.cols_pad;
  if ((c & 63) >= j.d_valid[c >> 6]) return;
  const int col = j.d_col0[c >> 6] + (c & 63);
  float s = 0.f;
  if (r == j.rows_pad) {
    for (int sp = 0; sp < jobs.splits; ++sp) s += j.ws_db[static_cast<size_t>(sp) * j.cols_pad + c];
    j.db_out[col] = s;
    return;
  }
  if ((r & 63) >= j.a_valid[r >> 6]) return;
  const size_t split = static_cast<size_t>(j.rows_pad) * j.cols_pad;
  for (int sp = 0; sp < jobs.splits; ++sp) s += j.ws[sp * split + static_cast<size_t>(r) * j.cols_pad + c];
  j.out[static_cast<size_t>(j.a_row0[r >> 6] + (r & 63)) * j.out_ld + col] = s;
}

// ---------------------------------------------------------------------------
// host side

inline size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

inline int padded_points(int m) { return (m + kRows - 1) / kRows * kRows; }

// The GEMM tiles and reduce jobs of the 11 layers for m points.
// grads_w / grads_b: the public f32 gradients; ws == null only counts the
// partials' floats.
struct Segment {
  int panel, first, valid;  // stash panel; public row (column) of its first; how many
};

struct LayerGemm {
  Segment a[5];
  int na;
  Segment d[5];
  int nd;
  int groups[2];  // dz panels of the first and second column tile (second: 0 or 1)
  int out_ld;
};

inline void layer_gemms(int feat, int pe_dim, int de_dim, LayerGemm* out) {
  const Panels pn(feat);
  const int P = pn.p, H = pn.h;
  auto full = [&](LayerGemm& g, int panel0, int n, int first, bool rows) {
    for (int p = 0; p < n; ++p) {
      Segment s = {panel0 + p, first + 64 * p, 64};
      if (rows) g.a[g.na++] = s;
      else g.d[g.nd++] = s;
    }
  };
  for (int l = 0; l < kLayers; ++l) {
    LayerGemm& g = out[l];
    g.na = g.nd = 0;
    g.out_ld = feat;
    g.groups[0] = P;
    g.groups[1] = 0;
    if (l == 0 || l == 5) g.a[g.na++] = {pn.pe(), 0, pe_dim};
    if (l >= 1 && l <= 8) full(g, pn.act(l - 1), P, l == 5 ? pe_dim : 0, true);
    if (l <= 7) full(g, pn.dz(l), P, 0, false);
    if (l == 8) {  // dz8: features -> public columns 1.., sigma's panel -> column 0
      full(g, pn.dz8(), P, 1, false);
      g.d[g.nd++] = {pn.dz8() + P, 0, 1};
      g.groups[1] = 1;
      g.out_ld = feat + 1;
    }
    if (l == 9) {
      full(g, pn.feat(), P, 0, true);
      g.a[g.na++] = {pn.de(), feat, de_dim};
      for (int p = 0; p < H; ++p) g.d[g.nd++] = {pn.dz9() + p, 64 * p, feat / 2 - 64 * p < 64 ? feat / 2 - 64 * p : 64};
      g.groups[0] = H;
      g.out_ld = feat / 2;
    }
    if (l == 10) {
      for (int p = 0; p < H; ++p) g.a[g.na++] = {pn.h9() + p, 64 * p, feat / 2 - 64 * p < 64 ? feat / 2 - 64 * p : 64};
      g.d[g.nd++] = {pn.dz_out(), 0, 3};
      g.groups[0] = 1;
      g.out_ld = 3;
    }
  }
}

inline int gemm_tiles(int feat) {
  LayerGemm lg[kLayers];
  layer_gemms(feat, 0, 0, lg);
  int n = 0;
  for (int l = 0; l < kLayers; ++l) n += (lg[l].na + 1) / 2 * (lg[l].groups[1] ? 2 : 1);
  return n;
}

// points a split: about kGemmCtas CTAs in all, at least 512 points, a
// multiple of the 64-point stage
inline void gemm_splits(int m, int feat, int* splits, int* chunk) {
  const long long m64 = (m + 63) / 64 * 64;
  long long c = (m64 * gemm_tiles(feat) + kGemmCtas - 1) / kGemmCtas;
  c = (c + 63) / 64 * 64;
  if (c < 512) c = 512;
  *chunk = static_cast<int>(c);
  *splits = m64 > 0 ? static_cast<int>((m64 + c - 1) / c) : 1;
}

inline size_t make_jobs(int feat, int pe_dim, int de_dim, int m, float* const* grads_w,
                        float* const* grads_b, float* ws, GemmTiles* tiles, ReduceJobs* jobs) {
  LayerGemm lg[kLayers];
  layer_gemms(feat, pe_dim, de_dim, lg);
  int splits, chunk;
  gemm_splits(m, feat, &splits, &chunk);
  size_t total = 0;
  int nt = 0;
  for (int l = 0; l < kLayers; ++l) {
    const LayerGemm& g = lg[l];
    const int rows_pad = 64 * g.na, cols_pad = 64 * g.nd;
    float* w = ws ? ws + total : nullptr;
    float* db = ws ? ws + total + static_cast<size_t>(splits) * rows_pad * cols_pad : nullptr;
    total += align256(static_cast<size_t>(splits) * (rows_pad + 1) * cols_pad);
    if (!ws) continue;
    ReduceJob& j = jobs->j[l];
    j.ws = w;
    j.ws_db = db;
    j.rows_pad = rows_pad;
    j.cols_pad = cols_pad;
    for (int i = 0; i < 5; ++i) {
      j.a_row0[i] = i < g.na ? g.a[i].first : 0;
      j.a_valid[i] = i < g.na ? g.a[i].valid : 0;
      j.d_col0[i] = i < g.nd ? g.d[i].first : 0;
      j.d_valid[i] = i < g.nd ? g.d[i].valid : 0;
    }
    j.out = grads_w[l];
    j.db_out = grads_b[l];
    j.out_ld = g.out_ld;
    for (int kt = 0; kt < (g.na + 1) / 2; ++kt) {
      int d0 = 0;
      for (int gi = 0; gi < 2 && g.groups[gi]; ++gi) {
        GemmTile& tl = tiles->t[nt++];
        tl.a_panel[0] = g.a[2 * kt].panel;
        tl.a_panel[1] = 2 * kt + 1 < g.na ? g.a[2 * kt + 1].panel : -1;
        tl.d_panel = g.d[d0].panel;
        tl.width = 64 * g.groups[gi];
        tl.ws = w + static_cast<size_t>(128 * kt) * cols_pad + 64 * d0;
        tl.ws_db = kt == 0 ? db + 64 * d0 : nullptr;
        tl.ld = cols_pad;
        tl.split_w = rows_pad * cols_pad;
        tl.split_db = cols_pad;
        d0 += g.groups[gi];
      }
    }
  }
  if (ws) {
    tiles->n = nt;
    tiles->chunk = chunk;
    jobs->splits = splits;
  }
  return total;
}

inline size_t gemm_ws_bytes(int m, int feat) {
  return make_jobs(feat, 0, 0, m, nullptr, nullptr, nullptr, nullptr, nullptr) * sizeof(float);
}

// Bytes of the stashes, sigma and rgb for m points.
inline size_t stash_bytes(int m, int feat) {
  const Panels pn(feat);
  const size_t mp = padded_points(m);
  return align256(mp * pn.acts() * 128) + align256(mp * pn.dzs() * 128) + align256(9 * mp * 32) +
         align256(static_cast<size_t>(m) * sizeof(float)) + align256(static_cast<size_t>(m) * 3 * sizeof(float));
}

inline Stash carve_stash(unsigned char* base, int m, int feat, size_t* used) {
  const Panels pn(feat);
  const size_t mp = padded_points(m);
  Stash st;
  size_t off = 0;
  st.acts = base + off;
  off += align256(mp * pn.acts() * 128);
  st.dz = base + off;
  off += align256(mp * pn.dzs() * 128);
  st.bits = reinterpret_cast<uint4*>(base + off);
  off += align256(9 * mp * 32);
  st.sigma = reinterpret_cast<float*>(base + off);
  off += align256(static_cast<size_t>(m) * sizeof(float));
  st.rgb = reinterpret_cast<float*>(base + off);
  off += align256(static_cast<size_t>(m) * 3 * sizeof(float));
  st.m_pad = static_cast<int>(mp);
  *used = off;
  return st;
}

inline Net make_net(const void* const* fwd, const void* const* bias, const void* const* chain,
                    int pos_levels, int dir_levels, int include_input, int pe_dim, int de_dim) {
  Net net;
  for (int l = 0; l < kLayers; ++l) {
    net.fwd[l] = static_cast<const unsigned char*>(fwd[l]);
    net.chain[l] = chain ? static_cast<const unsigned char*>(chain[l]) : nullptr;  // null: kernel 1
    net.b[l] = static_cast<const bf16*>(bias[l]);
  }
  net.pos_levels = pos_levels;
  net.dir_levels = dir_levels;
  net.include_input = include_input;
  net.pe_dim = pe_dim;
  net.de_dim = de_dim;
  return net;
}

// `slices` K-slices of an image of `rows` rows, the first `load_rows` of each
inline void add_slices(Plan& plan, const unsigned char* image, int slices, int rows, int load_rows) {
  for (int s = 0; s < slices; ++s) {
    plan.src[plan.n] = image + static_cast<size_t>(s) * rows * 128;
    plan.bytes[plan.n] = load_rows * 128;
    ++plan.n;
  }
}

inline Plan forward_plan(const Net& net, int f) {
  const Panels pn(f);
  Plan plan;
  plan.n = 0;
  add_slices(plan, net.fwd[0], 1, f, f);
  for (int l = 1; l < 8; ++l) add_slices(plan, net.fwd[l], l == 5 ? pn.p + 1 : pn.p, f, f);
  add_slices(plan, net.fwd[8], pn.p, f + 8, f + 8);
  add_slices(plan, net.fwd[9], pn.p + 1, f / 2, f / 2);
  add_slices(plan, net.fwd[10], pn.h, 8, 8);
  return plan;
}

inline Plan chain_plan(const Net& net, int f, bool input_grads) {
  const Panels pn(f);
  const int skip_rows = input_grads ? f + 64 : f;  // fc_9's de rows, fc_5's pe rows
  Plan plan;
  plan.n = 0;
  add_slices(plan, net.chain[10], 1, f / 2, f / 2);
  add_slices(plan, net.chain[9], pn.h, f + 64, skip_rows);
  add_slices(plan, net.chain[8], pn.p + 1, f, f);
  for (int l = 7; l >= 1; --l) {
    if (l == 5) add_slices(plan, net.chain[5], pn.p, f + 64, skip_rows);
    else add_slices(plan, net.chain[l], pn.p, f, f);
  }
  if (input_grads) add_slices(plan, net.chain[0], pn.p, 64, 64);
  return plan;
}

template <class Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

template <int F, class In>
inline cudaError_t forward_f(const In& in, const Net& net, const Stash& st, int m, cudaStream_t stream) {
  const size_t smem = forward_smem_bytes(F);
  cudaError_t err = set_smem(mlp_forward_stash<F, In>, smem);
  if (err != cudaSuccess) return err;
  mlp_forward_stash<F, In><<<st.m_pad / kRows, kThreads, smem, stream>>>(in, net, st, m, forward_plan(net, F));
  return cudaGetLastError();
}

template <int F, bool kInputGrads, class In>
inline cudaError_t chain_f(const In& in, const Net& net, const Stash& st, const float* g_sigma,
                           const float* g_rgb, float* dpts, float* ddirs, int m, cudaStream_t stream) {
  const size_t smem = chain_smem_bytes(F);
  cudaError_t err = set_smem(mlp_backward_chain<F, kInputGrads, In>, smem);
  if (err != cudaSuccess) return err;
  mlp_backward_chain<F, kInputGrads, In><<<st.m_pad / kRows, kThreads, smem, stream>>>(
      in, net, st, g_sigma, g_rgb, dpts, ddirs, m, chain_plan(net, F, kInputGrads));
  return cudaGetLastError();
}

// forward with stash: the part both kernels share
template <class In>
inline cudaError_t run_forward(const In& in, const Net& net, const Stash& st, int m, int feat,
                               cudaStream_t stream) {
  switch (feat) {
    case 64: return forward_f<64>(in, net, st, m, stream);
    case 128: return forward_f<128>(in, net, st, m, stream);
    case 256: return forward_f<256>(in, net, st, m, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kInputGrads, class In>
inline cudaError_t run_chain(const In& in, const Net& net, const Stash& st, const float* g_sigma,
                             const float* g_rgb, float* dpts, float* ddirs, int m, int feat,
                             cudaStream_t stream) {
  switch (feat) {
    case 64: return chain_f<64, kInputGrads>(in, net, st, g_sigma, g_rgb, dpts, ddirs, m, stream);
    case 128: return chain_f<128, kInputGrads>(in, net, st, g_sigma, g_rgb, dpts, ddirs, m, stream);
    case 256: return chain_f<256, kInputGrads>(in, net, st, g_sigma, g_rgb, dpts, ddirs, m, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The dW/db GEMMs of every layer, then the reductions into the public grads.
inline cudaError_t run_gemms(const Net& net, const Stash& st, int m, int feat, float* ws,
                             float* const* grads_w, float* const* grads_b, cudaStream_t stream) {
  GemmTiles tiles;
  ReduceJobs jobs;
  make_jobs(feat, net.pe_dim, net.de_dim, m, grads_w, grads_b, ws, &tiles, &jobs);
  cudaError_t err = set_smem(dw_gemm, gemm_smem_bytes());
  if (err != cudaSuccess) return err;
  dw_gemm<<<dim3(tiles.n, jobs.splits), kThreads, gemm_smem_bytes(), stream>>>(tiles, st.acts, st.dz, m,
                                                                               st.m_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int most = 0;
  for (int l = 0; l < kLayers; ++l) {
    const int n = (jobs.j[l].rows_pad + 1) * jobs.j[l].cols_pad;
    most = n > most ? n : most;
  }
  dw_reduce<<<dim3((most + 255) / 256, kLayers), 256, 0, stream>>>(jobs);
  return cudaGetLastError();
}

}  // namespace nerf_train
