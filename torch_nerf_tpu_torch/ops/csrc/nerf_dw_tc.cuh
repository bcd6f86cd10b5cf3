// The general route's dW GEMM on Hopper's tensor cores: dW = A^T dZ and db =
// sum dZ for the 11 layers, over nerf_stash.cuh's row-major stashes
// ((m_pad, width) each, in the compute type), for kernels 2 and 3 on every
// general config (nerf_general::run_dw calls it from the entries).
//
// Replaces, with the forward and the chain of the general route, the
// parameter-gradient sums of the Pallas TPU kernels torch_nerf_tpu/ops/
// pallas/fused_nerf.py::_bwd_kernel and fused_train.py::_train_kernel (there
// carried in VMEM over sequential grid steps). Bound on an H100 SXM: 2 x
// rows x dz columns a point a layer at 989 TFLOP/s dense bf16 (989 / 8 for
// f32: eight bf16 products a multiply-add), against each stash read once
// at 3.35 TB/s (nerf_general::stash_bytes); at width 512 in bf16 the two
// are about equal (~4.9 ms a fine pass of 786,432 points).
//
// Design (the hopper-kernels guide's shape: TMA ring, one producer warp,
// two consumer warpgroups on wgmma):
//   - Operands by TMA. One tensor map per stash (12 activations, 11 dz's),
//     encoded on the host by cuTensorMapEncodeTiled (reached through
//     cudaGetDriverEntryPoint: no -lcuda) and passed in the kernel's
//     __grid_constant__ parameters. A box is 64 points x 64 columns; in
//     bf16 it lands under CU_TENSOR_MAP_SWIZZLE_128B as one 128-byte
//     swizzled panel, the MN-major operand form wgmma reads (the preset
//     dw_gemm's, nerf_mlp_train.cuh). Rows past m and columns past a
//     stash's width come in as zeros (TMA's out-of-bounds fill): fc_out's
//     16-wide dz, fc_8's F + 16, fc_9's F/2 and the 16-padded encodings.
//   - Tiles. A CTA owns a 128 x N tile of one layer's dW (N = 256, 128 or
//     64 by the dz's width; f32 at most 128: a 64 x 256 fold beside a
//     64 x 256 accumulator is 256 registers a thread) over one slice of
//     the points: two consumer warpgroups of 64 rows each
//     (wgmma.m64nNk16), one producer thread issuing the TMA loads of a
//     ring of 64-point stages (bf16 4 deep; f32 2, beside its pieces).
//   - Slice-major order. Grid (jobs, slices), the job fastest: the tiles
//     of all layers that share a slice start together and walk it in
//     step, so a slice's A and dZ strips come from device memory once and
//     from L2 for the other tiles. A slice is kSlice points (fewer where
//     two waves of CTAs would not fill the card): the shorter the slice,
//     the closer in step a slice's tiles stay, against one partial a
//     (tile, slice) to write and reduce. The slices go in windows of at
//     most kWaves waves of CTAs, a launch of the kernel and of the reduce
//     each, into two buffers of partials taken in turn, so the partials
//     stay under 2 x kWaves x 132 of them (279 MB bf16, 139 MB f32)
//     whatever the point count. Windows alternate between the caller's
//     stream and a second one, so that a window's CTAs start as the last
//     one's drain and its reduce runs beside the next window (each window
//     alone on one stream read 12% slower: PERF.md, section 6) (4096 timed
//     best of 2048-16384;
//     a CTA summing four slices a lane count apart into one partial,
//     2-CTA clusters multicasting their shared dZ tile, and each slice
//     adding its sums to its tile's running sum in turn, in place of the
//     partials and the reduce, ran slower: PERF.md, section 6).
//   - bf16: wgmma on the TMA-loaded panels, f32 sums in registers over the
//     whole slice; each stage released as soon as its products are done.
//   - f32: each stage's f32 boxes (unswizzled, 256 bytes a row) are split
//     by the consumers into three bf16 pieces (x = x0 + x1 + x2 exactly,
//     nerf_mlp_tc.cuh's split3), written as swizzled panels, 32 points at
//     a time into one of two buffers while the other half-stage's
//     products run; 8 of the 9 piece products (x2 z2 dropped), the small
//     ones first, go to a fresh accumulator each 32-point half, which is
//     folded into f32 registers by a rounding add: the tensor core
//     truncates as it accumulates, so one accumulator over a slice would
//     lose ~K x 2^-24 (PERF.md, section 6).
//   - db in the same pass: the tile with the layer's first row block sums
//     its staged dZ columns in f32, point by point in order, compensated
//     (Kahan: a plain f32 sum over a slice's 4096 points read 14x the
//     plain version's error).
//   - The reduce sums each tile's partials over a window's slices in slice
//     order into the kernel-layout grads, the next window's reduce going
//     on from that sum: one sum in slice order over all the slices. No
//     atomics: two launches give the same grads bit for bit.
//   - launches() counts the kernel's launches (each window's), read by
//     the libraries' *_dw_launches for the wrappers' launch counts.
//
// Planted faults (fault(), set by the libraries' *_set_dw_fault for the
// checks in chip_smoke.py; 0 in every other use): a slice skipped, a
// tile's db dropped, the A panel's descriptor one 16-byte chunk off its
// swizzle, the f32 low piece dropped, the f32 low and middle pieces
// dropped.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "nerf_mlp_train.cuh"

namespace nerf_dw {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
using nerf_train::acc_col;
using nerf_train::acc_row;
using nerf_train::fence_acc;
using nerf_train::mbar_arrive;
using nerf_train::mbar_expect_tx;
using nerf_train::smem_u32;
using nerf_train::sw128_desc;
using nerf_train::swizzle128;
using nerf_train::wg_commit;
using nerf_train::wg_fence;
using nerf_train::wg_wait;

constexpr int kLayers = 11;
constexpr int kActs = 12;           // stash activations: pe, de, h0..h7, features, h9
constexpr int kMaps = kActs + kLayers;  // then the 11 dz's
constexpr int kThreads = 384;       // two consumer warpgroups + the producer's
constexpr int kPanel = 64 * 128;    // a bf16 panel: 64 points x 128 bytes
constexpr int kSMs = 132;
constexpr int kSlice = 4096;       // points a CTA sums (2048, 8192 and 16384 ran slower)
constexpr int kMinSlice = 1024;
constexpr int kWaves = 8;           // CTAs of a window: at most kWaves x kSMs

enum Fault { kNoFault = 0, kSliceSkipped = 1, kDbDropped = 2, kSwizzleOff = 3, kLowPieceDropped = 4,
             kLowPiecesDropped = 5 };

inline int& fault() {
  static int f = kNoFault;
  return f;
}

// dw_tc_kernel's launches in this library
inline long long& launches() {
  static long long n = 0;
  return n;
}

template <class T>
struct Shape;
template <>
struct Shape<bf16> {
  static constexpr int kMaxN = 256;
  static constexpr int kStages = 4;
  static constexpr int kBox = kPanel;                   // a 64 x 64 box
  static constexpr int kStageBytes = 6 * kPanel;        // A: 2 boxes (a warpgroup's rows each); dZ: up to 4
  static constexpr int kPieceBytes = 0;
};
// f32 pieces: a half-stage's (32 points) panels of 32 rows x 128 bytes;
// a piece is A's 2 panels, then dZ's 2; a buffer the three pieces
constexpr int kHalfPanel = 32 * 128;
constexpr int kHalfPiece = 4 * kHalfPanel;
constexpr int kHalfBuffer = 3 * kHalfPiece;

template <>
struct Shape<float> {
  static constexpr int kMaxN = 128;
  static constexpr int kStages = 2;
  static constexpr int kBox = 2 * kPanel;               // 64 x 64 f32
  static constexpr int kStageBytes = 4 * 2 * kPanel;    // A: 2 boxes; dZ: up to 2
  static constexpr int kPieceBytes = 2 * kHalfBuffer;   // two half-stage buffers
};

// one partial: the 128 x N sums, then db's N, at N = kMaxN's stride
template <class T>
__host__ __device__ constexpr int part_floats() {
  return 128 * Shape<T>::kMaxN + Shape<T>::kMaxN;
}

template <class T>
__host__ __device__ inline size_t smem_bytes() {
  return static_cast<size_t>(Shape<T>::kStages) * Shape<T>::kStageBytes + Shape<T>::kPieceBytes +
         nerf_train::smem_slack(Shape<T>::kStages);
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// the column tiles of a dz of `nwidth` columns: kMaxN-wide ones, then the
// rest (in 64s) as 128 and 64
__host__ __device__ inline int n_tiles(int nwidth, int maxn) {
  const int w64 = cdiv(nwidth, 64) * 64;
  const int rem = w64 % maxn;
  return w64 / maxn + (rem >= 128) + (rem % 128 == 64);
}

__host__ __device__ inline void n_tile(int nwidth, int maxn, int nb, int& col0, int& n) {
  const int w64 = cdiv(nwidth, 64) * 64;
  const int full = w64 / maxn;
  col0 = nb * maxn;
  n = maxn;
  if (nb < full) return;
  col0 = full * maxn;
  const int rem = w64 - col0;
  if (rem >= 128 && nb == full) {
    n = 128;
    return;
  }
  n = 64;
  if (rem >= 128) col0 += 128;
}

// A's segments of a layer (fc_5: [pe, h4], fc_9: [features, de])
struct Seg {
  int map, width, row_off, kblocks;  // kblocks: 128-row blocks
};

struct Layer {
  Seg seg[2];
  int nseg, zmap, nwidth, ntiles, first_job;
  float* gw;  // (rows, nwidth) f32, kernel layout
  float* gb;  // (nwidth,) f32
};

struct Plan {
  CUtensorMap maps[kMaps];
  Layer l[kLayers];
  int jobs, splits, chunk, m, fault;
  int window, windows;  // slices a launch, launches
  int slice0;           // this launch's first slice
};

// the stashes as nerf_general's carve_stash lays them out
struct Stashes {
  const void* act[kActs];
  int act_width[kActs];
  const void* dz[kLayers];
  int dz_width[kLayers];
};

// a job: one 128 x n tile (A's row block kb of segment seg, dz columns
// [col0, col0 + n)) of one layer; kbi the row block over both segments
struct Job {
  int layer, seg, kb, kbi, col0, n;
};

__host__ __device__ inline Job job_of(const Plan& p, int job, int maxn) {
  int l = 0;
  while (l + 1 < kLayers && p.l[l + 1].first_job <= job) ++l;
  const Layer& L = p.l[l];
  const int j = job - L.first_job;
  Job o;
  o.layer = l;
  o.kbi = j / L.ntiles;
  o.seg = o.kbi < L.seg[0].kblocks ? 0 : 1;
  o.kb = o.kbi - (o.seg ? L.seg[0].kblocks : 0);
  n_tile(L.nwidth, maxn, j - o.kbi * L.ntiles, o.col0, o.n);
  return o;
}

// ---------------------------------------------------------------------------
// device side

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// until the phase of parity `parity` has completed; a ring out of step
// traps after ~2^35 cycles instead of holding the card
__device__ __forceinline__ void await_phase(uint64_t* bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// the box at (col, row) of `map` into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// the 256 consumer threads (barrier 0 is __syncthreads', 1-2 nerf_train's
// wg_sync)
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 3, 256;\n" ::: "memory"); }

// one producer thread: each stage's two A boxes (the tile's 128 rows) and
// its n / 64 dZ boxes
template <class T>
__device__ __forceinline__ void produce(const Plan& plan, const Layer& L, const Job& jb,
                                        const nerf_train::Smem& sm, int p_begin, int steps) {
  constexpr int S = Shape<T>::kStages;
  constexpr int B = Shape<T>::kBox;
  const CUtensorMap* amap = &plan.maps[L.seg[jb.seg].map];
  const CUtensorMap* zmap = &plan.maps[L.zmap];
  const int acol = 128 * jb.kb;
  const int nz = jb.n / 64;
  const uint32_t bytes = (2 + nz) * B;
  for (int s = 0; s < steps; ++s) {
    const int slot = s % S;
    if (s >= S) await_phase(&sm.empty[slot], (s / S - 1) & 1);
    mbar_expect_tx(&sm.full[slot], bytes);
    unsigned char* st = sm.data + slot * Shape<T>::kStageBytes;
    const int row = p_begin + 64 * s;
    tma_load(st, amap, acol, row, &sm.full[slot]);
    tma_load(st + B, amap, acol + 64, row, &sm.full[slot]);
    for (int d = 0; d < nz; ++d) tma_load(st + (2 + d) * B, zmap, jb.col0 + 64 * d, row, &sm.full[slot]);
  }
}

// the warpgroup's 64 x N sums to the partial (row-major, ld N), then db
template <int N>
__device__ __forceinline__ void store_partial(const float (&acc)[N / 2], float* out, bool db, float colsum) {
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2)
    *reinterpret_cast<float2*>(out + (64 * wg + acc_row(t, i)) * N + acc_col(t, i)) = make_float2(acc[i], acc[i + 1]);
  if (db) out[128 * N + threadIdx.x] = colsum;
}

// sum += x, compensated: comp carries what the rounding of sum lost
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = x - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// bf16: wgmma on the TMA panels, one accumulator over the slice
template <int N>
__device__ __forceinline__ void consume_bf16(const Plan& plan, const nerf_train::Smem& sm, int steps, bool db_owner,
                                             bool db_zero, float* out) {
  constexpr int S = Shape<bf16>::kStages;
  const int wg = threadIdx.x / 128;
  const int col = threadIdx.x;  // the db column this thread sums
  const bool do_db = db_owner && col < N;
  const uint32_t aoff = wg * kPanel + (plan.fault == kSwizzleOff ? 16 : 0);
  // the first product starts the sums (scale 0): accumulators set by other
  // instructions made ptxas serialize the wgmma (C7515)
  float acc[N / 2];
  float colsum = 0.f, comp = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int slot = s % S;
    await_phase(&sm.full[slot], (s / S) & 1);
    const unsigned char* st = sm.data + slot * Shape<bf16>::kStageBytes;
    const uint32_t base = smem_u32(st);
    // A^T (features x points) and dZ (points x columns), both MN-major:
    // a k16 step is 16 points, two 8-point atoms of 1024 bytes
    wg_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      nerf_train::wgmma<N, 1, 1>(acc, sw128_desc(base + aoff + 2048 * k, kPanel, 1024),
                                 sw128_desc(base + 2 * kPanel + 2048 * k, kPanel, 1024), (s | k) != 0);
    wg_commit();
    if (do_db) {
      const unsigned char* z = st + 2 * kPanel;
#pragma unroll 8
      for (int r = 0; r < 64; ++r)
        kahan_add(colsum, comp, __bfloat162float(*reinterpret_cast<const bf16*>(z + swizzle128(r, col, kPanel))));
    }
    wg_wait<0>();  // released at once: the producer refills it while the other warpgroup computes
    if ((threadIdx.x & 31) == 0) mbar_arrive(&sm.empty[slot]);
  }
  fence_acc(acc);
  if (steps == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  }
  store_partial<N>(acc, out, do_db, db_zero ? 0.f : colsum);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// four f32 values of row r, columns c..c+3 (c % 4 == 0) -> their three bf16
// pieces, each at swizzle128(r, c) of its panel (pieces kHalfPiece apart);
// x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1), x0 + x1 + x2 == x
__device__ __forceinline__ void put_pieces(unsigned char* panel, int r, int c, float4 v, int fault) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  float p[3][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    p[0][e] = __bfloat162float(__float2bfloat16_rn(x[e]));
    const float rest = x[e] - p[0][e];
    p[1][e] = __bfloat162float(__float2bfloat16_rn(rest));
    p[2][e] = rest - p[1][e];
  }
  const uint32_t at = swizzle128(r, c, kHalfPanel);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const bool dropped = (i == 2 && fault >= kLowPieceDropped) || (i == 1 && fault == kLowPiecesDropped);
    const uint2 w = dropped ? make_uint2(0u, 0u) : make_uint2(pack_bf16(p[i][0], p[i][1]), pack_bf16(p[i][2], p[i][3]));
    *reinterpret_cast<uint2*>(panel + i * kHalfPiece + at) = w;
  }
}

// f32: each 64-point stage is taken as two 32-point halves; a half's f32
// rows are split into three bf16 pieces in one of two buffers while the
// other half's 8 piece products run, so the split and the tensor cores
// overlap. A half's products go to a fresh accumulator, the small ones
// first, folded into `sum` by an f32 add.
template <int N>
__device__ __forceinline__ void consume_f32(const Plan& plan, const nerf_train::Smem& sm, int steps, bool db_owner,
                                            bool db_zero, float* out) {
  constexpr int S = Shape<float>::kStages;
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x & 127;
  const int tid = threadIdx.x;
  const bool do_db = db_owner && tid < N;
  unsigned char* pieces = sm.data + S * Shape<float>::kStageBytes;
  const uint32_t pb = smem_u32(pieces);
  const uint32_t aoff = wg * kHalfPanel + (plan.fault == kSwizzleOff ? 16 : 0);
  // the products x_i z_j (i + j <= 3), the smallest first
  constexpr int kOrder[8][2] = {{1, 2}, {2, 1}, {0, 2}, {2, 0}, {1, 1}, {0, 1}, {1, 0}, {0, 0}};
  float acc[N / 2], sum[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] = acc[i] = 0.f;
  float colsum = 0.f, comp = 0.f;
  // half h's rows of its stage -> piece buffer h % 2
  auto split = [&](int h) {
    const int s = h >> 1, slot = s % S, r0 = 32 * (h & 1);
    if ((h & 1) == 0) await_phase(&sm.full[slot], (s / S) & 1);
    const unsigned char* st = sm.data + slot * Shape<float>::kStageBytes;
    unsigned char* buf = pieces + (h & 1) * kHalfBuffer;
    // this warpgroup's A box (its 64 features) -> its piece panels
    const float* a32 = reinterpret_cast<const float*>(st + wg * Shape<float>::kBox) + r0 * 64;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = t + 128 * i;
      const int r = idx >> 4, c = (idx & 15) * 4;
      put_pieces(buf + wg * kHalfPanel, r, c, *reinterpret_cast<const float4*>(a32 + r * 64 + c), plan.fault);
    }
    // the dZ boxes -> their piece panels
    const float* z32 = reinterpret_cast<const float*>(st + 2 * Shape<float>::kBox);
#pragma unroll
    for (int i = 0; i < N / 32; ++i) {
      const int idx = tid + 256 * i;
      const int d = idx >> 9, r = (idx >> 4) & 31, c = (idx & 15) * 4;
      put_pieces(buf + (2 + d) * kHalfPanel, r, c,
                 *reinterpret_cast<const float4*>(z32 + d * 4096 + (r0 + r) * 64 + c), plan.fault);
    }
    if (do_db) {
      const float* zc = z32 + (tid >> 6) * 4096 + r0 * 64 + (tid & 63);
#pragma unroll 8
      for (int r = 0; r < 32; ++r) kahan_add(colsum, comp, zc[r * 64]);
    }
    if ((h & 1) && (threadIdx.x & 31) == 0) mbar_arrive(&sm.empty[slot]);  // the f32 stage is free
    nerf_train::fence_async_smem();
  };
  const int halves = 2 * steps;
  if (halves > 0) split(0);
  consumers_sync();
  for (int h = 0; h < halves; ++h) {
    const uint32_t buf = pb + (h & 1) * kHalfBuffer;
    wg_fence();
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        nerf_train::wgmma<N, 1, 1>(acc, sw128_desc(buf + kOrder[q][0] * kHalfPiece + aoff + 2048 * k, kHalfPanel, 1024),
                                   sw128_desc(buf + kOrder[q][1] * kHalfPiece + 2 * kHalfPanel + 2048 * k,
                                              kHalfPanel, 1024),
                                   (q | k) != 0);
    wg_commit();
    if (h + 1 < halves) split(h + 1);  // beside the products in flight
    wg_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sum[i] += acc[i];
    consumers_sync();  // half h + 1's pieces written, half h's products done in both warpgroups
  }
  store_partial<N>(sum, out, do_db, db_zero ? 0.f : colsum);
}

// grid (jobs, a window's slices): one tile of one layer over one slice of
// the points; part: the window's buffer
template <class T>
__global__ void __launch_bounds__(kThreads, 1) dw_tc_kernel(const __grid_constant__ Plan plan, float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  const nerf_train::Smem sm = nerf_train::carve_smem(smem_raw, Shape<T>::kStages);
  const Job jb = job_of(plan, blockIdx.x, Shape<T>::kMaxN);
  const Layer& L = plan.l[jb.layer];
  const int split = plan.slice0 + blockIdx.y;
  const int p_begin = split * plan.chunk;
  const int p_end = min(plan.m, p_begin + plan.chunk);
  int steps = p_end > p_begin ? cdiv(p_end - p_begin, 64) : 0;
  if (plan.fault == kSliceSkipped && split == 0) steps = 0;
  float* out = part + (static_cast<size_t>(blockIdx.x) * plan.window + blockIdx.y) * part_floats<T>();
  // the owner of db: the tile of the layer's first row block (in its
  // fault the first column tile's db left at 0)
  const bool db = jb.kbi == 0;
  const bool db_zero = plan.fault == kDbDropped && jb.col0 == 0;
  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) produce<T>(plan, L, jb, sm, p_begin, steps);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    Plan const& p = plan;
    if constexpr (sizeof(T) == 2) {
      if (jb.n == 256) consume_bf16<256>(p, sm, steps, db, db_zero, out);
      else if (jb.n == 128) consume_bf16<128>(p, sm, steps, db, db_zero, out);
      else consume_bf16<64>(p, sm, steps, db, db_zero, out);
    } else {
      if (jb.n == 128) consume_f32<128>(p, sm, steps, db, db_zero, out);
      else consume_f32<64>(p, sm, steps, db, db_zero, out);
    }
  }
}

// every job's partials (part: the window's buffer) summed over the
// window's slices in slice order into the grads, after the earlier
// windows' sum there
template <class T>
__global__ void dw_tc_reduce(const __grid_constant__ Plan plan, const float* __restrict__ part) {
  constexpr int P = part_floats<T>();
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(plan.jobs) * P) return;
  const int job = static_cast<int>(idx / P);
  const int e = static_cast<int>(idx - static_cast<size_t>(job) * P);
  const Job jb = job_of(plan, job, Shape<T>::kMaxN);
  const Layer& L = plan.l[jb.layer];
  const Seg& sg = L.seg[jb.seg];
  const int n = jb.n;
  float* dst;
  if (e >= 128 * n) {
    const int c = jb.col0 + e - 128 * n;
    if (e >= 129 * n || jb.kbi != 0 || c >= L.nwidth) return;
    dst = L.gb + c;
  } else {
    const int r = 128 * jb.kb + e / n;
    const int c = jb.col0 + e % n;
    if (r >= sg.width || c >= L.nwidth) return;
    dst = L.gw + static_cast<size_t>(sg.row_off + r) * L.nwidth + c;
  }
  const float* src = part + static_cast<size_t>(job) * plan.window * P + e;
  const int n_sl = min(plan.window, plan.splits - plan.slice0);
  float s = plan.slice0 ? *dst : 0.f;
  for (int sp = 0; sp < n_sl; ++sp) s += src[static_cast<size_t>(sp) * P];
  *dst = s;
}

// ---------------------------------------------------------------------------
// host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime (no link to libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of a row-major (m, width) stash: 64 x 64 boxes, bf16 under the
// 128-byte swizzle, f32 as they are; rows past m, columns past width zeros
template <class T>
inline bool encode_map(CUtensorMap* map, const void* ptr, int width, int m) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(width) * sizeof(T)};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  const bool f32 = sizeof(T) == 4;
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// each layer's A segments (activation slots) and its dz
constexpr int kSegs[kLayers][2] = {{0, -1}, {2, -1}, {3, -1}, {4, -1}, {5, -1}, {0, 6},
                                   {7, -1}, {8, -1}, {9, -1}, {10, 1}, {11, -1}};

// the plan of m points: jobs, slices, and with `maps` the tensor maps
// (false if one cannot be encoded)
template <class T>
inline bool make_plan(Plan& plan, const Stashes& st, int m, float* const* gw, float* const* gb, bool maps) {
  plan.m = m;
  plan.fault = fault();
  int jobs = 0;
  for (int l = 0; l < kLayers; ++l) {
    Layer& L = plan.l[l];
    L.nseg = kSegs[l][1] < 0 ? 1 : 2;
    int rows = 0, kblocks = 0;
    for (int s = 0; s < L.nseg; ++s) {
      const int a = kSegs[l][s];
      L.seg[s] = {a, st.act_width[a], rows, cdiv(st.act_width[a], 128)};
      rows += st.act_width[a];
      kblocks += L.seg[s].kblocks;
    }
    if (L.nseg == 1) L.seg[1] = {0, 0, rows, 0};
    L.zmap = kActs + l;
    L.nwidth = st.dz_width[l];
    L.ntiles = n_tiles(L.nwidth, Shape<T>::kMaxN);
    L.first_job = jobs;
    L.gw = gw[l];
    L.gb = gb[l];
    jobs += kblocks * L.ntiles;
  }
  plan.jobs = jobs;
  int splits = cdiv(m, kSlice);
  splits = std::max(splits, std::min(cdiv(2 * kSMs, jobs), cdiv(m, kMinSlice)));
  plan.chunk = cdiv(cdiv(m, splits), 64) * 64;
  plan.splits = cdiv(m, plan.chunk);
  plan.windows = cdiv(plan.splits, std::max(1, kWaves * kSMs / jobs));
  plan.window = cdiv(plan.splits, plan.windows);
  plan.slice0 = 0;
  if (!maps) return true;
  for (int a = 0; a < kActs; ++a)
    if (!encode_map<T>(&plan.maps[a], st.act[a], st.act_width[a], m)) return false;
  for (int l = 0; l < kLayers; ++l)
    if (!encode_map<T>(&plan.maps[kActs + l], st.dz[l], st.dz_width[l], m)) return false;
  return true;
}

// the floats of one buffer of partials (a window's)
template <class T>
inline size_t buffer_floats(const Plan& plan) {
  return static_cast<size_t>(plan.jobs) * plan.window * part_floats<T>();
}

template <class T>
inline size_t ws_bytes(const Stashes& st, int m) {
  static Plan plan;  // ~3.7 KB: off the stack
  float* none[kLayers] = {};
  make_plan<T>(plan, st, m > 0 ? m : 1, none, none, false);
  const size_t buffers = std::min(plan.windows, 2);
  return (buffers * buffer_floats<T>(plan) * sizeof(float) + 255) & ~size_t(255);
}

// the second stream of a device's dW launches and its events: fork (the
// caller's stream so far), reduced (the last window's reduce)
struct Side {
  cudaStream_t stream;
  cudaEvent_t fork, reduced;
};

inline cudaError_t side_stream(Side*& out) {
  static Side sides[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Side& sd = sides[dev];
  if (sd.stream == nullptr) {
    if ((err = cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming)) != cudaSuccess) return err;
    if ((err = cudaEventCreateWithFlags(&sd.reduced, cudaEventDisableTiming)) != cudaSuccess) return err;
    if ((err = cudaStreamCreateWithFlags(&sd.stream, cudaStreamNonBlocking)) != cudaSuccess) return err;
  }
  out = &sd;
  return cudaSuccess;
}

// dW and db of every layer into the kernel-layout grads gw, gb; part: the
// workspace of ws_bytes. Window w runs on `stream` (w even) or the side
// stream (w odd) into buffer w % 2: its kernel after the reduce of window
// w - 2 (same stream), its reduce after window w - 1's (event `reduced`);
// `stream` waits for the last reduce before it goes on.
template <class T>
inline cudaError_t run(const Stashes& st, int m, float* part, float* const* gw, float* const* gb,
                       cudaStream_t stream) {
  static Plan plan;
  if (m <= 0) return cudaErrorInvalidValue;
  if (!make_plan<T>(plan, st, m, gw, gb, true)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(dw_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  Side* side = nullptr;
  if (plan.windows > 1) {
    if ((err = side_stream(side)) != cudaSuccess) return err;
    if ((err = cudaEventRecord(side->fork, stream)) != cudaSuccess) return err;
    if ((err = cudaStreamWaitEvent(side->stream, side->fork, 0)) != cudaSuccess) return err;
  }
  const size_t total = static_cast<size_t>(plan.jobs) * part_floats<T>();
  for (int w = 0; w < plan.windows; ++w) {
    const cudaStream_t on = w % 2 ? side->stream : stream;
    float* buffer = part + (w % 2) * buffer_floats<T>(plan);
    plan.slice0 = w * plan.window;
    const int slices = std::min(plan.window, plan.splits - plan.slice0);
    dw_tc_kernel<T><<<dim3(plan.jobs, slices), kThreads, smem, on>>>(plan, buffer);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++launches();
    if (w > 0 && (err = cudaStreamWaitEvent(on, side->reduced, 0)) != cudaSuccess) return err;
    dw_tc_reduce<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, on>>>(plan, buffer);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (side != nullptr && (err = cudaEventRecord(side->reduced, on)) != cudaSuccess) return err;
  }
  // the last reduce waited for every earlier one, and each for its kernel
  if (side != nullptr) return cudaStreamWaitEvent(stream, side->reduced, 0);
  return cudaSuccess;
}

}  // namespace nerf_dw
