// Fused NeRF field forward on Hopper: positional encoding + the 11-layer MLP
// in one kernel, activations kept in shared memory.
//
// Replaces the Pallas TPU kernel torch_nerf_tpu/ops/pallas/fused_nerf.py::
// _fwd_kernel (reached through _fused_forward's pl.pallas_call); the math is
// its _forward_tile: PE(pts) 63-d, PE(dirs) 27-d, trunk fc_in..fc_4, skip
// concat [pe, h4] into fc_5, fc_6, fc_7, fc_8 -> sigma = relu(col 0),
// [fc_8 cols 1:, de] -> fc_9 -> relu -> fc_out -> sigmoid.
//
// Precision: bf16 operands, f32 accumulation; every layer output is rounded to
// bf16, the bias added and rounded again, as nerf_apply(compute_dtype=bf16)
// does (torch_nerf_tpu/models/nerf.py:84-125). Encoding uses exact sincosf in
// f32 (arguments reach 2^9 * |p|, thousands of radians, so no fast-math).
//
// Bound on an H100 SXM: 1,186,816 FLOP per point at width 256 (593,408 MACs),
// against 40 bytes of input and output per point and 1.2 MB of weights: the
// kernel is bound by tensor-core operations (0.94 ms per 786,432-point fine
// chunk at 989 TFLOP/s). The design keeps every activation on chip so no
// hidden layer touches device memory:
//   * one block of 8 warps per tile of 64 points; the encoded inputs and a
//     ping-pong pair of activation buffers live in dynamic shared memory
//     (80 KB at width 256, so two blocks share an SM and one block's encode
//     and epilogues overlap the other's products), rows padded by 16 bytes
//     so ldmatrix is free of bank conflicts;
//   * products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//     accumulate); each warp owns all 64 rows x 32 columns per pass, so
//     each weight fragment is read by one warp of the block, and the B
//     fragments are loaded two k-steps ahead of their products;
//   * weights stay in device memory (L2-resident), pre-arranged by the
//     wrapper into mma fragment order so a warp reads one B fragment with one
//     coalesced 256-byte load;
//   * the ragged tail is encoded as zeros and masked at the stores.
// wgmma, TMA and warp specialisation are left for later work.
//
// Layout contract with torch_nerf_tpu_torch/ops/fused_nerf.py:
//   w[l]  fragment-ordered bf16 weights of layer l: for k-tile kt, n-tile nt
//         and lane, 4 values W[16kt + 2(lane%4) + {0,1,8,9}][8nt + lane/4];
//         the rows of a concatenated input are padded per segment
//         (pe 63->64, de 27->32), columns to a multiple of 8;
//   b[l]  bf16 bias padded with zeros to the padded column count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 64;  // points per block
constexpr int kWarpsM = 1;
constexpr int kWarpsN = 8;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMTiles = kTileRows / (16 * kWarpsM);  // m16 tiles per warp
constexpr int kNTiles = 4;                           // n8 tiles per warp per pass
constexpr int kRowPad = 8;                           // bf16 elements
constexpr int kLayers = 11;

struct Net {
  const uint2* w[kLayers];
  const __nv_bfloat16* b[kLayers];
  int feat;
  int pos_levels, dir_levels, include_input;
  int pe_dim, de_dim, pe_pad, de_pad;
};

struct Seg {
  const __nv_bfloat16* buf;
  int ld;
  int ktiles;
};

enum Epilogue { kReluToSmem = 0, kFc8 = 1, kRgb = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// addr: 32-bit shared-memory address of this lane's 16-byte row
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// not volatile: a pure register operation the compiler may schedule freely
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// [x, sin(2^0 x), cos(2^0 x), ...] per coordinate, as encoders.positional_encoding;
// rows past M encode zeros and the padding columns are zeroed.
__device__ void encode(const float* __restrict__ x, int row0, int m, int levels,
                       int include_input, int dim, int dim_pad, __nv_bfloat16* out,
                       int ld) {
  const int base = include_input ? 3 : 0;
  for (int i = threadIdx.x; i < kTileRows * 3; i += kThreads) {
    const int r = i / 3;
    const int c = i - 3 * r;
    const int gr = row0 + r;
    const float v = gr < m ? x[static_cast<size_t>(gr) * 3 + c] : 0.f;
    __nv_bfloat16* o = out + r * ld;
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

// out = epilogue(bf16(bf16(in @ W) + b)) for one tile of points. The input is
// the concatenation of up to two shared-memory segments along K.
template <int kEpi>
__device__ void layer(Seg s0, Seg s1, const uint2* __restrict__ wf,
                      const __nv_bfloat16* __restrict__ bias, int ntiles,
                      __nv_bfloat16* out, int ldo, int feat, int row0, int m,
                      float* __restrict__ sigma, float* __restrict__ rgb) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN;
  const int wn = warp - wm * kWarpsN;
  const int mbase = wm * kMTiles * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ktiles = s0.ktiles + s1.ktiles;
  const int per_pass = kWarpsN * kNTiles;
  // this lane's ldmatrix row in each segment at k = 0 (shared-memory bytes),
  // and the bytes between m16 tiles; a k-step adds 16 bf16 = 32 bytes
  const int lrow = mbase + (lane & 15);
  const int lcol = (lane >> 4) * 8;
  const uint32_t a0 = smem_addr(s0.buf + lrow * s0.ld + lcol);
  const uint32_t a1 = s1.ktiles ? smem_addr(s1.buf + lrow * s1.ld + lcol) : 0u;
  const uint32_t mstep0 = 16u * s0.ld * sizeof(__nv_bfloat16);
  const uint32_t mstep1 = 16u * s1.ld * sizeof(__nv_bfloat16);
  const int kstride = ntiles * 32;  // uint2 elements between k-steps of B

  for (int pass = 0; pass * per_pass < ntiles; ++pass) {
    const int nt0 = (pass * kWarpsN + wn) * kNTiles;
    if (nt0 >= ntiles) continue;  // warp-uniform

    float acc[kMTiles][kNTiles][4];
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    // n-tiles of this warp inside the layer's width (warp-uniform)
    const int jn = min(kNTiles, ntiles - nt0);
    const uint2* __restrict__ wlane = wf + nt0 * 32 + lane;
    // B fragments of k-step kt, read from global (L2) memory
    auto load_b = [&](uint2 (&b)[kNTiles], int kt) {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        b[j] = j < jn ? __ldg(wlane + kt * kstride + j * 32) : make_uint2(0u, 0u);
      }
    };
    // the products of k-step kt, four m-tiles at a time: their A fragments
    // first, then the products
    auto step = [&](const uint2 (&b)[kNTiles], int kt) {
      const bool first = kt < s0.ktiles;
      const uint32_t abase = first ? a0 + 32u * kt : a1 + 32u * (kt - s0.ktiles);
      const uint32_t mstep = first ? mstep0 : mstep1;
#pragma unroll
      for (int i0 = 0; i0 < kMTiles; i0 += 4) {
        uint32_t a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ldmatrix_x4(a[i], abase + (i0 + i) * mstep);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kNTiles; ++j)
            if (j < jn) mma_bf16(acc[i0 + i][j], a[i], b[j]);
      }
    };

    // B loads run two k-steps ahead of their products (a register ring;
    // the loop is unrolled by two so the ring needs no register moves)
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

    // accumulator (i, j, h, e): row 16i + g + 8h, column 8nt + 2t + e
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const int nt = nt0 + j;
      if (nt >= ntiles) continue;
      const int n = 8 * nt + 2 * t;
      const __nv_bfloat162 b2v = *reinterpret_cast<const __nv_bfloat162*>(bias + n);
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mbase + 16 * i + g + 8 * h;
          // bf16(bf16(acc) + b) for the column pair: a bf16x2 add rounds
          // the exact sum once, as rounding its f32 sum does
          const __nv_bfloat162 y =
              __hadd2(__floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]), b2v);
          if (kEpi == kReluToSmem) {
            *reinterpret_cast<__nv_bfloat162*>(out + r * ldo + n) =
                __hmax2(y, __float2bfloat162_rn(0.f));
            continue;
          }
          const float v[2] = {__low2float(y), __high2float(y)};
          if (kEpi == kFc8) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = n + e;
              if (c == 0) {
                if (row0 + r < m) sigma[row0 + r] = fmaxf(v[e], 0.f);
              } else if (c <= feat) {
                out[r * ldo + c - 1] = __float2bfloat16_rn(v[e]);
              }
            }
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = n + e;
              if (c < 3 && row0 + r < m) {
                rgb[static_cast<size_t>(row0 + r) * 3 + c] = 1.f / (1.f + expf(-v[e]));
              }
            }
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    fused_nerf_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                          Net net, float* __restrict__ sigma, float* __restrict__ rgb,
                          int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f = net.feat;
  const int ld_pe = net.pe_pad + kRowPad;
  const int ld_de = net.de_pad + kRowPad;
  const int ld_h = f + kRowPad;
  __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* de = pe + kTileRows * ld_pe;
  __nv_bfloat16* ha = de + kTileRows * ld_de;
  __nv_bfloat16* hb = ha + kTileRows * ld_h;
  const int row0 = blockIdx.x * kTileRows;

  encode(pts, row0, m, net.pos_levels, net.include_input, net.pe_dim, net.pe_pad, pe, ld_pe);
  encode(dirs, row0, m, net.dir_levels, net.include_input, net.de_dim, net.de_pad, de, ld_de);
  __syncthreads();

  const Seg none = {nullptr, 0, 0};
  const Seg s_pe = {pe, ld_pe, net.pe_pad / 16};
  const Seg s_de = {de, ld_de, net.de_pad / 16};
  const Seg s_ha = {ha, ld_h, f / 16};
  const Seg s_hb = {hb, ld_h, f / 16};
  const int nf = f / 8;

  layer<kReluToSmem>(s_pe, none, net.w[0], net.b[0], nf, ha, ld_h, f, row0, m, sigma, rgb);
  __syncthreads();
  layer<kReluToSmem>(s_ha, none, net.w[1], net.b[1], nf, hb, ld_h, f, row0, m, sigma, rgb);
  __syncthreads();
  layer<kReluToSmem>(s_hb, none, net.w[2], net.b[2], nf, ha, ld_h, f, row0, m, sigma, rgb);
  __syncthreads();
  layer<kReluToSmem>(s_ha, none, net.w[3], net.b[3], nf, hb, ld_h, f, row0, m, sigma, rgb);
  __syncthreads();
  layer<kReluToSmem>(s_hb, none, net.w[4], net.b[4], nf, ha, ld_h, f, row0, m, sigma, rgb);
  __syncthreads();
  // skip: fc_5 reads [pe, h4], the public order
  layer<kReluToSmem>(s_pe, s_ha, net.w[5], net.b[5], nf, hb, ld_h, f, row0, m, sigma, rgb);
  __syncthreads();
  layer<kReluToSmem>(s_hb, none, net.w[6], net.b[6], nf, ha, ld_h, f, row0, m, sigma, rgb);
  __syncthreads();
  layer<kReluToSmem>(s_ha, none, net.w[7], net.b[7], nf, hb, ld_h, f, row0, m, sigma, rgb);
  __syncthreads();
  // fc_8: column 0 is sigma, columns 1..f land in ha[:, 0..f-1]
  layer<kFc8>(s_hb, none, net.w[8], net.b[8], nf + 1, ha, ld_h, f, row0, m, sigma, rgb);
  __syncthreads();
  // fc_9 reads [feat, de]
  layer<kReluToSmem>(s_ha, s_de, net.w[9], net.b[9], f / 16, hb, ld_h, f, row0, m, sigma, rgb);
  __syncthreads();
  const Seg s_h9 = {hb, ld_h, f / 32};
  layer<kRgb>(s_h9, none, net.w[10], net.b[10], 1, nullptr, 0, f, row0, m, sigma, rgb);
}

size_t smem_bytes(int feat, int pe_pad, int de_pad) {
  return static_cast<size_t>(kTileRows) *
         ((pe_pad + kRowPad) + (de_pad + kRowPad) + 2 * (feat + kRowPad)) *
         sizeof(__nv_bfloat16);
}

}  // namespace

extern "C" {

size_t fused_nerf_fwd_smem_bytes(int feat, int pe_pad, int de_pad) {
  return smem_bytes(feat, pe_pad, de_pad);
}

const char* fused_nerf_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
int fused_nerf_fwd(const float* pts, const float* dirs, const void* const* weights,
                   const void* const* biases, float* sigma, float* rgb, int m, int feat,
                   int pos_levels, int dir_levels, int include_input, int pe_dim,
                   int de_dim, int pe_pad, int de_pad, void* stream) {
  Net net;
  for (int l = 0; l < kLayers; ++l) {
    net.w[l] = static_cast<const uint2*>(weights[l]);
    net.b[l] = static_cast<const __nv_bfloat16*>(biases[l]);
  }
  net.feat = feat;
  net.pos_levels = pos_levels;
  net.dir_levels = dir_levels;
  net.include_input = include_input;
  net.pe_dim = pe_dim;
  net.de_dim = de_dim;
  net.pe_pad = pe_pad;
  net.de_pad = de_pad;

  const size_t smem = smem_bytes(feat, pe_pad, de_pad);
  cudaError_t err = cudaFuncSetAttribute(
      fused_nerf_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fused_nerf_fwd_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kTileRows - 1) / kTileRows);
  fused_nerf_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pts, dirs, net, sigma, rgb, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
