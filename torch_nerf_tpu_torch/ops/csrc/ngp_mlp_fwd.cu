// The Instant-NGP field's forward after the hash encode, on Hopper: the SH
// encode of the view direction, the density MLP (fc_in, one relu hidden
// layer, fc_out), 2^x, the colour MLP (fc_in over [density out, SH], two
// relu hidden layers, fc_out) and the sigmoid (exp when HDR) in one kernel,
// every activation kept in registers.
//
// Replaces no TPU kernel: the JAX package leaves these MLPs to XLA
// (torch_nerf_tpu/models/instant_ngp.py::small_mlp_apply), and the port ran
// them as cuBLAS GEMMs with PyTorch's elementwise kernels and concatenations
// around them (models/instant_ngp.py::instant_ngp_apply on the public tree):
// ~90 launches a render chunk, every 64-wide activation through device
// memory several times, ~4 KB a point. That glue took ~550 of ~660 ms of an
// 800x800 frame on an H100; this kernel was added for the frame loop
// (field.prepare), as the paper's own "fully fused MLP" (arXiv:2201.05989,
// section 4). Training keeps the autograd route.
//
// Bound on an H100 SXM at the render cell's shape (4096 rays x 256 samples,
// 1,048,576 points a chunk, 32 f32 features a point): 128 bytes of features
// read and 16 of sigma and rgb written a point, 151 MB a chunk, 45 us at
// 3.35 TB/s; 17,600 multiply-adds a point, 36.9 GFLOP a chunk, 37 us at 989
// TFLOP/s dense bf16. So ~45 us a chunk, ~7.1 ms a frame, bound by bytes
// near the card's ridge (~244 FLOP a byte). What the design does about it:
// the features are read once, straight from device memory into the
// registers that feed the first product, the next tile's loads in flight
// while the current tile computes; nothing else is read but the rays'
// directions (12 bytes a ray, from L2), and nothing written but the outputs.
// The weights and biases (44,720 bytes of bf16 images) are copied into
// shared memory once a CTA by one bulk copy; the CTAs are persistent, two
// warpgroups each and two CTAs an SM, so that one warpgroup's epilogue runs
// while another's products do.
//
// Design: each warpgroup walks 64-point tiles. Every layer is wgmma
// m64nNk16 with A (the activations) from registers and B (W^T, K-major, in
// 128-byte swizzled panels) from shared memory: N = 64 for the hidden
// widths, 16 for the density output, 8 for the colour output (3 columns
// kept). A layer's f32 sums are rounded to bf16, the bf16 bias added and
// rounded again, relu applied where the layer has one, and the result is
// the next layer's A fragment in registers as it stands: the accumulator's
// column pair (2t, 2t + 1) of rows g and g + 8 of each n8 group is the A
// fragment's register for those columns (as FlashAttention-3 reuses P). The
// colour MLP's fc_in takes its first k16 step from the density output's 16
// columns and its second from the 16 SH terms: no [density out, SH] copy.
// SH is computed for each point from its ray's direction (ray = point /
// samples).
//
// Precision, the roundings of instant_ngp_apply at compute_dtype bf16: the
// features rounded to bf16; every product accumulated in f32 and rounded to
// bf16, then the bf16 bias added and rounded again, bf16(bf16(acc) + b);
// relu keeps NaN; the SH terms in f32 in encoders.sh_encoding's order
// (__fmul_rn / __fsub_rn, so nothing is contracted into an FMA), rounded to
// bf16; sigma = exp2f of the first density output; rgb the f32 sigmoid of
// the bf16 colour output (expf when HDR). Only the order of the f32 sums
// differs from cuBLAS's.
//
// Layout contract with torch_nerf_tpu_torch/ops/ngp_mlp.py::weight_image:
// the layers' W^T (rows the outputs, 64 bf16 columns the inputs, zero past
// K) as 128-byte swizzled panels (nerf_mlp_train.cuh's swizzle128), in the
// order density fc_in (64 rows), fc_hidden_0 (64), fc_out (16), colour
// fc_in (64; columns [density out, SH]), fc_hidden_0 (64), fc_hidden_1
// (64), fc_out (8; rows past 3 zero), then the biases in the same order
// (64, 64, 16, 64, 64, 64, 8; fc_out's past 3 zero).

#include "nerf_mlp_train.cuh"
#include "wgmma_ops.cuh"

namespace {

namespace nt = nerf_train;
using nt::bf16;
using nt::bf162;

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTile = 64;       // points a warpgroup's tile
constexpr int kHidden = 64;
constexpr int kDensityOut = 16;
constexpr int kColorOut = 8;    // 3 used

// byte offsets of the image's panels, each 1024-aligned
constexpr int kPanel = kHidden * 128;
constexpr int kDIn = 0;
constexpr int kDHid = kDIn + kPanel;
constexpr int kDOut = kDHid + kPanel;
constexpr int kCIn = kDOut + kDensityOut * 128;
constexpr int kCHid0 = kCIn + kPanel;
constexpr int kCHid1 = kCHid0 + kPanel;
constexpr int kCOut = kCHid1 + kPanel;
constexpr int kBias = kCOut + kColorOut * 128;
// element offsets of the biases
constexpr int kBDIn = 0;
constexpr int kBDHid = kBDIn + kHidden;
constexpr int kBDOut = kBDHid + kHidden;
constexpr int kBCIn = kBDOut + kDensityOut;
constexpr int kBCHid0 = kBCIn + kHidden;
constexpr int kBCHid1 = kBCHid0 + kHidden;
constexpr int kBCOut = kBCHid1 + kHidden;
constexpr int kBiases = kBCOut + kColorOut;
constexpr int kImageBytes = kBias + 2 * kBiases;
static_assert(kImageBytes % 16 == 0, "a bulk copy moves multiples of 16 bytes");
constexpr int kBarOffset = (kImageBytes + 7) / 8 * 8;
constexpr size_t kSmemBytes = 1024 + kBarOffset + 8;  // the alignment slack, the image, its barrier

// acc (64 x N) = A (64 x 16 KS, registers) B (shared memory at b, K-major)
template <int N, int KS>
__device__ __forceinline__ void layer(float (&acc)[N / 2], const uint32_t (&a)[KS][4], uint32_t b) {
  nt::wg_fence();
#pragma unroll
  for (int k = 0; k < KS; ++k) nerf_tc::mma_bf16_rs<N>(acc, a[k], nt::sw128_desc(b + 32 * k, 16, 1024), k > 0);
  nt::wg_commit();
  nt::wg_wait<0>();
  nt::fence_acc(acc);
}

// bf16(bf16(acc) + b), relu'd with kRelu, as the next layer's A fragment:
// the pair at accumulator i = 8s + 2j is register j of k16 step s
template <int N, bool kRelu>
__device__ __forceinline__ void to_a(const float (&acc)[N / 2], const bf16* __restrict__ bias, int q,
                                     uint32_t (&a)[N / 16][4]) {
  const bf162 zero2 = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    bf162 y = nt::bias_add(acc[i], acc[i + 1], bias, 8 * (i >> 2) + 2 * q);
    if constexpr (kRelu) y = __hmax2_nan(y, zero2);
    a[i >> 3][(i >> 1) & 3] = nt::bits_of(y);
  }
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) { return nt::bits_of(__floats2bfloat162_rn(lo, hi)); }

__device__ __forceinline__ float low_bf16(uint32_t v) { return __uint_as_float(v << 16); }

// the 16 real SH terms of degree 4 at (x, y, z), encoders.sh_encoding's
// order and arithmetic in f32
__device__ __forceinline__ void sh16(float x, float y, float z, float (&s)[16]) {
  const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y), zz = __fmul_rn(z, z);
  const float xy = __fmul_rn(x, y), yz = __fmul_rn(y, z), xz = __fmul_rn(x, z);
  s[0] = static_cast<float>(0.28209479177387814);
  s[1] = __fmul_rn(static_cast<float>(-0.4886025119029199), y);
  s[2] = __fmul_rn(static_cast<float>(0.4886025119029199), z);
  s[3] = __fmul_rn(static_cast<float>(-0.4886025119029199), x);
  s[4] = __fmul_rn(static_cast<float>(1.0925484305920792), xy);
  s[5] = __fmul_rn(static_cast<float>(-1.0925484305920792), yz);
  s[6] = __fmul_rn(static_cast<float>(0.31539156525252005), __fsub_rn(__fsub_rn(__fmul_rn(2.f, zz), xx), yy));
  s[7] = __fmul_rn(static_cast<float>(-1.0925484305920792), xz);
  s[8] = __fmul_rn(static_cast<float>(0.5462742152960396), __fsub_rn(xx, yy));
  const float zz4_xx_yy = __fsub_rn(__fsub_rn(__fmul_rn(4.f, zz), xx), yy);
  s[9] = __fmul_rn(__fmul_rn(static_cast<float>(-0.5900435899266435), y), __fsub_rn(__fmul_rn(3.f, xx), yy));
  s[10] = __fmul_rn(__fmul_rn(static_cast<float>(2.890611442640554), xy), z);
  s[11] = __fmul_rn(__fmul_rn(static_cast<float>(-0.4570457994644658), y), zz4_xx_yy);
  s[12] = __fmul_rn(__fmul_rn(static_cast<float>(0.3731763325901154), z),
                    __fsub_rn(__fsub_rn(__fmul_rn(2.f, zz), __fmul_rn(3.f, xx)), __fmul_rn(3.f, yy)));
  s[13] = __fmul_rn(__fmul_rn(static_cast<float>(-0.4570457994644658), x), zz4_xx_yy);
  s[14] = __fmul_rn(__fmul_rn(static_cast<float>(1.445305721320277), z), __fsub_rn(xx, yy));
  s[15] = __fmul_rn(__fmul_rn(static_cast<float>(-0.5900435899266435), x), __fsub_rn(xx, __fmul_rn(3.f, yy)));
}

// s[base + 2q] without indexing registers at run time
__device__ __forceinline__ float pick(const float (&s)[16], int base, int q) {
  float v = s[base];
  v = q == 1 ? s[base + 2] : v;
  v = q == 2 ? s[base + 4] : v;
  v = q == 3 ? s[base + 6] : v;
  return v;
}

// the SH terms of rows (r0, r1) as a k16 A fragment: registers {(r0, 2q),
// (r1, 2q), (r0, 2q + 8), (r1, 2q + 8)}, each with its right neighbour
__device__ __forceinline__ void sh_fragment(const float* __restrict__ dirs, int row0, int row1, int n,
                                            int samples, int q, uint32_t (&a)[4]) {
  float s[2][16];
  const int rows[2] = {row0, row1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float d[3] = {0.f, 0.f, 0.f};
    if (rows[r] < n) {
      const size_t ray = static_cast<size_t>(rows[r] / samples);
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = __ldg(dirs + ray * 3 + c);
    }
    sh16(d[0], d[1], d[2], s[r]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    a[r] = pack(pick(s[r], 0, q), pick(s[r], 1, q));
    a[2 + r] = pack(pick(s[r], 8, q), pick(s[r], 9, q));
  }
}

// the features of rows (r0, r1) as KS k16 A fragments, f32 (0 past n)
template <int IN>
__device__ __forceinline__ void load_features(const float* __restrict__ feats, int row0, int row1, int n, int q,
                                              float2 (&f)[IN / 16][4]) {
  const int rows[2] = {row0, row1};
#pragma unroll
  for (int s = 0; s < IN / 16; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        f[s][2 * h + r] = rows[r] < n ? __ldcs(reinterpret_cast<const float2*>(
                                            feats + static_cast<size_t>(rows[r]) * IN + 16 * s + 8 * h + 2 * q))
                                      : make_float2(0.f, 0.f);
}

template <int IN>
__global__ void __launch_bounds__(kThreads, 2)
    ngp_mlp_fwd_kernel(const float* __restrict__ feats, const float* __restrict__ dirs,
                       const unsigned char* __restrict__ image, float* __restrict__ sigma,
                       float* __restrict__ rgb, int n, int samples, int is_hdr) {
  constexpr int KS = IN / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* w = nt::align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(w + kBarOffset);
  if (threadIdx.x == 0) {
    nt::mbar_init(bar, 1);
    nt::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    nt::mbar_expect_tx(bar, kImageBytes);
    nt::bulk_load(w, image, kImageBytes, bar);
  }

  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int q = t & 3;
  const int r0 = 16 * (t >> 5) + ((t & 31) >> 2);  // rows r0 and r0 + 8 of the tile
  const uint32_t wb = nt::smem_u32(w);
  const bf16* bias = reinterpret_cast<const bf16*>(w + kBias);
  const int tiles = (n + kTile - 1) / kTile;
  const int stride = gridDim.x * kWarpgroups;
  int tile = blockIdx.x * kWarpgroups + wg;

  float2 f[KS][4];
  if (tile < tiles) load_features<IN>(feats, tile * kTile + r0, tile * kTile + r0 + 8, n, q, f);
  nt::mbar_wait(bar, 0);

  for (; tile < tiles; tile += stride) {
    const int row0 = tile * kTile + r0, row1 = row0 + 8;
    uint32_t a_in[KS][4];
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) a_in[s][j] = pack(f[s][j].x, f[s][j].y);
    uint32_t a_c[2][4];  // the colour fc_in's A: [density out, SH]
    sh_fragment(dirs, row0, row1, n, samples, q, a_c[1]);
    const int next = tile + stride;
    if (next < tiles) load_features<IN>(feats, next * kTile + r0, next * kTile + r0 + 8, n, q, f);

    float acc[kHidden / 2];
    uint32_t h[4][4];
    layer<kHidden, KS>(acc, a_in, wb + kDIn);
    to_a<kHidden, false>(acc, bias + kBDIn, q, h);
    layer<kHidden, 4>(acc, h, wb + kDHid);
    to_a<kHidden, true>(acc, bias + kBDHid, q, h);
    {
      float acc16[kDensityOut / 2];
      uint32_t d[1][4];
      layer<kDensityOut, 4>(acc16, h, wb + kDOut);
      to_a<kDensityOut, false>(acc16, bias + kBDOut, q, d);
#pragma unroll
      for (int j = 0; j < 4; ++j) a_c[0][j] = d[0][j];
      // density output column 0 (lanes q == 0): registers 0 and 1, low halves
      if (q == 0) {
        if (row0 < n) sigma[row0] = exp2f(low_bf16(d[0][0]));
        if (row1 < n) sigma[row1] = exp2f(low_bf16(d[0][1]));
      }
    }
    layer<kHidden, 2>(acc, a_c, wb + kCIn);
    to_a<kHidden, false>(acc, bias + kBCIn, q, h);
    layer<kHidden, 4>(acc, h, wb + kCHid0);
    to_a<kHidden, true>(acc, bias + kBCHid0, q, h);
    layer<kHidden, 4>(acc, h, wb + kCHid1);
    to_a<kHidden, true>(acc, bias + kBCHid1, q, h);
    {
      float acc8[kColorOut / 2];
      layer<kColorOut, 4>(acc8, h, wb + kCOut);
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int row = i == 0 ? row0 : row1;
        const bf162 y = nt::bias_add(acc8[i], acc8[i + 1], bias + kBCOut, 2 * q);
        const float v[2] = {__low2float(y), __high2float(y)};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * q + e;
          if (c < 3 && row < n)
            rgb[static_cast<size_t>(row) * 3 + c] = is_hdr ? expf(v[e]) : 1.f / (1.f + expf(-v[e]));
        }
      }
    }
  }
}

// CTAs an SM and SMs of the current device, asked once a device
struct Fill {
  int sms = 0, per_sm = 0;
};

template <int IN>
cudaError_t launch(const float* feats, const float* dirs, const unsigned char* image, float* sigma, float* rgb,
                   int n, int samples, int is_hdr, cudaStream_t stream) {
  static Fill fill[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Fill& f = fill[dev];
  if (f.per_sm == 0) {
    err = cudaFuncSetAttribute(ngp_mlp_fwd_kernel<IN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ngp_mlp_fwd_kernel<IN>, kThreads, kSmemBytes);
    if (err != cudaSuccess) return err;
    f.per_sm = per_sm > 0 ? per_sm : 1;
  }
  const int tiles = (n + kTile - 1) / kTile;
  const int want = (tiles + kWarpgroups - 1) / kWarpgroups;
  const int grid = want < f.sms * f.per_sm ? want : f.sms * f.per_sm;
  ngp_mlp_fwd_kernel<IN><<<grid, kThreads, kSmemBytes, stream>>>(feats, dirs, image, sigma, rgb, n, samples,
                                                                  is_hdr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// the image's bytes, for the wrapper to check its layout against
int ngp_mlp_fwd_image_bytes(void) { return kImageBytes; }

const char* ngp_mlp_fwd_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// sigma (n,), rgb (n, 3) of feats (n, in_dim) f32, in_dim 32 or 64, and
// dirs (n / samples, 3) f32, point i on ray i / samples; image: the layout
// above, 16-byte aligned. Launches on `stream`; returns the launch's
// cudaError_t (0 on success).
int ngp_mlp_fwd(const float* feats, const float* dirs, const void* image, float* sigma, float* rgb, int n,
                int in_dim, int samples, int is_hdr, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* img = static_cast<const unsigned char*>(image);
  if (n <= 0 || samples <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (in_dim) {
    case 32: return static_cast<int>(launch<32>(feats, dirs, img, sigma, rgb, n, samples, is_hdr, s));
    case 64: return static_cast<int>(launch<64>(feats, dirs, img, sigma, rgb, n, samples, is_hdr, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
