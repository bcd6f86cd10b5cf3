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
// wgmma, TMA and warp specialisation are left for later work. The encode,
// the layer product (tile_product) and the bias epilogue are nerf_mlp.cuh's,
// shared with the training kernels; this kernel is their forward without
// the stash.
//
// Layout contract with torch_nerf_tpu_torch/ops/fused_nerf.py:
//   w[l]  fragment-ordered bf16 weights of layer l: for k-tile kt, n-tile nt
//         and lane, 4 values W[16kt + 2(lane%4) + {0,1,8,9}][8nt + lane/4];
//         the rows of a concatenated input are padded per segment
//         (pe 63->64, de 27->32), columns to a multiple of 8;
//   b[l]  bf16 bias padded with zeros to the padded column count.

#include "nerf_mlp.cuh"

using namespace nerf_mlp;

namespace {

__global__ void __launch_bounds__(kThreads, 2)
    fused_nerf_fwd_kernel(PointInput in, Net net, float* __restrict__ sigma,
                          float* __restrict__ rgb, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f = net.feat;
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

  const Seg none = {nullptr, 0, 0};
  const Seg s_pe = {pe, ld_pe, net.pe_pad / 16};
  const Seg s_de = {de, ld_de, net.de_pad / 16};
  const Seg s_ha = {ha, ld_h, f / 16};
  const Seg s_hb = {hb, ld_h, f / 16};
  const bf162 zero2 = __float2bfloat162_rn(0.f);

  // relu(bf16(bf16(in W) + b)) of n8 tiles [0, ntiles) to shared memory
  auto relu_layer = [&](Seg a, Seg b, int l, int ntiles, bf16* out) {
    const bf16* bias = net.b[l];
    tile_product(a, b, net.w[l], ntiles, 0, ntiles, [&](int r, int n, float v0, float v1) {
      *reinterpret_cast<bf162*>(out + r * ld_h + n) = __hmax2(bias_add(v0, v1, bias, n), zero2);
    });
    __syncthreads();
  };

  relu_layer(s_pe, none, 0, f / 8, ha);
  relu_layer(s_ha, none, 1, f / 8, hb);
  relu_layer(s_hb, none, 2, f / 8, ha);
  relu_layer(s_ha, none, 3, f / 8, hb);
  relu_layer(s_hb, none, 4, f / 8, ha);
  relu_layer(s_pe, s_ha, 5, f / 8, hb);  // skip: fc_5 reads [pe, h4], the public order
  relu_layer(s_hb, none, 6, f / 8, ha);
  relu_layer(s_ha, none, 7, f / 8, hb);

  // fc_8: column 0 is sigma, columns 1..f land in ha[:, 0..f-1]
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
                       if (r < rows) sigma[row0 + r] = fmaxf(__bfloat162float(v[e]), 0.f);
                     } else if (c <= f) {
                       ha[r * ld_h + c - 1] = v[e];
                     }
                   }
                 });
    __syncthreads();
  }

  relu_layer(s_ha, s_de, 9, f / 16, hb);  // fc_9 reads [feat, de]

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
          rgb[static_cast<size_t>(row0 + r) * 3 + c] = 1.f / (1.f + expf(-v[e]));
        }
      }
    });
  }
}

}  // namespace

extern "C" {

size_t fused_nerf_fwd_smem_bytes(int feat, int pe_pad, int de_pad) {
  return forward_smem_bytes(feat, pe_pad, de_pad);
}

const char* fused_nerf_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
int fused_nerf_fwd(const float* pts, const float* dirs, const void* const* weights,
                   const void* const* biases, float* sigma, float* rgb, int m, int feat,
                   int pos_levels, int dir_levels, int include_input, int pe_dim,
                   int de_dim, int pe_pad, int de_pad, void* stream) {
  const Net net = make_net(weights, biases, nullptr, feat, pos_levels, dir_levels, include_input,
                           pe_dim, de_dim, pe_pad, de_pad);
  const size_t smem = forward_smem_bytes(feat, pe_pad, de_pad);
  cudaError_t err = set_smem(fused_nerf_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kTileRows - 1) / kTileRows);
  fused_nerf_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      PointInput{pts, dirs}, net, sigma, rgb, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
