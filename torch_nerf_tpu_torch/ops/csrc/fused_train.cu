// The fused NeRF train pass on Hopper: o + t d, PE, the MLP forward, the
// emission-absorption composite, the per-ray MSE cotangent, the closed-form
// composite VJP and the MLP backward, with dW and db summed over all rays.
//
// Replaces the Pallas TPU kernel torch_nerf_tpu/ops/pallas/fused_train.py::
// _train_kernel (reached through fused_train_pass's pl.pallas_call). The
// Pallas tile keeps ~45 MB of activations in VMEM; an SM has 227 KB, so the
// pass is four kinds of kernel here, all written by hand (nerf_mlp.cuh):
//
//   mlp_forward_stash   points o + t d, PE and the forward, every activation
//                       stashed in device memory;
//   composite           one warp per ray, in f32: s_i = sigma_i delta_i,
//                       T_i = exp(-sum_{j<i} s_j) by a warp prefix scan,
//                       w_i = T_i (1 - e^{-s_i}), C = sum w_i c_i, the MSE
//                       cotangent g = 2 (C - gt) / (3 N_real) (zero for rays
//                       at or past num_real), then dL/dc_i = w_i g and
//                       dL/dsigma_i = delta_i ((g.c_i) T_i e^{-s_i}
//                       - sum_{k>i} (g.c_k) w_k) by a strict warp suffix scan
//                       (fused_train.py:45-55);
//   mlp_backward_chain  the dh chain without input grads;
//   dw_gemm, dw_reduce  dW = A^T dZ and db, split along the points and
//                       summed in a fixed order.
//
// The TPU's (S, S) masked-matmul scans, its E/Msel relayouts and the bf16
// rounding of the scan summands are not carried over: the scans run in f32.
// The delta sentinel (1e8) makes s_i huge on the last sample: exp(-s) is 0
// there and never multiplies an infinity. Bound on an H100 SXM: 3 x
// 1,186,816 FLOP per point at 989 TFLOP/s dense bf16, 2.83 ms for the fine
// pass (786,432 points), 0.94 ms for the coarse (262,144); the composite's
// ~20 bytes per point are noise beside the stashes, which make this first
// design memory-bound.

#include "nerf_mlp.cuh"

using namespace nerf_mlp;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCompositeWarps = 8;

__global__ void __launch_bounds__(32 * kCompositeWarps)
    composite(const float* __restrict__ sigma, const float* __restrict__ rgb,
              const float* __restrict__ delta, const float* __restrict__ gt, int n_rays,
              int samples, int num_real, float* __restrict__ rgb_out,
              float* __restrict__ weights, float* __restrict__ trans,
              float* __restrict__ g_sigma, float* __restrict__ g_rgb) {
  const int ray = blockIdx.x * kCompositeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (ray >= n_rays) return;  // warp-uniform
  const size_t base = static_cast<size_t>(ray) * samples;

  // forward: exclusive prefix sum of s, T, w, and C
  float carry = 0.f;
  float c[3] = {0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < samples; s0 += 32) {
    const int i = s0 + lane;
    const bool valid = i < samples;
    const float s = valid ? sigma[base + i] * delta[base + i] : 0.f;
    float incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    excl += carry;
    carry += __shfl_sync(kFull, incl, 31);
    if (valid) {
      const float t = expf(-excl);
      const float w = t * (1.f - expf(-s));
      weights[base + i] = w;
      trans[base + i] = t;
#pragma unroll
      for (int k = 0; k < 3; ++k) c[k] += w * rgb[(base + i) * 3 + k];
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c[k] += __shfl_xor_sync(kFull, c[k], o);

  const float lossw = ray < num_real ? 2.f / (3.f * static_cast<float>(num_real)) : 0.f;
  float g[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g[k] = (c[k] - gt[static_cast<size_t>(ray) * 3 + k]) * lossw;
    if (lane == 0) rgb_out[static_cast<size_t>(ray) * 3 + k] = c[k];
  }

  // backward: strict suffix sum of (g.c_k) w_k, from the last chunk down
  float sfx_carry = 0.f;
  for (int s0 = ((samples - 1) / 32) * 32; s0 >= 0; s0 -= 32) {
    const int i = s0 + lane;
    const bool valid = i < samples;
    float w = 0.f, t = 0.f, att = 0.f, dl = 0.f, gw = 0.f;
    if (valid) {
      w = weights[base + i];
      t = trans[base + i];
      dl = delta[base + i];
      att = expf(-(sigma[base + i] * dl));
#pragma unroll
      for (int k = 0; k < 3; ++k) gw += rgb[(base + i) * 3 + k] * g[k];
    }
    const float x = gw * w;
    float incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(kFull, incl, o);
      if (lane + o < 32) incl += u;
    }
    float excl = __shfl_down_sync(kFull, incl, 1);
    if (lane == 31) excl = 0.f;
    const float sfx = excl + sfx_carry;
    sfx_carry += __shfl_sync(kFull, incl, 0);
    if (valid) {
      g_sigma[base + i] = dl * (gw * t * att - sfx);
#pragma unroll
      for (int k = 0; k < 3; ++k) g_rgb[(base + i) * 3 + k] = w * g[k];
    }
  }
}

// per-point cotangents and the transmittance after the stash
size_t composite_bytes(int m) {
  return align256(static_cast<size_t>(m) * sizeof(float)) * 2 +
         align256(static_cast<size_t>(m) * 3 * sizeof(float));
}

}  // namespace

extern "C" {

size_t fused_train_workspace_bytes(int m, int feat, int pe_pad, int de_pad) {
  Net net = {};
  net.feat = feat;
  net.pe_pad = pe_pad;
  net.de_pad = de_pad;
  return stash_bytes(m, feat, pe_pad, de_pad) + composite_bytes(m) + gemm_ws_bytes(net, m);
}

size_t fused_train_smem_bytes(int feat, int pe_pad, int de_pad) {
  const size_t a = forward_smem_bytes(feat, pe_pad, de_pad);
  const size_t b = chain_smem_bytes(feat, pe_pad, de_pad, false);
  return a > b ? a : b;
}

const char* fused_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream`; returns the cudaError_t of the launches (0 on success).
int fused_train_pass(const float* ray_o, const float* ray_d, const float* t, const float* delta,
                     const float* rgb_gt, int n_rays, int samples, int num_real,
                     const void* const* weights, const void* const* biases,
                     const void* const* weights_t, void* workspace, float* rgb_out,
                     float* weights_out, float* const* grads_w, float* const* grads_b, int feat,
                     int pos_levels, int dir_levels, int include_input, int pe_dim, int de_dim,
                     int pe_pad, int de_pad, void* stream) {
  const Net net = make_net(weights, biases, weights_t, feat, pos_levels, dir_levels, include_input,
                           pe_dim, de_dim, pe_pad, de_pad);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = n_rays * samples;
  unsigned char* base = static_cast<unsigned char*>(workspace);
  size_t used = 0;
  const Stash st = carve_stash(base, m, feat, pe_pad, de_pad, &used);
  float* g_sigma = reinterpret_cast<float*>(base + used);
  used += align256(static_cast<size_t>(m) * sizeof(float));
  float* trans = reinterpret_cast<float*>(base + used);
  used += align256(static_cast<size_t>(m) * sizeof(float));
  float* g_rgb = reinterpret_cast<float*>(base + used);
  used += align256(static_cast<size_t>(m) * 3 * sizeof(float));
  float* ws = reinterpret_cast<float*>(base + used);
  const RayInput in = {ray_o, ray_d, t, samples};

  cudaError_t err = run_forward(in, net, st, m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite<<<(n_rays + kCompositeWarps - 1) / kCompositeWarps, 32 * kCompositeWarps, 0, s>>>(
      st.sigma, st.rgb, delta, rgb_gt, n_rays, samples, num_real, rgb_out, weights_out, trans,
      g_sigma, g_rgb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run_chain<false>(in, net, st, g_sigma, g_rgb, nullptr, nullptr, m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run_gemms(net, st, m, ws, grads_w, grads_b, s));
}

}  // extern "C"
