// The emission-absorption composite of the fused train pass and its VJP,
// one warp per ray in f32 (fused_train.cu's header note gives the math),
// shared by the pass's routes: fused_train.cu (wgmma) and fused_tc_train.cu
// (the tensor-core general route).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "nerf_mlp_train.cuh"

namespace nerf_composite {

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
inline size_t composite_bytes(int m) {
  return nerf_train::align256(static_cast<size_t>(m) * sizeof(float)) * 2 +
         nerf_train::align256(static_cast<size_t>(m) * 3 * sizeof(float));
}


}  // namespace nerf_composite
