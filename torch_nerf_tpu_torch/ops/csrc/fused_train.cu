// The fused NeRF train pass on Hopper: o + t d, PE, the MLP forward, the
// emission-absorption composite, the per-ray MSE cotangent, the closed-form
// composite VJP and the MLP backward, with dW and db summed over all rays.
//
// Replaces the Pallas TPU kernel torch_nerf_tpu/ops/pallas/fused_train.py::
// _train_kernel (reached through fused_train_pass's pl.pallas_call). The
// Pallas tile keeps ~45 MB of activations in VMEM; an SM has 227 KB, so the
// pass is five kernels here, all written by hand (nerf_mlp_train.cuh, on
// wgmma fed by bulk asynchronous copies):
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
// ~20 bytes per point are noise beside the stashes (~20 KB per point moved),
// which put this design's floor at ~4.8 ms for the fine pass.
//
// Every config off the presets takes the tensor-core general route
// (fused_tc_train.cu).

#include "nerf_composite.cuh"
#include "nerf_mlp_train.cuh"

using namespace nerf_train;

using namespace nerf_composite;

extern "C" {

size_t fused_train_workspace_bytes(int m, int feat) {
  return stash_bytes(m, feat) + composite_bytes(m) + gemm_ws_bytes(m, feat);
}

size_t fused_train_smem_bytes(int feat) {
  const size_t a = forward_smem_bytes(feat);
  const size_t b = chain_smem_bytes(feat);
  const size_t c = gemm_smem_bytes();
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

const char* fused_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream`; returns the cudaError_t of the launches (0 on
// success). weights / weights_t: the forward and chain images of
// training_layout, biases its biases.
int fused_train_pass(const float* ray_o, const float* ray_d, const float* t, const float* delta,
                     const float* rgb_gt, int n_rays, int samples, int num_real,
                     const void* const* weights, const void* const* biases,
                     const void* const* weights_t, void* workspace, float* rgb_out,
                     float* weights_out, float* const* grads_w, float* const* grads_b, int feat,
                     int pos_levels, int dir_levels, int include_input, int pe_dim, int de_dim,
                     void* stream) {
  const Net net = make_net(weights, biases, weights_t, pos_levels, dir_levels, include_input, pe_dim,
                           de_dim);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = n_rays * samples;
  unsigned char* base = static_cast<unsigned char*>(workspace);
  size_t used = 0;
  const Stash st = carve_stash(base, m, feat, &used);
  float* g_sigma = reinterpret_cast<float*>(base + used);
  used += align256(static_cast<size_t>(m) * sizeof(float));
  float* trans = reinterpret_cast<float*>(base + used);
  used += align256(static_cast<size_t>(m) * sizeof(float));
  float* g_rgb = reinterpret_cast<float*>(base + used);
  used += align256(static_cast<size_t>(m) * 3 * sizeof(float));
  float* ws = reinterpret_cast<float*>(base + used);
  const RayInput in = {ray_o, ray_d, t, samples};

  cudaError_t err = run_forward(in, net, st, m, feat, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite<<<(n_rays + kCompositeWarps - 1) / kCompositeWarps, 32 * kCompositeWarps, 0, s>>>(
      st.sigma, st.rgb, delta, rgb_gt, n_rays, samples, num_real, rgb_out, weights_out, trans,
      g_sigma, g_rgb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run_chain<false>(in, net, st, g_sigma, g_rgb, nullptr, nullptr, m, feat, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run_gemms(net, st, m, feat, ws, grads_w, grads_b, s));
}

}  // extern "C"
