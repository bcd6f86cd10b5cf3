// Backward of the fused NeRF field on Hopper: the recomputed forward and the
// VJP to the 22 parameter grads, summed over every point, and to the points
// and view directions.
//
// Replaces the Pallas TPU kernel torch_nerf_tpu/ops/pallas/fused_nerf.py::
// _bwd_kernel (reached through _fused_bwd's pl.pallas_call); the math is its
// _backward_tile and the encode VJP _encode_fast_bwd: on the sin(2^l x) and
// cos(2^l x) columns the VJP carries the factor 2^l, the identity columns
// pass g through.
//
// The work is cut into the kernels of nerf_mlp_train.cuh, on wgmma fed by
// bulk asynchronous copies: the forward with a stash of every activation,
// the backward chain per 128-point tile (with dpe, dde and the encode VJP to
// dpts, ddirs), and the split-K GEMMs dW = A^T dZ with their fixed-order
// reduction into the public layout. Bound on an H100 SXM: 3 x 1,186,816
// FLOP per point at 989 TFLOP/s dense bf16 (2.83 ms for 786,432 points);
// the stashes' ~20 KB per point put this design's floor at ~4.8 ms there.
//
// Every config off the presets takes the tensor-core general route
// (fused_tc_bwd.cu).
//
// Layout contract of the wgmma route with torch_nerf_tpu_torch/ops/fused_nerf.py: weights,
// biases, weights_t the forward images, biases and chain images of
// training_layout; grads_w[l], grads_b[l] the public (in, out) and (out,)
// f32 gradients; workspace of fused_nerf_bwd_workspace_bytes(m, feat) bytes.

#include "nerf_mlp_train.cuh"

using namespace nerf_train;

extern "C" {

size_t fused_nerf_bwd_workspace_bytes(int m, int feat) { return stash_bytes(m, feat) + gemm_ws_bytes(m, feat); }

size_t fused_nerf_bwd_smem_bytes(int feat) {
  const size_t a = forward_smem_bytes(feat);
  const size_t b = chain_smem_bytes(feat);
  const size_t c = gemm_smem_bytes();
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

const char* fused_nerf_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream`; returns the cudaError_t of the launches (0 on success).
int fused_nerf_bwd(const float* pts, const float* dirs, const float* g_sigma, const float* g_rgb,
                   const void* const* weights, const void* const* biases,
                   const void* const* weights_t, void* workspace, float* const* grads_w,
                   float* const* grads_b, float* dpts, float* ddirs, int m, int feat,
                   int pos_levels, int dir_levels, int include_input, int pe_dim, int de_dim,
                   void* stream) {
  const Net net = make_net(weights, biases, weights_t, pos_levels, dir_levels, include_input, pe_dim,
                           de_dim);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t used = 0;
  const Stash st = carve_stash(static_cast<unsigned char*>(workspace), m, feat, &used);
  float* ws = reinterpret_cast<float*>(static_cast<unsigned char*>(workspace) + used);
  const PointInput in = {pts, dirs};

  cudaError_t err = run_forward(in, net, st, m, feat, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run_chain<true>(in, net, st, g_sigma, g_rgb, dpts, ddirs, m, feat, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run_gemms(net, st, m, feat, ws, grads_w, grads_b, s));
}

}  // extern "C"
