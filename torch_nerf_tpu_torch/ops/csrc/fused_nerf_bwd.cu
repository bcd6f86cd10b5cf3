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
// The work is cut into the kernels of nerf_mlp.cuh: the forward with a stash
// of every activation, the backward chain per 64-point tile (with dpe, dde
// and the encode VJP to dpts, ddirs), and the split-K GEMMs dW = A^T dZ with
// their fixed-order reduction into the public layout. Bound on an H100 SXM:
// 3 x 1,186,816 FLOP per point at 989 TFLOP/s dense bf16 (2.83 ms for
// 786,432 points); the stashes make this first design memory-bound.
//
// Layout contract with torch_nerf_tpu_torch/ops/fused_nerf.py: w, b, wt as
// in nerf_mlp.cuh; grads_w[l], grads_b[l] the public (in, out) and (out,)
// f32 gradients; workspace of fused_nerf_bwd_workspace_bytes(m, ...) bytes.

#include "nerf_mlp.cuh"

using namespace nerf_mlp;

extern "C" {

size_t fused_nerf_bwd_workspace_bytes(int m, int feat, int pe_pad, int de_pad) {
  Net net = {};
  net.feat = feat;
  net.pe_pad = pe_pad;
  net.de_pad = de_pad;
  return stash_bytes(m, feat, pe_pad, de_pad) + gemm_ws_bytes(net, m);
}

size_t fused_nerf_bwd_smem_bytes(int feat, int pe_pad, int de_pad) {
  const size_t a = forward_smem_bytes(feat, pe_pad, de_pad);
  const size_t b = chain_smem_bytes(feat, pe_pad, de_pad, true);
  return a > b ? a : b;
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
                   int pe_pad, int de_pad, void* stream) {
  const Net net = make_net(weights, biases, weights_t, feat, pos_levels, dir_levels, include_input,
                           pe_dim, de_dim, pe_pad, de_pad);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t used = 0;
  const Stash st = carve_stash(static_cast<unsigned char*>(workspace), m, feat, pe_pad, de_pad,
                               &used);
  float* ws = reinterpret_cast<float*>(static_cast<unsigned char*>(workspace) + used);
  const PointInput in = {pts, dirs};

  cudaError_t err = run_forward(in, net, st, m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run_chain<true>(in, net, st, g_sigma, g_rgb, dpts, ddirs, m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run_gemms(net, st, m, ws, grads_w, grads_b, s));
}

}  // extern "C"
