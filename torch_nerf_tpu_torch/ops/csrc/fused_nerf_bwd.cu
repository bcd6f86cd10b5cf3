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
// fused_nerf_bwd_general takes the f32 configs the tensor-core general
// route (fused_tc_bwd.cu) does not hold: widths F % 32 == 0 up to 1024,
// encodings up to 128 wide, on FFMA, with nerf_mlp_general.cuh's forward
// with its stash, chain (with the encodings' cotangents and their VJP to
// dpts, ddirs) and dW GEMM (its header note gives the design and the
// layouts).
//
// Layout contract of the wgmma route with torch_nerf_tpu_torch/ops/fused_nerf.py: weights,
// biases, weights_t the forward images, biases and chain images of
// training_layout; grads_w[l], grads_b[l] the public (in, out) and (out,)
// f32 gradients; workspace of fused_nerf_bwd_workspace_bytes(m, feat) bytes.

#include "nerf_mlp_general.cuh"
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

namespace {

namespace g = nerf_general;

// the general route's workspace after the stash: sigma, rgb, the
// encodings' cotangents, the dW partials
template <class T>
size_t general_bytes(int m, const g::Dims& d) {
  const size_t mp = g::padded_points(m);
  return g::stash_bytes<T>(m, d) + g::align256(mp * sizeof(float)) + g::align256(mp * 3 * sizeof(float)) +
         g::align256(mp * d.pe_pad * sizeof(float)) + g::align256(mp * d.de_pad * sizeof(float)) +
         g::dw_ws_bytes<T>(m, d);
}

template <class T>
int bwd_general(const float* pts, const float* dirs, const float* g_sigma, const float* g_rgb, const g::Net& net,
                void* workspace, float* const* grads_w, float* const* grads_b, float* dpts, float* ddirs, int m,
                cudaStream_t s) {
  const g::Dims& d = net.d;
  const size_t mp = g::padded_points(m);
  unsigned char* base = static_cast<unsigned char*>(workspace);
  size_t used = 0;
  g::Stash<T> st = g::carve_stash<T>(base, m, d, &used);
  st.sigma = reinterpret_cast<float*>(base + used);
  used += g::align256(mp * sizeof(float));
  st.rgb = reinterpret_cast<float*>(base + used);
  used += g::align256(mp * 3 * sizeof(float));
  float* dpe = reinterpret_cast<float*>(base + used);
  used += g::align256(mp * d.pe_pad * sizeof(float));
  float* dde = reinterpret_cast<float*>(base + used);
  used += g::align256(mp * d.de_pad * sizeof(float));
  float* part = reinterpret_cast<float*>(base + used);
  const nerf_train::PointInput in = {pts, dirs};

  cudaError_t err = g::run_forward<T, true>(in, net, st, m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = g::run_chain<T, true>(net, st, g_sigma, g_rgb, dpe, dde, m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  g::encode_vjp_kernel<<<g::cdiv(3 * m, 256), 256, 0, s>>>(in, dpe, dde, d, m, dpts, ddirs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(g::run_dw<T>(st, d, m, part, grads_w, grads_b, s));
}

}  // namespace

extern "C" {

size_t fused_nerf_bwd_general_workspace_bytes(int m, int feat, int pe_pad, int de_pad, int f32) {
  const g::Dims d = g::make_dims(feat, 0, 0, 0, 0, 0, pe_pad, de_pad);
  return f32 ? general_bytes<float>(m, d) : 0;
}

// Launches the FFMA general route on `stream`; returns the cudaError_t of
// the launches (0 on success). weights, weights_t, biases: general_matrices'
// forward and chain matrices and biases, f32 row-major (f32 must be 1: a
// bf16 config is refused); grads_w[l], grads_b[l]: the kernel-layout f32
// grads (the forward matrix's rows x the dz's columns); workspace of
// fused_nerf_bwd_general_workspace_bytes(m, ...) bytes; m > 0.
int fused_nerf_bwd_general(const float* pts, const float* dirs, const float* g_sigma, const float* g_rgb,
                           const void* const* weights, const void* const* biases, const void* const* weights_t,
                           void* workspace, float* const* grads_w, float* const* grads_b, float* dpts,
                           float* ddirs, int m, int feat, int pos_levels, int dir_levels, int include_input,
                           int pe_dim, int de_dim, int pe_pad, int de_pad, int f32, void* stream) {
  const g::Dims d = g::make_dims(feat, pos_levels, dir_levels, include_input, pe_dim, de_dim, pe_pad, de_pad);
  if (!g::dims_ok(d) || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const g::Net net = g::make_net(weights, biases, weights_t, d);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!f32) return static_cast<int>(cudaErrorInvalidValue);
  return bwd_general<float>(pts, dirs, g_sigma, g_rgb, net, workspace, grads_w, grads_b, dpts, ddirs, m, s);
}

// the dW GEMM kernel's launches in this library so far (nerf_dw::launches)
long long fused_nerf_bwd_dw_launches() { return nerf_dw::launches(); }

}  // extern "C"
