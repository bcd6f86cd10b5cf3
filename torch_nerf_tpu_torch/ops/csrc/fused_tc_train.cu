// Kernel 3 (the fused train pass) on the tensor-core general route, for the
// configs torch_nerf_tpu_torch/ops/fused_nerf.py::train_route gives
// wgmma_general or f32_wgmma: nerf_mlp_tc.cuh's forward with its stash, the
// composite of nerf_composite.cuh, nerf_mlp_tc.cuh's chain, then
// nerf_stash.cuh's dW GEMM over the stashes (nerf_dw_tc.cuh).
// Replaces, on those configs, the Pallas TPU kernel torch_nerf_tpu/ops/
// pallas/fused_train.py::_train_kernel (reached through fused_train_pass's
// pl.pallas_call). Bound on an H100 SXM: 3 x flops_per_point a point at 989
// TFLOP/s dense bf16 or 989 / 8 TFLOP/s for f32_wgmma; the stashes' bytes
// (fused_train.py::phase_floors) are the other floor.

#include "nerf_composite.cuh"
#include "nerf_mlp_tc.cuh"

// kernel 3's f32 forward and chain (every f32_wgmma kernel shape): instantiated in
// fused_tc_train.f32.cu, compiled beside this source and linked into its library
extern template cudaError_t nerf_tc::run_forward<float, true, nerf_train::RayInput>(
    const nerf_train::RayInput&, const nerf_general::Net&, const void* const*, nerf_general::Stash<float>, uint32_t*,
    int, cudaStream_t, void*);
extern template cudaError_t nerf_tc::run_chain<float, false>(const nerf_general::Net&, const void* const*,
                                                          const nerf_general::Stash<float>&, const uint32_t*,
                                                          const float*, const float*, float*, float*, int,
                                                          cudaStream_t);

namespace {

namespace g = nerf_general;
using nerf_composite::composite;
using nerf_composite::kCompositeWarps;

// the workspace after the stash: the relu bits, sigma, rgb, the composite's
// per-point outputs, the dW partials
template <class T>
size_t tc_bytes(int m, const g::Dims& d) {
  const size_t mp = g::padded_points(m);
  return g::stash_bytes<T>(m, d) + nerf_tc::bits_bytes<T>(m, d) + 3 * g::align256(mp * sizeof(float)) +
         2 * g::align256(mp * 3 * sizeof(float)) + g::dw_ws_bytes<T>(m, d);
}

template <class T>
int train_tc(const nerf_train::RayInput& in, const float* delta, const float* rgb_gt, int n_rays, int num_real,
             const g::Net& net, const void* const* fwd, const void* const* chain, void* workspace, float* rgb_out,
             float* weights_out, float* const* grads_w, float* const* grads_b, cudaStream_t s) {
  const int m = n_rays * in.samples;
  const size_t mp = g::padded_points(m);
  unsigned char* base = static_cast<unsigned char*>(workspace);
  size_t used = 0;
  g::Stash<T> st = g::carve_stash<T>(base, m, net.d, &used);
  uint32_t* bits = reinterpret_cast<uint32_t*>(base + used);
  used += nerf_tc::bits_bytes<T>(m, net.d);
  auto take = [&](size_t floats) {
    float* p = reinterpret_cast<float*>(base + used);
    used += g::align256(floats * sizeof(float));
    return p;
  };
  st.sigma = take(mp);
  st.rgb = take(mp * 3);
  float* g_sigma = take(mp);
  float* trans = take(mp);
  float* g_rgb = take(mp * 3);
  float* part = reinterpret_cast<float*>(base + used);

  cudaError_t err = nerf_tc::run_forward<T, true>(in, net, fwd, st, bits, m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite<<<(n_rays + kCompositeWarps - 1) / kCompositeWarps, 32 * kCompositeWarps, 0, s>>>(
      st.sigma, st.rgb, delta, rgb_gt, n_rays, in.samples, num_real, rgb_out, weights_out, trans, g_sigma, g_rgb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = nerf_tc::run_chain<T, false>(net, chain, st, bits, g_sigma, g_rgb, nullptr, nullptr, m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(g::run_dw<T>(st, net.d, m, part, grads_w, grads_b, s));
}

}  // namespace

extern "C" {

const char* fused_tc_train_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

size_t fused_train_tc_workspace_bytes(int m, int feat, int pe_pad, int de_pad, int f32) {
  const g::Dims d = g::make_dims(feat, 0, 0, 0, 0, 0, pe_pad, de_pad);
  return f32 ? tc_bytes<float>(m, d) : tc_bytes<nerf_tc::bf16>(m, d);
}

// Launches the pass on `stream`; returns the cudaError_t of the launches (0
// on success). The rays' origins and directions (n_rays, 3), depths t and
// intervals delta (n_rays, samples), the ground truth rgb_gt (n_rays, 3),
// the loss over the first num_real rays; weights the route's forward
// images, weights_t its 13 chain images (fused_nerf.py::tc_layout), biases
// tc_biases'; out: rgb (n_rays, 3), the composite weights (n_rays,
// samples), the kernel-layout f32 grads (nerf_stash.cuh); workspace of
// fused_train_tc_workspace_bytes(n_rays * samples, ...) bytes.
int fused_train_pass_tc(const float* ray_o, const float* ray_d, const float* t, const float* delta,
                        const float* rgb_gt, int n_rays, int samples, int num_real, const void* const* weights,
                        const void* const* biases, const void* const* weights_t, void* workspace, float* rgb_out,
                        float* weights_out, float* const* grads_w, float* const* grads_b, int feat, int pos_levels,
                        int dir_levels, int include_input, int pe_dim, int de_dim, int pe_pad, int de_pad, int f32,
                        void* stream) {
  const g::Dims d = g::make_dims(feat, pos_levels, dir_levels, include_input, pe_dim, de_dim, pe_pad, de_pad);
  if (n_rays <= 0 || samples <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const g::Net net = g::make_net(biases, d);
  const nerf_train::RayInput in = {ray_o, ray_d, t, samples};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    return train_tc<float>(in, delta, rgb_gt, n_rays, num_real, net, weights, weights_t, workspace, rgb_out,
                           weights_out, grads_w, grads_b, s);
  return train_tc<nerf_tc::bf16>(in, delta, rgb_gt, n_rays, num_real, net, weights, weights_t, workspace, rgb_out,
                                 weights_out, grads_w, grads_b, s);
}

// a planted fault of the dW GEMM (nerf_dw::Fault) in this library's
// launches from now on; 0 takes it out
void fused_tc_train_set_dw_fault(int kind) { nerf_dw::fault() = kind; }

// the dW GEMM kernel's launches in this library so far (nerf_dw::launches)
long long fused_tc_train_dw_launches() { return nerf_dw::launches(); }

}  // extern "C"
