// Kernel 2 (the fused field's backward) on the tensor-core general route,
// for the configs torch_nerf_tpu_torch/ops/fused_nerf.py::train_route gives
// wgmma_general or f32_wgmma: nerf_mlp_tc.cuh's forward with its stash and its
// chain with the encodings' cotangents, then nerf_stash.cuh's encode
// VJP to dpts and ddirs and its dW GEMM (nerf_dw_tc.cuh). Replaces, on
// those configs, the Pallas TPU kernel torch_nerf_tpu/ops/pallas/
// fused_nerf.py::_bwd_kernel (reached through _fused_bwd's pl.pallas_call).
// Bound on an H100 SXM: 3 x flops_per_point a point at 989 TFLOP/s dense
// bf16 or 989 / 8 TFLOP/s for f32_wgmma (eight bf16 products a multiply).

#include "nerf_mlp_tc.cuh"

// kernel 2's f32 forward and chain (every f32_wgmma kernel shape): instantiated in
// fused_tc_bwd.f32.cu, compiled beside this source and linked into its library
extern template cudaError_t nerf_tc::run_forward<float, true, nerf_train::PointInput>(
    const nerf_train::PointInput&, const nerf_general::Net&, const void* const*, nerf_general::Stash<float>, uint32_t*,
    int, cudaStream_t, void*);
extern template cudaError_t nerf_tc::run_chain<float, true>(const nerf_general::Net&, const void* const*,
                                                          const nerf_general::Stash<float>&, const uint32_t*,
                                                          const float*, const float*, float*, float*, int,
                                                          cudaStream_t);

namespace {

namespace g = nerf_general;

// the workspace after the stash: the relu bits, sigma, rgb, the encodings'
// cotangents, the dW partials
template <class T>
size_t tc_bytes(int m, const g::Dims& d) {
  const size_t mp = g::padded_points(m);
  return g::stash_bytes<T>(m, d) + nerf_tc::bits_bytes<T>(m, d) + g::align256(mp * sizeof(float)) +
         g::align256(mp * 3 * sizeof(float)) + g::align256(mp * d.pe_pad * sizeof(float)) +
         g::align256(mp * d.de_pad * sizeof(float)) + g::dw_ws_bytes<T>(m, d);
}

template <class T>
int bwd_tc(const float* pts, const float* dirs, const float* g_sigma, const float* g_rgb, const g::Net& net,
           const void* const* fwd, const void* const* chain, void* workspace, float* const* grads_w,
           float* const* grads_b, float* dpts, float* ddirs, int m, cudaStream_t s) {
  const g::Dims& d = net.d;
  const size_t mp = g::padded_points(m);
  unsigned char* base = static_cast<unsigned char*>(workspace);
  size_t used = 0;
  g::Stash<T> st = g::carve_stash<T>(base, m, d, &used);
  uint32_t* bits = reinterpret_cast<uint32_t*>(base + used);
  used += nerf_tc::bits_bytes<T>(m, d);
  auto take = [&](size_t floats) {
    float* p = reinterpret_cast<float*>(base + used);
    used += g::align256(floats * sizeof(float));
    return p;
  };
  st.sigma = take(mp);
  st.rgb = take(mp * 3);
  float* dpe = take(mp * d.pe_pad);
  float* dde = take(mp * d.de_pad);
  float* part = reinterpret_cast<float*>(base + used);
  const nerf_train::PointInput in = {pts, dirs};

  cudaError_t err = nerf_tc::run_forward<T, true>(in, net, fwd, st, bits, m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = nerf_tc::run_chain<T, true>(net, chain, st, bits, g_sigma, g_rgb, dpe, dde, m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  g::encode_vjp_kernel<<<g::cdiv(3 * m, 256), 256, 0, s>>>(in, dpe, dde, d, m, dpts, ddirs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(g::run_dw<T>(st, d, m, part, grads_w, grads_b, s));
}

template <class T>
int dw_alone(void* stash, int m, const g::Dims& d, void* part, float* const* grads_w, float* const* grads_b,
             cudaStream_t s) {
  size_t used = 0;
  const g::Stash<T> st = g::carve_stash<T>(static_cast<unsigned char*>(stash), m, d, &used);
  return static_cast<int>(g::run_dw<T>(st, d, m, static_cast<float*>(part), grads_w, grads_b, s));
}

template <class T>
void dw_plan(int m, const g::Dims& d, long long* out) {
  static nerf_dw::Plan plan;
  float* none[g::kLayers] = {};
  nerf_dw::make_plan<T>(plan, g::dw_stashes<T>(g::Stash<T>{}, d), m, none, none, false);
  out[0] = plan.jobs;
  out[1] = plan.splits;
  out[2] = plan.chunk;
  out[3] = static_cast<long long>(nerf_dw::smem_bytes<T>());
  out[4] = static_cast<long long>(g::dw_ws_bytes<T>(m, d));
  out[5] = plan.window;
  out[6] = plan.windows;
}

}  // namespace

extern "C" {

const char* fused_tc_bwd_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

size_t fused_nerf_bwd_tc_workspace_bytes(int m, int feat, int pe_pad, int de_pad, int f32) {
  const g::Dims d = g::make_dims(feat, 0, 0, 0, 0, 0, pe_pad, de_pad);
  return f32 ? tc_bytes<float>(m, d) : tc_bytes<nerf_tc::bf16>(m, d);
}

// Launches the backward on `stream`; returns the cudaError_t of the
// launches (0 on success). pts, dirs (m, 3), the cotangents g_sigma (m,)
// and g_rgb (m, 3), all f32; weights the route's forward images, weights_t
// its 13 chain images (fused_nerf.py::tc_layout), biases tc_biases';
// grads_w[l], grads_b[l] the kernel-layout f32 grads (nerf_stash.cuh);
// workspace of fused_nerf_bwd_tc_workspace_bytes(m, ...) bytes; m > 0.
int fused_nerf_bwd_tc(const float* pts, const float* dirs, const float* g_sigma, const float* g_rgb,
                      const void* const* weights, const void* const* biases, const void* const* weights_t,
                      void* workspace, float* const* grads_w, float* const* grads_b, float* dpts, float* ddirs, int m,
                      int feat, int pos_levels, int dir_levels, int include_input, int pe_dim, int de_dim, int pe_pad,
                      int de_pad, int f32, void* stream) {
  const g::Dims d = g::make_dims(feat, pos_levels, dir_levels, include_input, pe_dim, de_dim, pe_pad, de_pad);
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const g::Net net = g::make_net(biases, d);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    return bwd_tc<float>(pts, dirs, g_sigma, g_rgb, net, weights, weights_t, workspace, grads_w, grads_b, dpts,
                         ddirs, m, s);
  return bwd_tc<nerf_tc::bf16>(pts, dirs, g_sigma, g_rgb, net, weights, weights_t, workspace, grads_w, grads_b, dpts,
                               ddirs, m, s);
}

// The general route's dW GEMM alone (nerf_dw_tc.cuh), for its checks and
// timings: over the stash at the start of `stash` (carve_stash's layout, as
// every general entry's workspace begins; m rows), into the kernel-layout
// grads; part: fused_general_dw_workspace_bytes bytes. Returns the
// cudaError_t of the launches.
size_t fused_general_dw_workspace_bytes(int m, int feat, int pe_pad, int de_pad, int f32) {
  const g::Dims d = g::make_dims(feat, 0, 0, 0, 0, 0, pe_pad, de_pad);
  return f32 ? g::dw_ws_bytes<float>(m, d) : g::dw_ws_bytes<nerf_tc::bf16>(m, d);
}

int fused_general_dw(void* stash, int m, int feat, int pe_pad, int de_pad, int f32, void* part,
                     float* const* grads_w, float* const* grads_b, void* stream) {
  const g::Dims d = g::make_dims(feat, 0, 0, 0, 0, 0, pe_pad, de_pad);
  if (!g::dims_ok(d) || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? dw_alone<float>(stash, m, d, part, grads_w, grads_b, s)
             : dw_alone<nerf_tc::bf16>(stash, m, d, part, grads_w, grads_b, s);
}

// its plan at m points: out[0..6] = tiles, slices, points a slice, shared
// memory a CTA, workspace bytes, slices a launch, launches
// (fused_nerf.dw_tc_plan's twin)
void fused_general_dw_plan(int m, int feat, int pe_pad, int de_pad, int f32, long long* out) {
  const g::Dims d = g::make_dims(feat, 0, 0, 0, 0, 0, pe_pad, de_pad);
  if (f32) dw_plan<float>(m, d, out);
  else dw_plan<nerf_tc::bf16>(m, d, out);
}

// a planted fault of the dW GEMM (nerf_dw::Fault) in this library's
// launches from now on; 0 takes it out
void fused_tc_bwd_set_dw_fault(int kind) { nerf_dw::fault() = kind; }

// the dW GEMM kernel's launches in this library so far (nerf_dw::launches)
long long fused_tc_bwd_dw_launches() { return nerf_dw::launches(); }

}  // extern "C"
