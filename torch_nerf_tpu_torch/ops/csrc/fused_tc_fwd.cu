// Kernel 1 (the fused field's forward) on the tensor-core general route:
// nerf_mlp_tc.cuh's forward without its stash, for the configs
// torch_nerf_tpu_torch/ops/fused_nerf.py::forward_route gives wgmma_general
// (bf16, every padded width 32..1024 off the wgmma presets) or f32_wgmma
// (f32, every padded width 32..1024). Replaces, on those configs, the Pallas TPU kernel
// torch_nerf_tpu/ops/pallas/fused_nerf.py::_fwd_kernel (reached through
// _fused_forward's pl.pallas_call). Bound on an H100 SXM: flops_per_point a
// point at 989 TFLOP/s dense bf16, or at 989 / 8 TFLOP/s for f32_wgmma (eight
// bf16 products a multiply), against 40 bytes of input and output a point;
// the header note gives the design. Weights: fused_nerf.py::tc_layout's
// forward images; biases: tc_biases'. Past f32 512 the forward streams its
// layers through a scratch of fused_tc_fwd_workspace_bytes (nerf_mlp_tc.cuh::
// scratch_bytes).

#include "nerf_mlp_tc.cuh"

// kernel 1's f32 forward (every f32_wgmma kernel shape): instantiated in
// fused_tc_fwd.f32.cu, compiled beside this source and linked into its library
extern template cudaError_t nerf_tc::run_forward<float, false, nerf_train::PointInput>(
    const nerf_train::PointInput&, const nerf_general::Net&, const void* const*, nerf_general::Stash<float>, uint32_t*,
    int, cudaStream_t, void*);

extern "C" {

const char* fused_tc_fwd_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// 1 if the tensor-core general route takes the config (bf16 and f32 at a
// padded width % 32 == 0 up to 1024, encodings up to 128 wide, every
// kernel's ring at least two stages deep beside its tiles), else 0:
// fused_nerf.py::tc_stages' counterpart
int fused_tc_takes(int feat, int pe_dim, int de_dim, int pe_pad, int de_pad, int f32) {
  namespace g = nerf_general;
  const g::Dims d = g::make_dims(feat, 0, 0, 0, pe_dim, de_dim, pe_pad, de_pad);
  return f32 ? nerf_tc::takes<float>(d) : nerf_tc::takes<nerf_tc::bf16>(d);
}

// the plan of the config (nerf_mlp_tc.cuh::plan_of: the pass width, the
// passes, each kernel's ring stages and shared memory, the sign-bit words,
// the CTAs an SM, kernel 1's passes, whether it streams; 13 values):
// fused_nerf.py::tc_plan's counterpart
void fused_tc_plan(int feat, int pe_dim, int de_dim, int pe_pad, int de_pad, int f32, long long* out) {
  namespace g = nerf_general;
  const g::Dims d = g::make_dims(feat, 0, 0, 0, pe_dim, de_dim, pe_pad, de_pad);
  if (f32) nerf_tc::plan_of<float>(d, out);
  else nerf_tc::plan_of<nerf_tc::bf16>(d, out);
}

// kernel 1's scratch bytes at m points (0 where it keeps its layers on chip)
size_t fused_tc_fwd_workspace_bytes(int m, int feat, int pe_pad, int de_pad, int f32) {
  namespace g = nerf_general;
  const g::Dims d = g::make_dims(feat, 0, 0, 0, pe_pad, de_pad, pe_pad, de_pad);
  return f32 ? nerf_tc::scratch_bytes<float>(m, d) : nerf_tc::scratch_bytes<nerf_tc::bf16>(m, d);
}

// Launches the forward on `stream`; returns the cudaError_t of the launch (0
// on success). weights: the route's forward images, biases tc_biases';
// workspace: fused_tc_fwd_workspace_bytes(m, ...) bytes (null where 0).
int fused_tc_fwd(const float* pts, const float* dirs, const void* const* weights, const void* const* biases,
                 float* sigma, float* rgb, int m, int feat, int pos_levels, int dir_levels, int include_input,
                 int pe_dim, int de_dim, int pe_pad, int de_pad, int f32, void* workspace, void* stream) {
  namespace g = nerf_general;
  const g::Dims d = g::make_dims(feat, pos_levels, dir_levels, include_input, pe_dim, de_dim, pe_pad, de_pad);
  const g::Net net = g::make_net(biases, d);
  const nerf_train::PointInput in = {pts, dirs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    g::Stash<float> st = {};
    st.sigma = sigma;
    st.rgb = rgb;
    return static_cast<int>(nerf_tc::run_forward<float, false>(in, net, weights, st, nullptr, m, s, workspace));
  }
  g::Stash<nerf_tc::bf16> st = {};
  st.sigma = sigma;
  st.rgb = rgb;
  return static_cast<int>(nerf_tc::run_forward<nerf_tc::bf16, false>(in, net, weights, st, nullptr, m, s));
}

}  // extern "C"
