// Fused NeRF field forward on Hopper: positional encoding + the 11-layer MLP
// in one kernel, activations kept in shared memory.
//
// Replaces the Pallas TPU kernel torch_nerf_tpu/ops/pallas/fused_nerf.py::
// _fwd_kernel (reached through _fused_forward's pl.pallas_call); the math is
// its _forward_tile: PE(pts) 63-d, PE(dirs) 27-d, trunk fc_in..fc_4, skip
// concat [pe, h4] into fc_5, fc_6, fc_7, fc_8 -> sigma = relu(its sigma
// column), [fc_8's features, de] -> fc_9 -> relu -> fc_out -> sigmoid.
//
// Precision: bf16 operands, f32 accumulation; every layer output is rounded to
// bf16, the bias added and rounded again, as nerf_apply(compute_dtype=bf16)
// does (torch_nerf_tpu/models/nerf.py:84-125); on the f32 route f32
// throughout, as nerf_apply(compute_dtype=float32). Encoding uses exact
// sincosf in f32 (arguments reach 2^19 * |p|, so no fast-math).
//
// Bound on an H100 SXM: 1,186,816 FLOP per point at width 256 (593,408 MACs),
// against 40 bytes of input and output per point and 1.2 MB of weights: the
// kernel is bound by tensor-core operations (0.94 ms per 786,432-point fine
// chunk at 989 TFLOP/s). Every activation stays on chip, so no hidden layer
// touches device memory. This source is the route of the presets, chosen by
// the wrapper (torch_nerf_tpu_torch/ops/fused_nerf.py::forward_route): bf16
// at widths 64, 128 and 256 with encodings up to 64 wide, nerf_mlp_train.cuh's
// forward without its stash (forward_consumer<F, false>), the product loop
// of kernels 2 and 3: 128-point CTAs, two consumer warpgroups on wgmma
// holding a layer's 64 x F sums in registers, a producer warpgroup
// streaming every layer's weights through a 3-stage shared-memory ring by
// bulk asynchronous copies. The weights are its forward images (W^T in
// K-major 128-byte swizzled panels, fc_8's sigma row after the features,
// biases in that row order). Writes sigma (m,) and rgb (m, 3). Every other
// config takes the tensor-core general route (fused_tc_fwd.cu).
//
// fused_nerf_fwd_layout() returns 1: fused_nerf_fwd reads forward panel
// images.

#include "nerf_mlp_train.cuh"

namespace {

// the wgmma route: kernel 3's forward without the stash
template <int F>
__global__ void __launch_bounds__(nerf_train::kThreads, 1)
    fused_nerf_fwd_kernel(nerf_train::PointInput in, const __grid_constant__ nerf_train::Net net,
                          const __grid_constant__ nerf_train::Stash st, int m,
                          const __grid_constant__ nerf_train::Plan plan) {
  nerf_train::forward_block<F, false>(in, net, st, m, plan);
}

template <int F>
cudaError_t launch_wgmma(const nerf_train::PointInput& in, const nerf_train::Net& net,
                         const nerf_train::Stash& st, int m, cudaStream_t stream) {
  const size_t smem = nerf_train::forward_smem_bytes(F);
  cudaError_t err = nerf_train::set_smem(fused_nerf_fwd_kernel<F>, smem);
  if (err != cudaSuccess) return err;
  fused_nerf_fwd_kernel<F><<<st.m_pad / nerf_train::kRows, nerf_train::kThreads, smem, stream>>>(
      in, net, st, m, nerf_train::forward_plan(net, F));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_nerf_fwd_layout(void) { return 1; }

const char* fused_nerf_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the wgmma route on `stream`; returns the cudaError_t of the launch
// (0 on success). weights, biases: the forward images and biases of
// training_layout; feat in {64, 128, 256}; pe_pad and de_pad are not read
// (the images pad each encoding to 64 columns).
int fused_nerf_fwd(const float* pts, const float* dirs, const void* const* weights,
                   const void* const* biases, float* sigma, float* rgb, int m, int feat,
                   int pos_levels, int dir_levels, int include_input, int pe_dim,
                   int de_dim, int pe_pad, int de_pad, void* stream) {
  (void)pe_pad;
  (void)de_pad;
  const nerf_train::Net net = nerf_train::make_net(weights, biases, nullptr, pos_levels, dir_levels,
                                                   include_input, pe_dim, de_dim);
  nerf_train::Stash st = {};
  st.sigma = sigma;
  st.rgb = rgb;
  st.m_pad = nerf_train::padded_points(m);
  const nerf_train::PointInput in = {pts, dirs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat) {
    case 64: return static_cast<int>(launch_wgmma<64>(in, net, st, m, s));
    case 128: return static_cast<int>(launch_wgmma<128>(in, net, st, m, s));
    case 256: return static_cast<int>(launch_wgmma<256>(in, net, st, m, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
