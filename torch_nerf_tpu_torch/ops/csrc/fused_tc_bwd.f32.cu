// The f32 instances of fused_tc_bwd.cu (kernel 2's f32 forward and chain on route f32_wgmma,
// every kernel shape of nerf_mlp_tc.cuh's f32 plans), in a translation unit of
// their own: nvcc compiles them beside the entry source's bf16 ones, and
// torch_nerf_tpu_torch/ops/build.py links both objects into one library.

#include "nerf_mlp_tc.cuh"

template cudaError_t nerf_tc::run_forward<float, true, nerf_train::PointInput>(
    const nerf_train::PointInput&, const nerf_general::Net&, const void* const*, nerf_general::Stash<float>, uint32_t*,
    int, cudaStream_t, void*);
template cudaError_t nerf_tc::run_chain<float, true>(const nerf_general::Net&, const void* const*,
                                                   const nerf_general::Stash<float>&, const uint32_t*,
                                                   const float*, const float*, float*, float*, int,
                                                   cudaStream_t);
