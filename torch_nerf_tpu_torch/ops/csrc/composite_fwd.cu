// The volume-rendering quadrature of the frame loop, forward only, on
// Hopper: for each ray, w_i = exp(-sum_{j<i} sigma_j delta_j) (1 - exp(-sigma_i
// delta_i)) and C = sum_i w_i c_i, in one kernel.
//
// Replaces no TPU kernel: the JAX package leaves the quadrature to XLA
// (torch_nerf_tpu/ops/integration.py), and the port's frame loop ran it as
// ops/integration.py::composite's twelve PyTorch kernels (product, cumsum,
// zeros and a concatenation for the exclusive sum, two exps, the weights,
// the weighted radiance and its sum), each launched by the host. In the
// Instant-NGP frame loop (4096 rays x 256 samples a chunk) the chunk's
// device work is ~0.85 ms on an H100, and its host work about as long, so
// every launch the host saves shortens a chunk wherever the host is the
// slower side; the twelve passes also move ~100 MB a chunk where one pass
// moves 25 MB (sigma, delta, radiance read, the weights written).
//
// Design: one warp a ray, the CTA eight rays. The warp walks its ray's
// samples 32 at a time, lane l taking sample 32 k + l, so that every load
// and the weights' store are coalesced; a round's products sigma delta are
// summed by a warp scan (inclusive, by shuffles), and the scan shifted by
// one lane is the exclusive sum within the round, added to the carry of the
// rounds before (the round's total, broadcast from lane 31). Each lane keeps
// its own sums of w c, reduced across the warp at the end. Nothing goes
// through shared memory.
//
// Precision: f32 throughout, without fast math. sigma delta and w = T alpha
// are rounded as the PyTorch composite rounds them; the exclusive sum is
// associated by rounds of 32 where torch.cumsum associates by its own scan,
// and w c is summed per lane, then across lanes: only the order of the f32
// sums differs.

#include <cuda_runtime.h>

namespace {

constexpr int kRaysPerCta = 8;

__global__ void __launch_bounds__(kRaysPerCta * 32) composite_fwd_kernel(
    const float* __restrict__ sigma, const float* __restrict__ radiance, const float* __restrict__ delta,
    float* __restrict__ rgb, float* __restrict__ weights, int rays, int samples) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kRaysPerCta + (threadIdx.x >> 5);
  if (ray >= rays) return;
  const size_t base = static_cast<size_t>(ray) * samples;
  float carry = 0.0f;  // sum of sigma delta over the rounds before
  float r = 0.0f, g = 0.0f, b = 0.0f;
  for (int first = 0; first < samples; first += 32) {
    const int i = first + lane;
    const bool in = i < samples;
    const float sd = in ? __fmul_rn(sigma[base + i], delta[base + i]) : 0.0f;
    float incl = sd;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = __fadd_rn(incl, v);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    excl = lane == 0 ? carry : __fadd_rn(carry, excl);
    carry = __fadd_rn(carry, __shfl_sync(0xffffffffu, incl, 31));
    if (in) {
      const float w = __fmul_rn(expf(-excl), __fsub_rn(1.0f, expf(-sd)));
      weights[base + i] = w;
      const float* c = radiance + 3 * (base + i);
      r = __fadd_rn(r, __fmul_rn(w, c[0]));
      g = __fadd_rn(g, __fmul_rn(w, c[1]));
      b = __fadd_rn(b, __fmul_rn(w, c[2]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, off));
    g = __fadd_rn(g, __shfl_xor_sync(0xffffffffu, g, off));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, off));
  }
  if (lane == 0) {
    rgb[3 * ray] = r;
    rgb[3 * ray + 1] = g;
    rgb[3 * ray + 2] = b;
  }
}

}  // namespace

extern "C" {

const char* composite_fwd_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// rgb (rays, 3) and weights (rays, samples) of sigma (rays, samples),
// radiance (rays, samples, 3) and delta (rays, samples), all f32 and
// contiguous. Launches on `stream`; returns the launch's cudaError_t (0 on
// success).
int composite_fwd(const float* sigma, const float* radiance, const float* delta, float* rgb, float* weights,
                  int rays, int samples, void* stream) {
  if (rays <= 0 || samples <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ctas = (rays + kRaysPerCta - 1) / kRaysPerCta;
  composite_fwd_kernel<<<ctas, kRaysPerCta * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      sigma, radiance, delta, rgb, weights, rays, samples);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
