// JAX's Gumbel noise of one sampler step, on the card (kernel S1's noise-only
// entry).
//
// Not a Pallas kernel: it replaces what XLA computes for
// jax.random.categorical's draw in the JAX sampler
// (realtime_codec_agent_tpu/ops/sampling.py:161, keyed by
// fold_in(PRNGKey(seed), step) at realtime_codec_agent_tpu/lm/engine.py:308,
// :410 and lm/duplex_session.py:304): noise[i] = -log(-log(u[i])), u the
// uniform(minval=tiny, maxval=1) draw of jax.random for the key
// fold_in((seed_hi, seed_lo), step) and element i (csrc/threefry.cuh holds
// the hash and the draw; csrc/sampler.cu, the whole draw in one launch,
// computes the same noise in its own registers).
//
// What bounds it on the card: nothing at these sizes (k <= 1,024 floats out,
// ~200 integer operations per element): it is one launch. The step is a host
// value or one int32/int64 on the device (read by each thread), so a captured
// CUDA graph can advance it without a host round trip.
//
// Design: one thread per element, blocks of 256; every thread hashes the
// fold_in key itself (20 rounds, cheaper than sharing it through shared
// memory and a barrier).
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) threefry_gumbel_kernel(uint32_t seed_hi, uint32_t seed_lo,
                                                                   const void* step_ptr, int step_kind,
                                                                   uint32_t step_host, int k, float* u_out,
                                                                   float* g_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= k) return;
  uint32_t key0, key1;
  rtca_threefry::fold_in(seed_hi, seed_lo, rtca_threefry::read_step(step_ptr, step_kind, step_host), key0, key1);
  const float u = rtca_threefry::uniform(key0, key1, (uint32_t)i);
  if (u_out != nullptr) u_out[i] = u;
  g_out[i] = rtca_threefry::gumbel(u);
}

}  // namespace

// noise (k,) f32 and, when u_out is not null, the uniform draws (k,) f32 for
// the key (seed_hi, seed_lo) folded with step: step_kind 0 takes step_host,
// 1 an int32 and 2 an int64 at step_ptr on the device (its low 32 bits).
extern "C" int rtca_threefry_gumbel(uint32_t seed_hi, uint32_t seed_lo, const void* step_ptr, int step_kind,
                                    uint32_t step_host, int k, float* u_out, float* g_out, void* stream) {
  if (k < 1 || step_kind < 0 || step_kind > 2 || (step_kind != 0 && step_ptr == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  threefry_gumbel_kernel<<<(k + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seed_hi, seed_lo, step_ptr, step_kind, step_host, k, u_out, g_out);
  return (int)cudaGetLastError();
}
