// JAX's Gumbel noise of one sampler step, on the card (kernel S1).
//
// Not a Pallas kernel: it replaces what XLA computes for
// jax.random.categorical's draw in the JAX sampler
// (realtime_codec_agent_tpu/ops/sampling.py:161, keyed by
// fold_in(PRNGKey(seed), step) at realtime_codec_agent_tpu/lm/engine.py:308,
// :410 and lm/duplex_session.py:304): noise[i] = -log(-log(u[i])), u the
// uniform(minval=tiny, maxval=1) draw of jax.random for the key
// fold_in((seed_hi, seed_lo), step) and element i. The threefry2x32 hash, the
// counter layout (fold_in hashes (0, step); element i hashes (0, i) and takes
// bits1 ^ bits2) and the mantissa trick follow jax/_src/prng.py and
// jax/_src/random.py; ops/sampling.py's plain version cites the lines.
//
// What bounds it on the card: nothing at these sizes (k <= 1,024 floats out,
// ~200 integer operations per element): it is one launch where a host-seeded
// generator and the elementwise ops took several. The step is a host value
// or one int32/int64 on the device (read by each thread), so a captured CUDA
// graph can advance it without a host round trip.
//
// Design: one thread per element, blocks of 256; every thread hashes the
// fold_in key itself (20 rounds, cheaper than sharing it through shared
// memory and a barrier).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// threefry2x32 of (x0, x1) under the key (k0, k1), in place
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__global__ void __launch_bounds__(kThreads) threefry_gumbel_kernel(uint32_t seed_hi, uint32_t seed_lo,
                                                                   const void* step_ptr, int step_kind,
                                                                   uint32_t step_host, int k, float* u_out,
                                                                   float* g_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= k) return;
  uint32_t step = step_host;
  if (step_kind == 1) step = (uint32_t)*static_cast<const int32_t*>(step_ptr);
  if (step_kind == 2) step = (uint32_t)*static_cast<const int64_t*>(step_ptr);
  uint32_t key0 = 0, key1 = step;  // fold_in: the key hashes (0, step)
  threefry2x32(seed_hi, seed_lo, key0, key1);
  uint32_t b0 = 0, b1 = (uint32_t)i;  // element i: counter (0, i)
  threefry2x32(key0, key1, b0, b1);
  const uint32_t bits = b0 ^ b1;
  const float tiny = 1.17549435e-38f;  // FLT_MIN, jnp.finfo(float32).tiny
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float u = fmaxf(tiny, __fadd_rn(__fmul_rn(f, 1.0f - tiny), tiny));
  if (u_out != nullptr) u_out[i] = u;
  g_out[i] = -logf(-logf(u));
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
