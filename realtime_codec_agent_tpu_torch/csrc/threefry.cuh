// JAX's threefry noise of one sampler step, as device functions: kernel S1's
// noise (csrc/threefry.cu) and the draw of the whole sampler (csrc/sampler.cu)
// share them.
//
// noise[i] = -log(-log(u[i])), u the uniform(minval=tiny, maxval=1) draw of
// jax.random for the key fold_in((seed_hi, seed_lo), step) and element i. The
// threefry2x32 hash, the counter layout (fold_in hashes (0, step); element i
// hashes (0, i) and takes bits1 ^ bits2) and the mantissa trick follow
// jax/_src/prng.py and jax/_src/random.py; ops/sampling.py's plain version
// cites the lines.
#pragma once

#include <stdint.h>

namespace rtca_threefry {

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

// the step: step_kind 0 takes step_host, 1 an int32 and 2 an int64 at
// step_ptr on the device (its low 32 bits)
__device__ __forceinline__ uint32_t read_step(const void* step_ptr, int step_kind, uint32_t step_host) {
  if (step_kind == 1) return (uint32_t)*static_cast<const int32_t*>(step_ptr);
  if (step_kind == 2) return (uint32_t)*static_cast<const int64_t*>(step_ptr);
  return step_host;
}

// fold_in((seed_hi, seed_lo), step): the key hashes the counter (0, step)
__device__ __forceinline__ void fold_in(uint32_t seed_hi, uint32_t seed_lo, uint32_t step, uint32_t& key0,
                                        uint32_t& key1) {
  key0 = 0;
  key1 = step;
  threefry2x32(seed_hi, seed_lo, key0, key1);
}

// uniform(minval=tiny, maxval=1) of element i under the key
__device__ __forceinline__ float uniform(uint32_t key0, uint32_t key1, uint32_t i) {
  uint32_t b0 = 0, b1 = i;  // element i: counter (0, i)
  threefry2x32(key0, key1, b0, b1);
  const uint32_t bits = b0 ^ b1;
  const float tiny = 1.17549435e-38f;  // FLT_MIN, jnp.finfo(float32).tiny
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(tiny, __fadd_rn(__fmul_rn(f, 1.0f - tiny), tiny));
}

// gumbel "low": -log(-log(u)), full-precision logf as torch.log computes it
__device__ __forceinline__ float gumbel(float u) { return -logf(-logf(u)); }

}  // namespace rtca_threefry
