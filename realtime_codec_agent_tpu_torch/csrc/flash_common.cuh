// Helpers of kernel B4: the tile constants and the key-validity bitmask,
// shared by the forward (flash_attention.cu, and the f32 instantiation in
// flash_attention_f32.cu) and the backward (flash_attention_bwd.cu). The
// Hopper machinery (TMA, wgmma) is in wgmma_common.cuh, the bf16 packing in
// mma_sync.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kTile = 64;  // query rows per block, keys per tile
constexpr int kWarps = 4;  // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;

// key validity of keys key0 .. key0 + 63 of batch row b as a 64-bit mask in
// two words of shared memory: bit i set iff key0 + i < T and (valid is null
// or valid[b, key0 + i] != 0). Threads 0..63 (two whole warps) take part;
// read it after a barrier with live_mask().
__device__ __forceinline__ void load_live(uint32_t* dst, const uint8_t* valid, int b, int T,
                                          int key0) {
  if (threadIdx.x < kTile) {
    const int key = key0 + threadIdx.x;
    const bool live = key < T && (valid == nullptr || valid[(size_t)b * T + key] != 0);
    const uint32_t word = __ballot_sync(0xffffffffu, live);
    if ((threadIdx.x & 31) == 0) dst[threadIdx.x >> 5] = word;
  }
}

__device__ __forceinline__ uint64_t live_mask(const uint32_t* src) {
  return (uint64_t)src[0] | ((uint64_t)src[1] << 32);
}

__device__ __forceinline__ bool bit(uint64_t mask, int i) { return (mask >> i) & 1u; }

constexpr uint64_t kAllLive = ~0ull;

// the 16 bits of a tile's key mask that a thread's accumulator columns hold:
// bit 2j + c is column 8j + 2 t4 + c (n-tile j, element c)
__device__ __forceinline__ uint32_t thread_bits(uint64_t mask, int t4) {
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) mine |= (uint32_t)((mask >> (8 * j + 2 * t4)) & 3u) << (2 * j);
  return mine;
}

// is accumulator element (j, e) of this thread in thread_bits()' mask?
__device__ __forceinline__ bool col_bit(uint32_t mine, int j, int e) {
  return (mine >> (2 * j + (e & 1))) & 1u;
}

}  // namespace
