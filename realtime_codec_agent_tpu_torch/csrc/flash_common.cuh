// Helpers of kernel B4: the tile constants and the key-validity bitmask are
// shared by the forward (flash_attention.cu, wgmma at head dim 64 and 128)
// and the backward (flash_attention_bwd.cu); the padded shared-memory tiles
// (head dim 64) are the backward's. The bf16 packing and mma.sync helpers
// are in mma_sync.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kDh = 64;
constexpr int kTile = 64;      // query rows per block, keys per tile
constexpr int kWarps = 4;      // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kRow = kDh + 8;  // bf16 per shared-memory row: the pad spreads banks
constexpr float kNeg = -1e30f;

// rows of 64 bf16 -> shared memory, 16 bytes a thread of a kThreads block;
// rows >= n_rows are zero
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kRow], const __nv_bfloat16* src,
                                          size_t row_stride, int row0, int n_rows) {
#pragma unroll
  for (int i = threadIdx.x; i < kTile * (kDh / 8); i += kThreads) {
    const int r = i / (kDh / 8);
    const int c = (i % (kDh / 8)) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < n_rows) {
      val = __ldg(reinterpret_cast<const int4*>(src + (size_t)(row0 + r) * row_stride + c));
    }
    *reinterpret_cast<int4*>(&dst[r][c]) = val;
  }
}

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

// the A fragments (16 rows x 64 columns, 4 k-steps) of rows r0 and r0 + 8 of
// a shared tile
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4], const __nv_bfloat16 (*src)[kRow],
                                             int r0, int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = *reinterpret_cast<const uint32_t*>(&src[r0][16 * kk + 2 * t4]);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(&src[r0 + 8][16 * kk + 2 * t4]);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(&src[r0][16 * kk + 8 + 2 * t4]);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(&src[r0 + 8][16 * kk + 8 + 2 * t4]);
  }
}

// acc (16 x 64, per warp) += A (16 x 64) * X^T, where X is a shared tile of
// 64 rows x 64: the n-tile j of the result reads rows 8j .. 8j + 7 of X, the
// B operand as contiguous pairs
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                        const __nv_bfloat16 (*x)[kRow], int g, int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&x[8 * j + g][16 * kk + 2 * t4]);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&x[8 * j + g][16 * kk + 8 + 2 * t4]);
      mma_bf16(acc[j], a[kk], b0, b1);
    }
  }
}

// acc (16 x 64, per warp) += P (16 x 64, held as f32 accumulators and rounded
// to bf16 here) * X, where X is a shared tile of 64 rows (the k index) x 64:
// the accumulator layout of P is the A operand layout, and X is read as
// scalar pairs (conflict-free with the padded rows)
__device__ __forceinline__ void mma_pb(float (&acc)[8][4], const float (&p)[8][4],
                                       const __nv_bfloat16 (*x)[kRow], int g, int t4) {
  const uint16_t* xu = reinterpret_cast<const uint16_t*>(&x[0][0]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {
        pack_f32(p[2 * kk][0], p[2 * kk][1]), pack_f32(p[2 * kk][2], p[2 * kk][3]),
        pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]), pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const int ka = 16 * kk + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 8 * j + g;
      const uint32_t b0 = pack_raw(xu[ka * kRow + d], xu[(ka + 1) * kRow + d]);
      const uint32_t b1 = pack_raw(xu[(ka + 8) * kRow + d], xu[(ka + 9) * kRow + d]);
      mma_bf16(acc[j], pa, b0, b1);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
}

// rows r (i = 0) and r + 8 (i = 1) of a warp's 16 x 64 accumulator, rounded
// to bf16, to dst_row(i) (64 contiguous bf16)
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const float (&acc)[8][4], int i,
                                          int t4, float mul) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) =
        pack_f32(acc[j][2 * i] * mul, acc[j][2 * i + 1] * mul);
  }
}

}  // namespace
