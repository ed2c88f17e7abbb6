// The register-tiled SIMT machinery of kernel B4's f32 kernels
// (flash_attention_f32.cu: the forward; flash_attention_bwd_f32.cu: dq and
// dk/dv): every product runs on the f32 units as FFMA, never on the tensor
// cores (no TF32 rounding anywhere: this is the token-exact path).
//
// A block is 256 threads on a 64 x 64 score tile. Thread t is (ty, tx) in
// a 16 x 16 grid (simt_ty, simt_tx): it owns score rows ty + 16a and
// columns tx + 16c (a, c in 0..3), a 4 x 4 sub-tile, and of a 64 x Dh
// output tile the same four rows and the float4 columns tx + 16e (e < Dh /
// 64). A warp is 4 ty by 8 tx: each shared-memory load of a warp reads at
// most 8 distinct 16-byte words, so no load conflicts; the 16 threads that
// share a score row are two groups of 8 lanes in two warps, so the
// forward's row max is three xor shuffles and one exchange through shared
// memory (the backward kernels reduce nothing in their loops).
//
// Tiles in shared memory are row-major with rows padded to Dh + 4 floats
// (kLd): the 8 distinct rows a warp reads at one offset land on 8 distinct
// float4 bank groups. The products:
//   dot_tile: C[4][4] += A-rows . B-rows, both operands read along the
//     reduction dim (d) as float4: 4 + 4 LDS.128 for 64 FFMA (S = Q K^T,
//     dP = dO V^T and, in dk/dv, S^T = K Q^T, dP^T = V dO^T: both
//     operands are the staged tiles as they are).
//   acc_tile: C[4][Dh/64] (float4s) += P . B, P read along its reduction
//     dim (the score tile's columns) as float4 and B along its output dim:
//     4 + 4 Dh/64 LDS.128 for 64 Dh/64 FFMA. P (and dS) is the transposed
//     operand of the pair: it is written to shared memory by the threads
//     that computed it, row-major [output row][reduction index], with
//     rows kLdP = 72 floats apart so that a warp's 32 scalar stores (4 rows
//     x 8 columns) hit 32 banks; dk/dv computes S^T (keys as rows) for that
//     reason, so that P^T and dS^T land key-major for dV += P^T dO and dK +=
//     dS^T Q.
// 8 FFMA per shared-memory load instruction in every product (10.7 in
// acc_tile at Dh 128), against 4 in the scalar kernels before. What the
// card showed (PERF.md's findings): a 2 x 16 warp layout (two wavefronts a
// B load) runs as fast, and 8 x 4 sub-tiles on 128 threads (fewer loads a
// FFMA, half the warps) run slower; unrolling the products whole and one
// MUFU.EX2 a probability are what gained.
//
// Staging: cp.async 16-byte copies (cp.async.cg, rows past T zero-filled),
// two stages: the tile after the current one is in flight while the
// current one is computed.
#pragma once

#include "flash_common.cuh"

namespace {

// the softmax's exponentials: 2^x of x pre-scaled by log2 e, folded into the
// score scale (one MUFU.EX2, where expf adds the argument's split and range
// fix-ups)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x in one MUFU.EX2 (results below 2^-126 flush to 0: they are below any
// f32 sum of a row that holds its max, exp(0) = 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P = exp(s scale - lse) from a raw dot product s
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  return ex2(fmaf(s, scale * kLog2e, -lse * kLog2e));
}

// bit c of the result: column tx + 16c of a 64-key tile is set in `live`
__device__ __forceinline__ uint32_t col_bits(uint64_t live, int tx) {
  const uint64_t b = live >> tx;
  return (uint32_t)(b & 1u) | (uint32_t)((b >> 15) & 2u) | (uint32_t)((b >> 30) & 4u) | (uint32_t)((b >> 45) & 8u);
}

// the causal diagonal of a tile whose rows and columns start at the same
// position: clear bit 4a + c of `on` where key > query, with rows ty + 16a
// the queries and columns tx + 16c the keys, or (kKeyRows: dk/dv's S^T)
// the other way round
template <bool kKeyRows>
__device__ __forceinline__ uint32_t causal_bits(uint32_t on, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = ty + 16 * a, col = tx + 16 * c;
      if (kKeyRows ? row > col : col > row) on &= ~(1u << (4 * a + c));
    }
  return on;
}

__device__ __forceinline__ bool on_bit(uint32_t on, int a, int c) { return (on >> (4 * a + c)) & 1u; }

constexpr int kSimtThreads = 256;
constexpr int kLdP = kTile + 8;  // row pitch of the P / dS tile (floats)

// thread t's place in the 16 x 16 grid: warp w holds ty 4 (w / 2) .. + 3 and
// tx 8 (w % 2) .. + 7, lane 8 ty' + tx'
__device__ __forceinline__ int simt_ty() { return 4 * (threadIdx.x >> 6) + ((threadIdx.x >> 3) & 3); }
__device__ __forceinline__ int simt_tx() { return 8 * ((threadIdx.x >> 5) & 1) + (threadIdx.x & 7); }

template <int kD>
struct SimtTile {
  static constexpr int kLd = kD + 4;              // row pitch of a staged tile (floats)
  static constexpr int kFloats = kTile * kLd;     // one staged 64-row tile
  static constexpr int kE = kD / 64;              // output float4s a thread, per row
  static constexpr int kPFloats = kTile * kLdP;   // the P / dS tile
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// rows row0 .. row0 + 63 of a (B, T, heads, kD) f32 tensor (``src``: the
// head's first element of the batch row) into a padded tile, zeros past T;
// consecutive threads copy consecutive 16-byte chunks of a row
template <int kD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int row0, int T, size_t row_stride) {
  constexpr int kC = kD / 4;
#pragma unroll
  for (int n = 0; n < kTile * kC / kSimtThreads; ++n) {
    const int idx = (int)threadIdx.x + n * kSimtThreads;
    const int r = idx / kC, c = idx % kC;
    const bool in = row0 + r < T;
    cp_async16(dst + r * SimtTile<kD>::kLd + 4 * c, src + (size_t)(in ? row0 + r : 0) * row_stride + 4 * c, in);
  }
}

// is key ``key`` of batch row b live (inside T, and valid where given)?
__device__ __forceinline__ bool key_live(const uint8_t* valid, int b, int T, int key) {
  return key < T && (valid == nullptr || valid[(size_t)b * T + key] != 0);
}

// the 64-bit key mask of a tile from ``live`` (threads 0..63, one key each):
// warps 0 and 1 ballot it into dst[0..1]; read after a barrier (live_mask)
__device__ __forceinline__ void store_live(uint32_t* dst, bool live) {
  if (threadIdx.x < kTile) {
    const uint32_t word = __ballot_sync(0xffffffffu, live);
    if ((threadIdx.x & 31) == 0) dst[threadIdx.x >> 5] = word;
  }
}

// the max / sum over the 8 lanes of a warp that share a score row (the
// row's other 8 threads are in the neighbouring warp)
__device__ __forceinline__ float lanes_max8(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float lanes_sum8(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void fma4(float a, const float4& x, float4& acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// c[a][j] += sum_d A[ty + 16a][d] B[tx + 16j][d] over the kD dims, the
// loop unrolled kU deep
template <int kD, int kU = kD / 4>
__device__ __forceinline__ void dot_tile(float (&c)[4][4], const float* sA, const float* sB, int ty, int tx) {
  constexpr int kLd = SimtTile<kD>::kLd;
  const float* a0 = sA + ty * kLd;
  const float* b0 = sB + tx * kLd;
#pragma unroll(kU)
  for (int d = 0; d < kD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(a0 + 16 * i * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(b0 + 16 * j * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = dot4(a[i], b[j], c[i][j]);
  }
}

// acc[a][e] += sum_j P[ty + 16a][j] B[j][4 (tx + 16e) ..] over the tile's
// 64 columns j (P: pitch kLdP; B: a staged tile), the loop unrolled kU deep
template <int kD, int kU = kTile / 4>
__device__ __forceinline__ void acc_tile(float4 (&acc)[4][SimtTile<kD>::kE], const float* sP, const float* sB, int ty,
                                         int tx) {
  constexpr int kLd = SimtTile<kD>::kLd;
  constexpr int kE = SimtTile<kD>::kE;
  const float* p0 = sP + ty * kLdP;
  const float* b0 = sB + 4 * tx;
#pragma unroll(kU)
  for (int j = 0; j < kTile; j += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(p0 + 16 * i * kLdP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float4 b[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) b[e] = *reinterpret_cast<const float4*>(b0 + (j + jj) * kLd + 64 * e);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = jj == 0 ? p[i].x : jj == 1 ? p[i].y : jj == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int e = 0; e < kE; ++e) fma4(pv, b[e], acc[i][e]);
      }
    }
  }
}

// the offset of a thread's float4 e of row r in a (B, T, heads, kD)
// tensor, from the head's first element of the batch row
__device__ __forceinline__ size_t chunk_off(int r, size_t row_stride, int tx, int e) {
  return (size_t)r * row_stride + 4 * tx + 64 * e;
}

// dynamic shared memory above 48 KB, set once per kernel
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

}  // namespace
