// Affine int4 weight matmul for decode-shaped rows (kernel B5).
//
// Replaces the Pallas TPU kernel realtime_codec_agent_tpu/ops/int4_matmul.py
// (int4_matmul -> _kernel_split / _kernel): y (T, N) f32 = bf16(x) @ W, where
// W[k, n] = bf16(fma(q[k, n], d[k / 32, n], -m[k / 32, n])), q in [0, 15],
// f32 products and sums. T <= 8 rows (the frame scan runs T = 3,
// generate_until T = 1).
//
// Leaf layout: q4 uint8 (K/2, N), d and m f32 (K/32, N). Group-contiguous
// halves: byte row g*16 + j holds K row g*32 + j in its low nibble and K row
// g*32 + 16 + j in its high nibble.
//
// What bounds it on the card: at T <= 8 every weight is used T times, so the
// kernel is bound by reading the leaf: half a byte of nibbles per weight plus
// 8 bytes of d/m per group of 32 (0.75 B per weight against int8's 1).
// This simple version is far from that bound at the layer shapes (PERF.md):
// with whole-group warp ranges, N = 2048 gives 32 blocks for 132 SMs, and
// each warp runs ~17 instructions per column and byte row of dequantization
// and products; issuing more loads at once did not help.
//
// Design (kernel B2's, csrc/int8_matmul.cu): a thread owns 16 adjacent
// output columns and reads one 16-byte vector of q4 per byte row, so a warp
// reads 512 contiguous bytes of a row; each vector gives two K rows (low and
// high nibbles). d and m are loaded once per group (16 byte rows). The TPU
// kernel's split of x into the two halves of each group is two register
// indices here. A block's 8 warps take disjoint whole-group K ranges of the
// same 512 columns and are summed in shared memory in a fixed order. Shapes
// whose column tiles alone cannot fill the card are also split over K
// across blocks, again on whole groups; the partial sums go to a workspace
// that a second kernel adds in split order -- deterministic, no atomics.
//
// Any N: when N % 16 != 0 the rows of q4, d and m are not 16-byte aligned,
// so the kVec = false instantiation reads a thread's 16 columns of q4 as
// single bytes and its d and m as single floats, the columns past N as 0;
// tiling, products and the fixed-order sums stay, and so does repeatability.
// The dequant kernel has a scalar twin for such N (one thread per byte).
//
// Calls wider than 8 rows (prefill, scoring, recompute) take the dequant
// route of ops/nn.qdot instead: int4_dequant_kernel writes the same bf16
// weights as a (K, N) tensor for a dense matmul, the counterpart of the XLA
// dequantization (realtime_codec_agent_tpu/ops/int4_matmul.py dequant_int4).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 16;                 // columns per thread = one 16-byte load of q4
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileN = 32 * kCols;        // 512 columns per block
constexpr int kGroup = 32;                // K rows per (d, m) pair
constexpr int kHalf = kGroup / 2;         // byte rows per group

// A nibble (0..15) as float, exactly, with full-rate integer and add
// instructions instead of an int-to-float conversion: 2^23 + v - 2^23.
__device__ __forceinline__ float nibble_to_float(int v) {
  return __int_as_float(0x4B000000 | v) - 8388608.0f;
}

__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 a = __ldg(v + i);
    dst[4 * i] = a.x;
    dst[4 * i + 1] = a.y;
    dst[4 * i + 2] = a.z;
    dst[4 * i + 3] = a.w;
  }
}

// 16 floats of a d or m row from column n0: one 16-byte load each of four
// vectors, or (kVec = false) single loads with the columns past N as 0
template <bool kVec>
__device__ __forceinline__ void load_cols(const float* p, int n0, int N, float* dst) {
  if (kVec) {
    load16(p + n0, dst);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[c] = n0 + c < N ? __ldg(p + n0 + c) : 0.0f;
  }
}

template <int T, bool kVec>
__global__ void __launch_bounds__(kThreads) int4_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q4,
    const float* __restrict__ d, const float* __restrict__ m, float* __restrict__ out,
    float* __restrict__ partial, int K, int N, int groups_per_split, int groups_per_warp) {
  __shared__ float red[T][kTileN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = blockIdx.y;
  const int n0 = blockIdx.x * kTileN + lane * kCols;
  const int groups = K / kGroup;
  const int g_split_end = min((split + 1) * groups_per_split, groups);
  const int g_begin = split * groups_per_split + warp * groups_per_warp;
  const int g_end = min(g_begin + groups_per_warp, g_split_end);

  float acc[T][kCols];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[t][j] = 0.0f;

  if (n0 < N) {
    for (int g = g_begin; g < g_end; ++g) {
      float dg[kCols], mg[kCols];
      load_cols<kVec>(d + (size_t)g * N, n0, N, dg);
      load_cols<kVec>(m + (size_t)g * N, n0, N, mg);
      const uint8_t* rows = q4 + (size_t)g * kHalf * N + n0;
      const int k_lo = g * kGroup;
#pragma unroll 2
      for (int j = 0; j < kHalf; ++j) {
        alignas(16) uint8_t b[kCols];
        if (kVec) {
          *reinterpret_cast<int4*>(b) = __ldg(reinterpret_cast<const int4*>(rows + (size_t)j * N));
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) b[c] = n0 + c < N ? __ldg(rows + (size_t)j * N + c) : 0;
        }
        float w_lo[kCols], w_hi[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          // both weights of the byte rounded to bf16 (RNE) by one packed conversion
          const int v = (int)b[c];
          const __nv_bfloat162 w2 = __floats2bfloat162_rn(fmaf(nibble_to_float(v & 15), dg[c], -mg[c]),
                                                          fmaf(nibble_to_float(v >> 4), dg[c], -mg[c]));
          w_lo[c] = __low2float(w2);
          w_hi[c] = __high2float(w2);
        }
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const float x_lo = __bfloat162float(x[(size_t)t * K + k_lo + j]);
          const float x_hi = __bfloat162float(x[(size_t)t * K + k_lo + kHalf + j]);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[t][c] = fmaf(x_lo, w_lo[c], acc[t][c]);
            acc[t][c] = fmaf(x_hi, w_hi[c], acc[t][c]);
          }
        }
      }
    }
  }

  // fixed-order reduction of the 8 warps' K ranges
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = lane * kCols + j;
          red[t][c] = (wi == 0 ? 0.0f : red[t][c]) + acc[t][j];
        }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < T * kTileN; i += kThreads) {
    const int t = i / kTileN;
    const int c = i % kTileN;
    const int n = blockIdx.x * kTileN + c;
    if (n >= N) continue;
    if (partial != nullptr) {
      partial[((size_t)split * T + t) * N + n] = red[t][c];
    } else {
      out[(size_t)t * N + n] = red[t][c];
    }
  }
}

__global__ void int4_matmul_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                          int splits, int T, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T * N) return;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * T * N + i];
  out[i] = s;
}

// out (K, N) bf16, out[k, n] = bf16(fma(q[k, n], d[k / 32, n], -m[k / 32, n])),
// the weights int4_matmul_kernel multiplies by. A thread owns 8 adjacent
// columns of one byte row: one 8-byte load of q4, 8 values each of d and m,
// and two 16-byte stores, to the K rows of the low and of the high nibbles.
__global__ void int4_dequant_kernel(const uint8_t* __restrict__ q4, const float* __restrict__ d,
                                    const float* __restrict__ m, __nv_bfloat16* __restrict__ out, int K, int N) {
  const int cols8 = N / 8;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)(K / 2) * cols8) return;
  const int r = (int)(i / cols8);
  const int n0 = (int)(i % cols8) * 8;
  const int g = r / kHalf;
  const int k_lo = g * kGroup + r % kHalf;
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(q4 + (size_t)r * N + n0));
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
  const float4* dv = reinterpret_cast<const float4*>(d + (size_t)g * N + n0);
  const float4* mv = reinterpret_cast<const float4*>(m + (size_t)g * N + n0);
  const float4 d0 = __ldg(dv), d1 = __ldg(dv + 1), m0 = __ldg(mv), m1 = __ldg(mv + 1);
  const float dg[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
  const float mg[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
  __align__(16) __nv_bfloat16 lo[8];
  __align__(16) __nv_bfloat16 hi[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int v = (int)b[c];
    const __nv_bfloat162 w2 = __floats2bfloat162_rn(fmaf(nibble_to_float(v & 15), dg[c], -mg[c]),
                                                    fmaf(nibble_to_float(v >> 4), dg[c], -mg[c]));
    lo[c] = __low2bfloat16(w2);
    hi[c] = __high2bfloat16(w2);
  }
  *reinterpret_cast<uint4*>(out + (size_t)k_lo * N + n0) = *reinterpret_cast<const uint4*>(lo);
  *reinterpret_cast<uint4*>(out + (size_t)(k_lo + kHalf) * N + n0) = *reinterpret_cast<const uint4*>(hi);
}

// the same weights for any N: one thread per byte of q4 (a column of one
// byte row), scalar loads and two 2-byte stores
__global__ void int4_dequant_scalar_kernel(const uint8_t* __restrict__ q4, const float* __restrict__ d,
                                           const float* __restrict__ m, __nv_bfloat16* __restrict__ out, int K,
                                           int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)(K / 2) * N) return;
  const int r = (int)(i / N);
  const int n = (int)(i % N);
  const int g = r / kHalf;
  const int k_lo = g * kGroup + r % kHalf;
  const int v = (int)__ldg(q4 + i);
  const float dg = __ldg(d + (size_t)g * N + n);
  const float mg = __ldg(m + (size_t)g * N + n);
  const __nv_bfloat162 w2 = __floats2bfloat162_rn(fmaf(nibble_to_float(v & 15), dg, -mg),
                                                  fmaf(nibble_to_float(v >> 4), dg, -mg));
  out[(size_t)k_lo * N + n] = __low2bfloat16(w2);
  out[(size_t)(k_lo + kHalf) * N + n] = __high2bfloat16(w2);
}

template <int T>
void launch(const __nv_bfloat16* x, const uint8_t* q4, const float* d, const float* m, float* out,
            float* partial, int K, int N, int splits, cudaStream_t s) {
  const int groups = K / kGroup;
  const int groups_per_split = (groups + splits - 1) / splits;
  const int groups_per_warp = (groups_per_split + kWarps - 1) / kWarps;
  const dim3 grid((N + kTileN - 1) / kTileN, splits);
  float* part = splits > 1 ? partial : nullptr;
  if (N % kCols == 0) {
    int4_matmul_kernel<T, true><<<grid, kThreads, 0, s>>>(x, q4, d, m, out, part, K, N, groups_per_split,
                                                          groups_per_warp);
  } else {
    int4_matmul_kernel<T, false><<<grid, kThreads, 0, s>>>(x, q4, d, m, out, part, K, N, groups_per_split,
                                                           groups_per_warp);
  }
  if (splits > 1) {
    const int total = T * N;
    int4_matmul_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(partial, out, splits, T, N);
  }
}

}  // namespace

// x (t, k) bf16, q4 (k/2, n) uint8, d and m (k/32, n) f32 -> out (t, n) f32.
// partial is (splits, t, n) f32 scratch, unused when splits == 1; every split
// must hold at least one group (ops/int4_matmul.k_splits).
// Requires 1 <= t <= 8, k % 32 == 0, n >= 1 and 16-byte aligned q4, d, m.
extern "C" int rtca_int4_matmul(const void* x, const void* q4, const float* d, const float* m, float* out,
                                float* partial, int t, int k, int n, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* w = static_cast<const uint8_t*>(q4);
  if (k % kGroup != 0 || n < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  switch (t) {
    case 1: launch<1>(xb, w, d, m, out, partial, k, n, splits, s); break;
    case 2: launch<2>(xb, w, d, m, out, partial, k, n, splits, s); break;
    case 3: launch<3>(xb, w, d, m, out, partial, k, n, splits, s); break;
    case 4: launch<4>(xb, w, d, m, out, partial, k, n, splits, s); break;
    case 5: launch<5>(xb, w, d, m, out, partial, k, n, splits, s); break;
    case 6: launch<6>(xb, w, d, m, out, partial, k, n, splits, s); break;
    case 7: launch<7>(xb, w, d, m, out, partial, k, n, splits, s); break;
    case 8: launch<8>(xb, w, d, m, out, partial, k, n, splits, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// q4 (k/2, n) uint8, d and m (k/32, n) f32 -> out (k, n) bf16.
// Requires k % 32 == 0 and 16-byte aligned q4, d, m and out; n % 16 == 0
// takes the vector kernel, any other n the scalar one.
extern "C" int rtca_int4_dequant(const void* q4, const float* d, const float* m, void* out, int k, int n,
                                 void* stream) {
  if (k % kGroup != 0 || n < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* w = static_cast<const uint8_t*>(q4);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const bool vec = n % kCols == 0;
  const size_t threads = (size_t)(k / 2) * (vec ? n / 8 : n);
  if (threads == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  if (vec) {
    int4_dequant_kernel<<<blocks, 256, 0, s>>>(w, d, m, o, k, n);
  } else {
    int4_dequant_scalar_kernel<<<blocks, 256, 0, s>>>(w, d, m, o, k, n);
  }
  return (int)cudaGetLastError();
}
