// Weight-only int8 matmul for decode-shaped rows (kernel B2).
//
// Replaces the Pallas TPU kernel realtime_codec_agent_tpu/ops/int8_matmul.py
// (int8_matmul -> _kernel): y (T, N) f32 = (bf16(x) @ bf16(W_int8)) * s,
// f32 accumulation, per-output-channel scale s. T <= 8 rows (the frame scan
// runs T = 3; the lm_head 1-2).
//
// What bounds it on the card: with T <= 8 every weight byte is used T times,
// so the kernel is bound by reading the (K, N) int8 weights (1 byte each),
// e.g. 532 MB for the lm_head, 33 MB for one layer -- nothing is reused.
//
// Design: a thread owns 16 adjacent output columns and reads W one 16-byte
// vector per K row, so a warp reads 512 contiguous bytes of a row
// (coalesced). Activations are rounded to bf16 (the TPU kernel's rounding),
// then widened to f32; bf16 * int8 products are exact in f32. A block's 8
// warps take disjoint K ranges of the same 512 columns and are summed in
// shared memory in a fixed order. Shapes whose column tiles alone cannot fill
// the card (wo and down: N = 2048 -> 4 tiles) are also split over K across
// blocks; the partial sums go to a workspace and a second kernel adds them
// in split order and applies the scale -- deterministic, no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 16;                 // int8 columns per thread = one 16-byte load
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileN = 32 * kCols;        // 512 columns per block

template <int T>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out,
    float* __restrict__ partial, int K, int N, int k_per_split, int rows_per_warp) {
  __shared__ float red[T][kTileN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = blockIdx.y;
  const int n0 = blockIdx.x * kTileN + lane * kCols;
  const int k_split_end = min((split + 1) * k_per_split, K);
  const int k_begin = split * k_per_split + warp * rows_per_warp;
  const int k_end = min(k_begin + rows_per_warp, k_split_end);

  float acc[T][kCols];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[t][j] = 0.0f;

  if (n0 < N) {
#pragma unroll 4
    for (int k = k_begin; k < k_end; ++k) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(w + (size_t)k * N + n0));
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
      float wf[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) wf[j] = (float)b[j];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float xv = __bfloat162float(x[(size_t)t * K + k]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[t][j] = fmaf(xv, wf[j], acc[t][j]);
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
      out[(size_t)t * N + n] = red[t][c] * scale[n];
    }
  }
}

__global__ void int8_matmul_reduce_kernel(const float* __restrict__ partial,
                                          const float* __restrict__ scale,
                                          float* __restrict__ out, int splits, int T, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T * N) return;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * T * N + i];
  out[i] = s * scale[i % N];
}

template <int T>
void launch(const __nv_bfloat16* x, const int8_t* w, const float* scale, float* out,
            float* partial, int K, int N, int splits, cudaStream_t s) {
  const int k_per_split = (K + splits - 1) / splits;
  const int rows_per_warp = (k_per_split + kWarps - 1) / kWarps;
  const dim3 grid((N + kTileN - 1) / kTileN, splits);
  int8_matmul_kernel<T><<<grid, kThreads, 0, s>>>(
      x, w, scale, out, splits > 1 ? partial : nullptr, K, N, k_per_split, rows_per_warp);
  if (splits > 1) {
    const int total = T * N;
    int8_matmul_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(partial, scale, out,
                                                                  splits, T, N);
  }
}

}  // namespace

// x (t, k) bf16, w (k, n) int8, scale (n,) f32 -> out (t, n) f32.
// partial is (splits, t, n) f32 scratch, unused when splits == 1.
// Requires 1 <= t <= 8, n % 16 == 0 and 16-byte aligned w.
extern "C" int rtca_int8_matmul(const void* x, const void* w, const float* scale, float* out,
                                float* partial, int t, int k, int n, int splits,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  switch (t) {
    case 1: launch<1>(xb, wq, scale, out, partial, k, n, splits, s); break;
    case 2: launch<2>(xb, wq, scale, out, partial, k, n, splits, s); break;
    case 3: launch<3>(xb, wq, scale, out, partial, k, n, splits, s); break;
    case 4: launch<4>(xb, wq, scale, out, partial, k, n, splits, s); break;
    case 5: launch<5>(xb, wq, scale, out, partial, k, n, splits, s); break;
    case 6: launch<6>(xb, wq, scale, out, partial, k, n, splits, s); break;
    case 7: launch<7>(xb, wq, scale, out, partial, k, n, splits, s); break;
    case 8: launch<8>(xb, wq, scale, out, partial, k, n, splits, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
