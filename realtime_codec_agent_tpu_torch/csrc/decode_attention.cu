// GQA decode attention over the KV cache prefix, as flash partials (kernel B3).
//
// Replaces the Pallas TPU kernels realtime_codec_agent_tpu/ops/decode_attention.py
// (decode_attention_partials -> _kernel, decode_attention_partials_grid ->
// _grid_kernel): for each KV head h, the G*T query rows of that head attend the
// cache keys at index < cache_valid and return (m, l, acc): running max, softmax
// denominator and unnormalized P.V, to be merged with the small window of new
// keys by the caller (ops/decode_attention.merge_window).
//
// What bounds it on the card: G*T query rows per head (12 on the Llama-3.2-1B
// hot loop, up to 64 at Qwen2.5's small prefill buckets) against up to
// S = 14,336 keys of 64 or 128 dims -- 2 FLOPs per key byte per row, far
// below the tensor-core balance point; the time is the (K, V) bytes of the
// valid prefix.
//
// Design (split-KV flash decode): one block per (64-key chunk, KV head, group
// of up to 32 query rows); more than 32 rows take more row groups (grid z),
// each re-reading the chunk's K and V, which the L2 serves. Head dims 64 and
// 128 are two instantiations of one template; shared memory is dynamic
// (81 KB at 128 with f32 staging). A
// block whose chunk starts at or past cache_valid -- read from device memory,
// so no host sync -- returns at once: traffic scales with the valid prefix,
// not with the static cache. A live block stages its K and V tiles (bf16 ->
// f32) in shared memory, computes its rows' scores, chunk max and exp-sums
// with warp shuffles, and writes partial (m, l, acc) for the chunk. A second
// kernel combines the live chunks of each (head, row) into the (m, l, acc)
// contract of the Pallas kernel. With cache_valid == 0 it returns m = -1e30,
// l = 0, acc = 0, which the merge keeps finite. The TPU kernel's limits
// (S % 2048 == 0, <= 16 rows per head) do not apply: the last chunk masks its
// own ragged edge and any number of rows is taken.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;     // keys per block
constexpr int kMaxRows = 32;   // G*T query rows per block (grid z takes the rest)
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int kDh>
constexpr int smem_bytes() {
  return (kMaxRows * kDh + kChunk * (kDh + 1) + kChunk * kDh) * (int)sizeof(float);
}

template <int kDh, typename KV>
__global__ void __launch_bounds__(kThreads) decode_attention_partial_kernel(
    const float* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
    const int* __restrict__ cache_valid, int S, int KH, int GT, int n_chunks,
    float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc) {
  const int chunk = blockIdx.x;
  const int h = blockIdx.y;
  const int row0 = blockIdx.z * kMaxRows;  // this block's first query row
  const int rows = min(kMaxRows, GT - row0);
  const int cv = min(*cache_valid, S);
  const int c0 = chunk * kChunk;
  if (c0 >= cv) return;  // dynamic bound: nothing of this chunk is valid

  // q rows, overwritten row by row with the chunk's probabilities
  extern __shared__ float smem[];
  float(*sQP)[kDh] = reinterpret_cast<float(*)[kDh]>(smem);
  float(*sK)[kDh + 1] = reinterpret_cast<float(*)[kDh + 1]>(smem + kMaxRows * kDh);  // +1: lanes read different keys, same dim
  float(*sV)[kDh] = reinterpret_cast<float(*)[kDh]>(smem + kMaxRows * kDh + kChunk * (kDh + 1));

  for (int i = threadIdx.x; i < rows * kDh; i += kThreads) {
    sQP[i / kDh][i % kDh] = q[((size_t)h * GT + row0) * kDh + i];
  }
  constexpr int kVec = 16 / sizeof(KV);      // elements per 16-byte load
  constexpr int kVecPerKey = kDh / kVec;
  for (int i = threadIdx.x; i < kChunk * kVecPerKey; i += kThreads) {
    const int c = i / kVecPerKey;
    const int d0 = (i % kVecPerKey) * kVec;
    const int key = c0 + c;
    alignas(16) KV kb[kVec];
    alignas(16) KV vb[kVec];
    if (key < cv) {
      const size_t off = ((size_t)key * KH + h) * kDh + d0;
      *reinterpret_cast<int4*>(kb) = __ldg(reinterpret_cast<const int4*>(k + off));
      *reinterpret_cast<int4*>(vb) = __ldg(reinterpret_cast<const int4*>(v + off));
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        sK[c][d0 + e] = to_f32(kb[e]);
        sV[c][d0 + e] = to_f32(vb[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        sK[c][d0 + e] = 0.0f;
        sV[c][d0 + e] = 0.0f;
      }
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t part_row0 = ((size_t)h * n_chunks + chunk) * GT + row0;
  // warp w owns rows w, w + 8, ...; lane owns keys lane and lane + 32
  for (int r = warp; r < rows; r += kThreads / 32) {
    float s0 = 0.0f;
    float s1 = 0.0f;
#pragma unroll 16
    for (int d = 0; d < kDh; ++d) {
      const float qd = sQP[r][d];
      s0 = fmaf(qd, sK[lane][d], s0);
      s1 = fmaf(qd, sK[lane + 32][d], s1);
    }
    if (c0 + lane >= cv) s0 = kNeg;
    if (c0 + lane + 32 >= cv) s1 = kNeg;
    const float m = warp_max(fmaxf(s0, s1));  // key c0 < cv is live: m is finite
    const float p0 = expf(s0 - m);
    const float p1 = expf(s1 - m);
    const float l = warp_sum(p0 + p1);
    __syncwarp();  // every lane is done reading row r of q
    sQP[r][lane] = p0;
    sQP[r][lane + 32] = p1;
    if (lane == 0) {
      part_m[part_row0 + r] = m;
      part_l[part_row0 + r] = l;
    }
  }
  __syncthreads();

  const int d = threadIdx.x & (kDh - 1);
  for (int r = threadIdx.x / kDh; r < rows; r += kThreads / kDh) {
    float a = 0.0f;
#pragma unroll 16
    for (int c = 0; c < kChunk; ++c) a = fmaf(sQP[r][c], sV[c][d], a);
    part_acc[(part_row0 + r) * kDh + d] = a;
  }
}

template <int kDh>
__global__ void decode_attention_combine_kernel(
    const int* __restrict__ cache_valid, int S, int GT, int n_chunks,
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ acc_out) {
  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int d = threadIdx.x;
  const int cv = max(min(*cache_valid, S), 0);
  const int n_live = (cv + kChunk - 1) / kChunk;
  float m = kNeg;
  for (int c = 0; c < n_live; ++c) m = fmaxf(m, part_m[((size_t)h * n_chunks + c) * GT + r]);
  float l = 0.0f;
  float a = 0.0f;
  for (int c = 0; c < n_live; ++c) {
    const size_t row = ((size_t)h * n_chunks + c) * GT + r;
    const float w = expf(part_m[row] - m);
    l = fmaf(part_l[row], w, l);
    a = fmaf(part_acc[row * kDh + d], w, a);
  }
  const size_t out_row = (size_t)h * GT + r;
  if (d == 0) {
    m_out[out_row] = m;
    l_out[out_row] = l;
  }
  acc_out[out_row * kDh + d] = a;
}

template <int kDh, typename KV>
int launch(const float* q, const void* k, const void* v, const int* cache_valid, int S, int KH,
           int GT, float* part_m, float* part_l, float* part_acc, float* m, float* l,
           float* acc, cudaStream_t s) {
  constexpr int kSmem = smem_bytes<kDh>();
  static bool attr_set = false;  // above 48 KB dynamic shared memory must be allowed first
  if (kSmem > 48 * 1024 && !attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(decode_attention_partial_kernel<kDh, KV>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int row_groups = (GT + kMaxRows - 1) / kMaxRows;
  decode_attention_partial_kernel<kDh, KV><<<dim3(n_chunks, KH, row_groups), kThreads, kSmem, s>>>(
      q, static_cast<const KV*>(k), static_cast<const KV*>(v), cache_valid, S, KH, GT,
      n_chunks, part_m, part_l, part_acc);
  decode_attention_combine_kernel<kDh><<<dim3(GT, KH), kDh, 0, s>>>(
      cache_valid, S, GT, n_chunks, part_m, part_l, part_acc, m, l, acc);
  return (int)cudaGetLastError();
}

template <int kDh>
int launch_dh(const float* q, const void* k, const void* v, const int* cache_valid, int S, int KH,
              int GT, int kv_is_f32, float* part_m, float* part_l, float* part_acc, float* m, float* l,
              float* acc, cudaStream_t s) {
  if (kv_is_f32) {
    return launch<kDh, float>(q, k, v, cache_valid, S, KH, GT, part_m, part_l, part_acc, m, l, acc, s);
  }
  return launch<kDh, __nv_bfloat16>(q, k, v, cache_valid, S, KH, GT, part_m, part_l, part_acc, m, l, acc, s);
}

}  // namespace

// q (kh, gt, dh) f32 pre-scaled; k, v (s, kh, dh) bf16 (kv_is_f32 = 0) or
// f32; cache_valid: one int32 on the device. Scratch: part_m / part_l
// (kh, ceil(s/64), gt) f32, part_acc (kh, ceil(s/64), gt, dh) f32.
// Out: m, l (kh, gt) f32, acc (kh, gt, dh) f32. Requires dh in {64, 128}.
extern "C" int rtca_decode_attention(const float* q, const void* k, const void* v,
                                     const int* cache_valid, int s, int kh, int gt, int dh,
                                     int kv_is_f32, float* part_m, float* part_l,
                                     float* part_acc, float* m, float* l, float* acc,
                                     void* stream) {
  if (gt < 1 || gt > 65535 || kh < 1 || kh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 64) {
    return launch_dh<64>(q, k, v, cache_valid, s, kh, gt, kv_is_f32, part_m, part_l, part_acc, m, l, acc, st);
  }
  if (dh == 128) {
    return launch_dh<128>(q, k, v, cache_valid, s, kh, gt, kv_is_f32, part_m, part_l, part_acc, m, l, acc, st);
  }
  return (int)cudaErrorInvalidValue;
}
