// Nearest-codebook-entry search for the codec quantizer (kernel B1).
//
// Replaces the Pallas TPU kernel realtime_codec_agent_tpu/ops/quantize.py
// (nearest_code_prepared -> _nearest_code_kernel): for each encoder frame x
// (D = 16 floats) find argmax_j (x . c_j - |c_j|^2 / 2) over the V = 131,072
// projected codebook entries, ties going to the lowest index.
//
// What bounds it on the card: a streaming chunk encodes only ~100 frames, so
// the work is V * N * D = 210 M FMAs over an 8 MB codebook -- a few
// microseconds at either the f32 or the memory roofline. The frame axis alone
// cannot fill 132 SMs, so the parallelism comes from the codebook axis.
//
// Design: each block stages kCodesPerBlock codes (and their half-norms) in
// shared memory and gives every frame row its own thread; a thread keeps a
// running (best score, index) with a strict '>' (lowest index wins inside the
// block). Blocks are combined with one 64-bit atomicMax per row on the key
// (order-preserving score bits << 32 | ~index): the larger score wins, and
// between equal scores the larger ~index, i.e. the lower index. A second tiny
// kernel turns the keys back into indices.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 16;
constexpr int kCodesPerBlock = 256;
constexpr int kRowsPerBlock = 128;  // one thread per frame row

__device__ __forceinline__ unsigned int ordered_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kRowsPerBlock) nearest_code_kernel(
    const float* __restrict__ x, const float* __restrict__ cb,
    const float* __restrict__ halfnorm, int n, int v,
    unsigned long long* __restrict__ keys) {
  __shared__ float4 s_cb[kCodesPerBlock * kD / 4];
  __shared__ float s_hn[kCodesPerBlock];
  const int v0 = blockIdx.x * kCodesPerBlock;
  const int nv = min(kCodesPerBlock, v - v0);
  const float4* cb4 = reinterpret_cast<const float4*>(cb + (size_t)v0 * kD);
  for (int i = threadIdx.x; i < nv * (kD / 4); i += blockDim.x) s_cb[i] = cb4[i];
  for (int i = threadIdx.x; i < nv; i += blockDim.x) s_hn[i] = halfnorm[v0 + i];
  __syncthreads();

  const int row = blockIdx.y * kRowsPerBlock + threadIdx.x;
  if (row >= n) return;
  float xr[kD];
  const float4* x4 = reinterpret_cast<const float4*>(x + (size_t)row * kD);
#pragma unroll
  for (int i = 0; i < kD / 4; ++i) {
    const float4 t = x4[i];
    xr[4 * i + 0] = t.x;
    xr[4 * i + 1] = t.y;
    xr[4 * i + 2] = t.z;
    xr[4 * i + 3] = t.w;
  }
  float best = -INFINITY;
  int besti = 0;
  for (int j = 0; j < nv; ++j) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kD / 4; ++i) {
      const float4 c = s_cb[j * (kD / 4) + i];
      s = fmaf(xr[4 * i + 0], c.x, s);
      s = fmaf(xr[4 * i + 1], c.y, s);
      s = fmaf(xr[4 * i + 2], c.z, s);
      s = fmaf(xr[4 * i + 3], c.w, s);
    }
    s -= s_hn[j];
    if (s > best) {
      best = s;
      besti = j;
    }
  }
  const unsigned long long key =
      ((unsigned long long)ordered_bits(best) << 32) |
      (unsigned long long)(0xFFFFFFFFu - (unsigned int)(v0 + besti));
  atomicMax(&keys[row], key);
}

__global__ void keys_to_index_kernel(const unsigned long long* __restrict__ keys,
                                     int* __restrict__ out, int n) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) out[row] = (int)(0xFFFFFFFFu - (unsigned int)(keys[row] & 0xFFFFFFFFull));
}

}  // namespace

// x (n, 16) f32, cb (v, 16) f32, halfnorm (v,) f32 -> out (n,) int32.
// keys is (n,) u64 scratch. Returns the cudaError_t of the launches.
extern "C" int rtca_nearest_code(const float* x, const float* cb, const float* halfnorm,
                                 int n, int v, unsigned long long* keys, int* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(keys, 0, sizeof(unsigned long long) * (size_t)n, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((v + kCodesPerBlock - 1) / kCodesPerBlock,
                  (n + kRowsPerBlock - 1) / kRowsPerBlock);
  nearest_code_kernel<<<grid, kRowsPerBlock, 0, s>>>(x, cb, halfnorm, n, v, keys);
  keys_to_index_kernel<<<(n + 127) / 128, 128, 0, s>>>(keys, out, n);
  return (int)cudaGetLastError();
}
