// Device-memory streaming probe (kernel B6): how fast one card can stream a
// weight far larger than its L2 cache.
//
// Replaces the two Pallas TPU kernels of scripts/hbm_stream_probe.py: the
// "grid" kernel (:93-104, pallas_call :108; auto-pipelined blocks) and the
// "manual" kernel (:132-166, pallas_call :168; depth-d multi-buffered
// async copies into fast memory). Both stream an int8 buffer `passes` times
// in one launch and reduce what they read to an integer, so no load can be
// dropped; tools/hbm_stream_probe.py drives them and compares each sum with
// its plain version.
//
// What bounds them: bytes. Each pass reads the whole buffer from device
// memory (the buffer is several times the 50 MB L2), and the reductions cost
// a few integer instructions per 16 bytes.
//
// grid: blocks take (pass, chunk) steps b, b + G, b + 2G, ... of the flat
//   sequence of passes x chunks, so consecutive steps of a block read
//   different chunks and the blocks end together. Each thread keeps four
//   16-byte loads in flight and sums every byte (__dp4a), the JAX probe's
//   --full_reduce semantics: a load whose value nothing uses is not made.
// manual: one block per SM keeps a ring of `depth` shared-memory stages,
//   filled by whole-chunk bulk copies (cp.async.bulk, completion on an
//   mbarrier per stage); after a chunk lands, the first 32 rows of 256
//   bytes are summed from shared memory (REDUCE_ROWS = 32, as the TPU
//   probe), then the stage is refilled with the block's next chunk.
// Each block writes its int64 partial sum; the wrapper adds them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                      // 16-byte loads in flight per thread (grid)
constexpr int kStepBytes = kThreads * kUnroll * 16;  // grid chunks are whole multiples of this
constexpr int kRowBytes = 256;                  // manual: the row of the reduction
constexpr int kReduceRows = 32;
constexpr int kMaxDepth = 8;

__device__ __forceinline__ int sum_bytes(const int4 v, int acc) {
  acc = __dp4a(v.x, 0x01010101, acc);
  acc = __dp4a(v.y, 0x01010101, acc);
  acc = __dp4a(v.z, 0x01010101, acc);
  return __dp4a(v.w, 0x01010101, acc);
}

__device__ __forceinline__ void block_sum_store(long long v, long long* out) {
  __shared__ long long warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    out[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads) hbm_stream_grid_kernel(
    const int4* __restrict__ w, long long n_chunks, int chunk_vecs, long long total_steps,
    long long* __restrict__ partial) {
  long long total = 0;
  for (long long step = blockIdx.x; step < total_steps; step += gridDim.x) {
    const int4* src = w + (step % n_chunks) * chunk_vecs;
    int acc = 0;  // at most chunk bytes / 256 bytes of |v| <= 128 per thread
    for (int i = threadIdx.x; i < chunk_vecs; i += kThreads * kUnroll) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(src + i + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = sum_bytes(v[u], acc);
    }
    total += acc;
  }
  block_sum_store(total, partial);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__global__ void __launch_bounds__(kThreads) hbm_stream_manual_kernel(
    const int8_t* __restrict__ w, long long n_chunks, int chunk_bytes, int depth, long long total_steps,
    long long* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[kMaxDepth];
  const long long my_steps = total_steps > blockIdx.x ? (total_steps - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int reduce_vecs = min(kReduceRows * kRowBytes, chunk_bytes) / 16;

  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&bars[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // prologue: fill the ring
    for (long long i = 0; i < depth && i < my_steps; ++i) {
      const long long chunk = (blockIdx.x + i * gridDim.x) % n_chunks;
      bulk_load(smem_addr(ring + i * chunk_bytes), w + chunk * chunk_bytes, chunk_bytes,
                smem_addr(&bars[i]));
    }
  }
  __syncthreads();

  long long total = 0;
  for (long long i = 0; i < my_steps; ++i) {
    const int slot = (int)(i % depth);
    mbar_wait(smem_addr(&bars[slot]), (uint32_t)((i / depth) & 1));
    const int4* stage = reinterpret_cast<const int4*>(ring + (size_t)slot * chunk_bytes);
    int acc = 0;
    for (int v = threadIdx.x; v < reduce_vecs; v += kThreads) acc = sum_bytes(stage[v], acc);
    total += acc;
    __syncthreads();  // every thread is done with the stage before it is refilled
    if (threadIdx.x == 0 && i + depth < my_steps) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const long long chunk = (blockIdx.x + (i + depth) * gridDim.x) % n_chunks;
      bulk_load(smem_addr(ring + (size_t)slot * chunk_bytes), w + chunk * chunk_bytes, chunk_bytes,
                smem_addr(&bars[slot]));
    }
  }
  block_sum_store(total, partial);
}

}  // namespace

// Sums every byte of chunks 0 .. n_chunks-1 (each chunk_bytes long, a
// multiple of 16 KB) of the int8 buffer w, `passes` times, with `blocks`
// blocks; partial (blocks,) int64 receives each block's sum.
extern "C" int rtca_hbm_stream_grid(const void* w, long long n_chunks, int chunk_bytes, int passes, int blocks,
                                    long long* partial, void* stream) {
  if (chunk_bytes % kStepBytes != 0 || n_chunks < 1 || passes < 1 || blocks < 1 ||
      (reinterpret_cast<uintptr_t>(w) & 15))
    return (int)cudaErrorInvalidValue;
  hbm_stream_grid_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(w), n_chunks, chunk_bytes / 16, n_chunks * passes, partial);
  return (int)cudaGetLastError();
}

// Streams chunks 0 .. n_chunks-1 (each chunk_bytes long, a multiple of 16)
// of w into a ring of `depth` shared-memory stages per block, `passes`
// times, and sums the first 32 rows of 256 bytes of every chunk; partial
// (blocks,) int64 receives each block's sum. depth * chunk_bytes must fit in
// a block's shared memory (227 KB on an H100).
extern "C" int rtca_hbm_stream_manual(const void* w, long long n_chunks, int chunk_bytes, int passes, int depth,
                                      int blocks, long long* partial, void* stream) {
  if (chunk_bytes % 16 != 0 || depth < 1 || depth > kMaxDepth || n_chunks < 1 || passes < 1 || blocks < 1 ||
      (reinterpret_cast<uintptr_t>(w) & 15))
    return (int)cudaErrorInvalidValue;
  const int smem = depth * chunk_bytes;
  cudaError_t err = cudaFuncSetAttribute(hbm_stream_manual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  hbm_stream_manual_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), n_chunks, chunk_bytes, depth, n_chunks * passes, partial);
  return (int)cudaGetLastError();
}
