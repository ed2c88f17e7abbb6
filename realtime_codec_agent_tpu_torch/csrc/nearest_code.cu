// Nearest-codebook-entry search for the codec quantizer (kernel B1).
//
// Replaces the Pallas TPU kernel realtime_codec_agent_tpu/ops/quantize.py:83
// (nearest_code_prepared -> _nearest_code_kernel, pallas_call at :106): for
// each encoder frame x (D = 16 floats) find argmax_j (x . c_j - |c_j|^2 / 2)
// over the V = 131,072 projected codebook entries, ties going to the lowest
// index. Each score is x . c_j summed over d = 0 .. 15 in order with fmaf,
// then the half-norm subtracted: f32 SIMT, no TF32 and no tensor-core split.
//
// What bounds it on the card: operations. A streaming chunk encodes N = 100
// frames: 2 N V D = 419 MFLOP of f32 FMAs (6.3 us at 67 TFLOP/s) against an
// 8 MB codebook that stays in the 50 MB L2 between calls. The frame axis
// alone cannot fill 132 SMs, so the parallelism comes from the codebook axis.
//
// Design, one launch a call (no memset, no second kernel; CUDA-graph
// capturable):
// - Grid (codebook chunks, row tiles of at most kMaxRows frames): the
//   codebook is read once per row tile, and a corpus-scale encode
//   (thousands of frames) runs as more row tiles.
// - Staging: a block copies its chunk and half-norms into shared memory with
//   cp.async in two commit groups (the first half of every code group's run,
//   then the second), so the second half lands while the first is scored.
//   (Four groups, waited for inside one loop, were slower: the barriers.)
// - Register tiles: a thread holds kR = 4 rows of x (64 floats) and scores
//   kC = 4 codes at a time, 16 independent FMA chains, the codes read from
//   shared memory as float4 broadcasts; 128 registers keep two blocks (16
//   warps) on an SM (8 rows a thread take 243 registers and one block an
//   SM; tools/nearest_code_variants.py times them and 8 codes a step). Its
//   A = ceil(rows / kR) row groups times B code groups make the block, so
//   no lane idles at N = 100 (A = 25, B = 10); each code group owns a
//   contiguous run of the chunk's codes (staged with a 16-byte pad per
//   group, so the two groups a warp can span read different banks), and the
//   chunk is B runs. Per kC codes a row takes one compare of their max
//   against its running best, and the first code that reaches a new best
//   wins: ties to the lowest index inside a thread.
// - Reductions, as 64-bit keys (order-preserving score bits << 32 | ~index:
//   the larger key has the larger score, or the same score and the lower
//   index, so the result does not depend on the order and is bitwise
//   repeatable): a block's code groups meet in shared memory; each block
//   writes its key per row to a workspace; the last of every kGroupBlocks
//   blocks to finish (a ticket counter) reduces their keys, and the last
//   of those reducers (a second ticket) reduces theirs and writes the codes.
//   Each ticket is reset by the block that drew the last number, for the
//   next call. Two short levels keep the tail at one round of loads each.
//   (tools/nearest_code_variants.py times one level, the last block loading
//   every key 32 at a time. A 64-bit atomicMax a block into per-row slots,
//   and a cluster of 8 blocks reducing in distributed shared memory, which
//   keeps fewer blocks in flight, were both slower.) The same tool splits
//   the time into the launch, the staging, the scoring and the reduction
//   (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 16;
constexpr int kChunk = 512;    // codes per block, about: B runs of whole steps
constexpr int kR = 4;          // rows per thread
constexpr int kC = 4;          // codes per step
constexpr int kMaxThreads = 256;
constexpr int kMaxRows = 32 * kR;  // rows per tile
constexpr int kMinRun = 16;    // codes per code group at least
constexpr int kGroupBlocks = 16;   // blocks per first-level reduction

struct Plan {
  int tiles, rows;  // row tiles, rows per tile (the last may hold fewer)
  int a, b, run;    // row groups, code groups, codes per code group
  int chunk;        // codes per block: b * run
  int blocks;       // codebook chunks
  int groups;       // first-level reductions: ceil(blocks / kGroupBlocks)
  int smem;         // dynamic shared memory, bytes
};

Plan make_plan(int n, int v) {
  Plan p;
  p.tiles = (n + kMaxRows - 1) / kMaxRows;
  p.rows = (n + p.tiles - 1) / p.tiles;
  p.a = (p.rows + kR - 1) / kR;
  p.b = kMaxThreads / p.a;
  if (p.b > kChunk / kMinRun) p.b = kChunk / kMinRun;
  p.run = ((kChunk + p.b - 1) / p.b + kC - 1) / kC * kC;
  p.chunk = p.b * p.run;
  p.blocks = (v + p.chunk - 1) / p.chunk;
  p.groups = (p.blocks + kGroupBlocks - 1) / kGroupBlocks;
  // per code group: run codes of 4 float4 + a 16-byte pad, run half-norms + 4
  p.smem = p.b * ((p.run * 4 + 1) * 16 + (p.run + 4) * 4);
  return p;
}

__device__ __forceinline__ unsigned int ordered_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long code_key(float score, int index) {
  return ((unsigned long long)ordered_bits(score) << 32) | (unsigned long long)(0xFFFFFFFFu - (unsigned int)index);
}

__device__ __forceinline__ unsigned long long key_max(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// 16 bytes global -> shared, asynchronously; bytes past src_bytes are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// the max key over `count` keys of each row (stride `stride` keys between
// them) at `src`, by the block's threads, for rows 0 .. nrows - 1; the
// result in s_out[row]. One round of at most kGroupBlocks loads a thread.
__device__ void reduce_keys(const unsigned long long* src, int count, size_t stride, int nrows,
                            unsigned long long* s_tmp, unsigned long long* s_out) {
  const int ways = blockDim.x / nrows;  // threads per row (>= 2)
  const int r = threadIdx.x % nrows;
  const int w = threadIdx.x / nrows;
  if (w < ways) {
    unsigned long long k = 0ull;
#pragma unroll 16
    for (int i = w; i < count; i += ways) k = key_max(k, __ldcg(src + (size_t)i * stride + r));
    s_tmp[w * nrows + r] = k;
  }
  __syncthreads();
  if (threadIdx.x < nrows) {
    unsigned long long k = s_tmp[threadIdx.x];
    for (int i = 1; i < ways; ++i) k = key_max(k, s_tmp[i * nrows + threadIdx.x]);
    s_out[threadIdx.x] = k;
  }
}

// draw a ticket: true in the block that arrives last of `of` (after every
// writer of the block fenced its stores); that block resets the counter
__device__ bool last_arrival(unsigned int* counter, unsigned int of, int* s_flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(counter, 1u) == of - 1;
    if (last) *counter = 0u;  // every block of this round has drawn: ready for the next call
    *s_flag = last;
  }
  __syncthreads();
  if (!*s_flag) return false;
  __threadfence();
  return true;
}

__global__ void __launch_bounds__(kMaxThreads, 2) nearest_code_kernel(
    const float* __restrict__ x, const float* __restrict__ cb, const float* __restrict__ halfnorm, int n, int v,
    Plan p, unsigned long long* __restrict__ part, unsigned int* __restrict__ tickets, int* __restrict__ out) {
  extern __shared__ __align__(16) float4 smem_nc[];
  const int cstride = p.run * 4 + 1;  // float4s per code group
  const int hstride = p.run + 4;      // floats per code group
  float4* s_cb = smem_nc;
  float* s_hn = reinterpret_cast<float*>(smem_nc + p.b * cstride);
  __shared__ int s_flag;

  // stage: phase 0 the first `half` codes of every code group, phase 1 the rest
  const int v0 = blockIdx.x * p.chunk;
  const int nv = min(p.chunk, v - v0);
  const int half = (p.run / 2 + kC - 1) / kC * kC;
  const float4* cb4 = reinterpret_cast<const float4*>(cb);
#pragma unroll
  for (int ph = 0; ph < 2; ++ph) {
    const int w0 = ph ? half : 0;
    const int w1 = ph ? p.run : half;
    for (int grp = 0; grp < p.b; ++grp) {
      const int c0 = grp * p.run;  // the group's first code in the chunk
      for (int i = threadIdx.x; i < (w1 - w0) * 4; i += blockDim.x) {
        const int w = w0 + (i >> 2);
        if (c0 + w < nv) cp_async16(s_cb + grp * cstride + w * 4 + (i & 3), cb4 + (size_t)(v0 + c0 + w) * 4 + (i & 3), 16);
      }
      for (int i = threadIdx.x; i < (w1 - w0) / 4; i += blockDim.x) {
        const int w = w0 + 4 * i;
        const int valid = nv - (c0 + w);
        if (valid > 0) cp_async16(s_hn + grp * hstride + w, halfnorm + v0 + c0 + w, 4 * min(valid, 4));
      }
    }
    cp_async_commit();
  }

  const int row0 = blockIdx.y * p.rows;
  const int nrows = min(p.rows, n - row0);
  const int ra = threadIdx.x % p.a;  // rows ra, ra + a, ..., of the tile
  const int grp = threadIdx.x / p.a;
  float xr[kR][kD];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ra + i * p.a;
    const float4* x4 = reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * kD);
#pragma unroll
    for (int q = 0; q < kD / 4; ++q) {
      const float4 t = r < nrows ? __ldg(x4 + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      xr[i][4 * q + 0] = t.x;
      xr[i][4 * q + 1] = t.y;
      xr[i][4 * q + 2] = t.z;
      xr[i][4 * q + 3] = t.w;
    }
  }

  float best[kR];
  int besti[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    best[i] = -INFINITY;
    besti[i] = 0;
  }
  const float4* gc = s_cb + grp * cstride;
  const float* gh = s_hn + grp * hstride;
  const int j0 = v0 + grp * p.run;
  const int nvalid = max(0, min(p.run, nv - grp * p.run));  // codes of this group inside V
  // kC codes from s; `lim` of them valid (only the group's last step has fewer)
  auto step = [&](int s, int lim) {
    float acc[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] = 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kD / 4; ++q) {
      float4 cv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) cv[c] = gc[(s + c) * (kD / 4) + q];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          acc[i][c] = fmaf(xr[i][4 * q + 0], cv[c].x, acc[i][c]);
          acc[i][c] = fmaf(xr[i][4 * q + 1], cv[c].y, acc[i][c]);
          acc[i][c] = fmaf(xr[i][4 * q + 2], cv[c].z, acc[i][c]);
          acc[i][c] = fmaf(xr[i][4 * q + 3], cv[c].w, acc[i][c]);
        }
      }
    }
    const float4 h = *reinterpret_cast<const float4*>(gh + s);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float sc[kC] = {acc[i][0] - h.x, acc[i][1] - h.y, acc[i][2] - h.z, acc[i][3] - h.w};
      if (lim < kC) {
#pragma unroll
        for (int c = 1; c < kC; ++c) sc[c] = c < lim ? sc[c] : -INFINITY;
      }
      const float mx = fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3]));
      if (mx > best[i]) {  // rare after the first steps; the first code at the max wins
        best[i] = mx;
        besti[i] = j0 + s + (sc[0] == mx ? 0 : sc[1] == mx ? 1 : sc[2] == mx ? 2 : 3);
      }
    }
  };
  cp_async_wait<1>();
  __syncthreads();
  for (int s = 0; s < min(half, nvalid); s += kC) step(s, nvalid - s);
  cp_async_wait<0>();
  __syncthreads();
  for (int s = half; s < nvalid; s += kC) step(s, nvalid - s);

  // the block's best per row, over its code groups (the staged codes are
  // no longer read: the keys reuse the space)
  __syncthreads();
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(smem_nc);
  unsigned long long* s_tmp = s_key + p.b * p.rows;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ra + i * p.a;
    if (r < nrows) s_key[grp * p.rows + r] = code_key(best[i], besti[i]);
  }
  __syncthreads();
  const size_t tile_keys = (size_t)p.rows * (gridDim.x + p.groups);
  unsigned long long* blocks_part = part + blockIdx.y * tile_keys;  // [block][row]
  unsigned long long* groups_part = blocks_part + (size_t)gridDim.x * p.rows;  // [group][row]
  if (threadIdx.x < nrows) {
    unsigned long long k = s_key[threadIdx.x];
    for (int g = 1; g < p.b; ++g) k = key_max(k, s_key[g * p.rows + threadIdx.x]);
    blocks_part[(size_t)blockIdx.x * p.rows + threadIdx.x] = k;
    __threadfence();
  }

  // level 1: the last block of each kGroupBlocks blocks reduces their keys
  unsigned int* tile_tickets = tickets + blockIdx.y * (p.groups + 1);
  const int group = blockIdx.x / kGroupBlocks;
  const int first = group * kGroupBlocks;
  const int count = min(kGroupBlocks, (int)gridDim.x - first);
  if (!last_arrival(tile_tickets + group, count, &s_flag)) return;
  reduce_keys(blocks_part + (size_t)first * p.rows, count, p.rows, nrows, s_tmp, s_key);
  if (threadIdx.x < nrows) {
    groups_part[(size_t)group * p.rows + threadIdx.x] = s_key[threadIdx.x];
    __threadfence();
  }

  // level 2: the last of the group reducers reduces theirs and writes the codes
  if (!last_arrival(tile_tickets + p.groups, p.groups, &s_flag)) return;
  reduce_keys(groups_part, p.groups, p.rows, nrows, s_tmp, s_key);
  if (threadIdx.x < nrows) out[row0 + threadIdx.x] = (int)(0xFFFFFFFFu - (unsigned int)(s_key[threadIdx.x] & 0xFFFFFFFFull));
}

}  // namespace

// The launch of rtca_nearest_code at (n, v): out[0] row tiles, out[1] rows
// per tile, out[2] codebook chunks (blocks per tile), out[3] first-level
// reductions per tile, out[4] threads a block, out[5] its dynamic shared
// memory in bytes, out[6] the 64-bit keys of its workspace, out[7] its
// ticket counters.
extern "C" int rtca_nearest_code_plan(int n, int v, long long* out) {
  if (n < 1 || v < 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(n, v);
  out[0] = p.tiles;
  out[1] = p.rows;
  out[2] = p.blocks;
  out[3] = p.groups;
  out[4] = p.a * p.b;
  out[5] = p.smem;
  out[6] = (long long)p.tiles * p.rows * (p.blocks + p.groups);
  out[7] = (long long)p.tiles * (p.groups + 1);
  return (int)cudaSuccess;
}

extern "C" int rtca_nearest_code(const float* x, const float* cb, const float* halfnorm, int n, int v,
                                 unsigned long long* part, unsigned int* tickets, int* out, void* stream) {
  if (n < 1 || v < 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(n, v);
  if (p.tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(p.blocks, p.tiles);
  nearest_code_kernel<<<grid, p.a * p.b, p.smem, static_cast<cudaStream_t>(stream)>>>(x, cb, halfnorm, n, v, p,
                                                                                        part, tickets, out);
  return (int)cudaGetLastError();
}
