// Weight-only int8 matmul for decode-shaped rows (kernel B2).
//
// Replaces the Pallas TPU kernel realtime_codec_agent_tpu/ops/int8_matmul.py:59
// (int8_matmul -> _kernel, called at :87 and :107): y (T, N) f32 =
// (bf16(x) @ bf16(W_int8)) * s, per-output-channel scale s, f32 sums. Every
// weight |q| <= 127 is exact in bf16 and every product is exact in f32.
// T <= 8 rows (the frame scan runs T = 3, generate_until T = 1, the lm_head
// 1-3), any K, any N.
//
// What bounds it on the card: the (K, N) int8 weights, one byte each, read
// once (33.6 MB for gate|up, 531 MB for the lm_head); at T = 3 the products
// are ~3e-4 of the tensor cores' bf16 rate. So the kernel must keep enough
// bytes in flight on every SM and spend few instructions per byte: 2 a
// weight here (a quarter of a byte permute, a quarter of a shift, one LOP3
// and half a bf16x2 subtract), against ~4.4 (T = 3) to ~11 (T = 8) for the
// scalar FMAs over T of the first port. A conversion through f32 (a byte
// permute and an f32 add a weight, half a permute to pack) measured slower
// at the lm_head: its 1.5 permutes a weight and its registers (PERF.md).
//
// Design (sm_90a), after B5 (int4_matmul.cu):
// - Products on the tensor cores, mma.sync m16n8k16 bf16 -> f32, A = the
//   weights (16 output columns x 16 k) built in registers, B = x^T (16 k x
//   8 token slots: every T <= 8). wgmma would add nothing: its tiles are 64
//   rows and the tensor cores are idle here anyway.
// - Permuted k: the sum over k does not depend on the order of the k slots,
//   so lane (g, i) (g = lane / 4, i = lane % 4) takes K rows 4i .. 4i+3 of
//   each 16-row step: k slots (2i, 2i+1) are rows 4i, 4i+1 and (2i+8, 2i+9)
//   rows 4i+2, 4i+3. Its B fragment is then x of token g at those 4 rows,
//   one 8-byte load.
// - Fragments: lane (g, i) owns C adjacent columns g*C .. g*C+C-1 of the
//   warp's 8*C (C = 4, 8 or 16 bytes: one word, 8- or 16-byte load per row;
//   column tiles of 32, 64 or 128). m16 tile t of the warp puts column
//   g*C + 2t in row g and g*C + 2t + 1 in row g + 8. An A register holds
//   one column at two K rows, so one byte permute interleaves the words of
//   rows 4i and 4i + 1 (and of 4i + 2, 4i + 3) two columns at a time.
// - Exact conversion without f32: a signed byte is v = lo7 - 128 s; one
//   LOP3 makes the bf16 pair (128 + lo7) of bytes 0 and 2 of a word
//   (0x4300 | lo7), another (128 + 128 s) (0x4300 or 0x4380), and one bf16x2
//   subtract gives the pair of v, exactly (bytes 1 and 3 after a shift).
// - Loads straight into registers, two steps ahead of the products, by
//   every warp (three fragments in turn, as B5); rings of 4 and 6 measured
//   no faster (PERF.md).
// - Bounded tensor-core sums: the tensor cores' f32 additions truncate, so
//   the plan gives no warp more than 128 steps (2,048 k) in its one
//   accumulator (8,192 k read 6.3e-6 relative, 2,048 k 1.7e-6). A fresh
//   accumulator every 3 steps folded by f32 adds read 4e-7 but took 35
//   registers more, and the lm_head lost its one wave (PERF.md).
// - Grid: column tiles of one warp's 8*C columns x K splits of whole steps;
//   a block's k-warps (up to 8) share its steps (step i to warp i %
//   kwarps). ops/int8_matmul.plan picks the plan per (T, K, N) from the
//   sweep of all plans (tools/int8_plan_sweep.py): about one wave of 2,048
//   warps (16 an SM at the kernel's <= 128 registers). The splits of one
//   column tile form one thread-block cluster (<= 8, the portable size):
//   each block sums its k-warps' partials in shared memory, and after a
//   cluster barrier sums its share of the (T x tile) outputs over the
//   peers' partials through distributed shared memory in rank order and
//   applies s; one split is a plain launch that writes out directly. One
//   launch per call, no workspace, no atomics: two launches are bitwise
//   equal.
// - Any N: N % 16 == 0 with a 16-byte aligned W loads words and vectors
//   (kVec); any other N the same fragments from single bytes, the columns
//   past N as 0. Any K: the wrapper pads x's rows to a multiple of 16 with
//   zeros, and the last step reads the weight rows past K as 0.
#include <cooperative_groups.h>

#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStep = 16;          // K rows per mma step
constexpr int kMaxCluster = 8;     // the portable cluster size: K splits per column tile
constexpr int kMaxWarps = 8;       // k-warps per block (ptxas: <= 128 registers at the vector path)
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kMaxRows = 8;        // token slots of the mma's B

constexpr int kDepth = 3;          // fragments in turn: two steps in flight ahead of the products

// bytes 0 and 2 of x (signed weights v = lo7 - 128 s, s the sign bit) as a
// bf16 pair, exactly: (128 + lo7) - (128 + 128 s), both terms built by one
// LOP3 each (0x4300 | lo7 is 128 + lo7, 0x4380 is 256) and one bf16x2
// subtract, whose exact result is representable
__device__ __forceinline__ uint32_t bf16_pair_02(uint32_t x) {
  const uint32_t b = (x & 0x007F007Fu) | 0x43004300u;
  const uint32_t m = (x & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b), *reinterpret_cast<const __nv_bfloat162*>(&m));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// What lane (g, i) holds of one step: the C bytes of K rows 4i + r at its
// columns, as C / 4 words each, and x of its token g at rows 4i .. 4i+3.
template <int C>
struct Frag {
  uint32_t w[4][C / 4];
  uint2 x;
};

// one step's loads. q: row 4i of the step at the lane's first column; ncol:
// how many of its C columns exist (kVec: all or none, and a lane with none
// reads valid memory whose products go unused); rows: the step's rows below
// K (kTail only: the rest read as 0).
template <int C, bool kVec, bool kTail>
__device__ __forceinline__ void load_frag(Frag<C>& f, const int8_t* q, const uint16_t* x, int N, int ncol,
                                          int row, int rows) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int8_t* p = q + (size_t)r * N;
    const bool live = !kTail || row + r < rows;
    if constexpr (kVec && C == 16) {
      const uint4 v = live ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
      f.w[r][0] = v.x;
      f.w[r][1] = v.y;
      f.w[r][2] = v.z;
      f.w[r][3] = v.w;
    } else if constexpr (kVec && C == 8) {
      const uint2 v = live ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0, 0);
      f.w[r][0] = v.x;
      f.w[r][1] = v.y;
    } else if constexpr (kVec) {
      f.w[r][0] = live ? __ldg(reinterpret_cast<const uint32_t*>(p)) : 0u;
    } else {
#pragma unroll
      for (int j = 0; j < C / 4; ++j) {
        uint32_t v = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (live && 4 * j + c < ncol) v |= (uint32_t)(uint8_t)__ldg(p + 4 * j + c) << (8 * c);
        f.w[r][j] = v;
      }
    }
  }
  f.x = __ldg(reinterpret_cast<const uint2*>(x));
}

// the step's products into acc: word j of the lane's rows holds the
// columns of m16 tiles 2j and 2j + 1
template <int C>
__device__ __forceinline__ void frag_products(float (&acc)[C / 2][4], const Frag<C>& f) {
#pragma unroll
  for (int j = 0; j < C / 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // tile 2j + h: columns 4j + 2h (row g) and 4j + 2h + 1 (row g + 8)
      // bytes 2h, 2h + 1 of rows (4i, 4i + 1) and of rows (4i + 2, 4i + 3):
      // [r0 c0, r0 c1, r1 c0, r1 c1], so bytes 0, 2 are column 2h's k pair
      // and bytes 1, 3 (shifted down) column 2h + 1's
      const uint32_t sel = h ? 0x7632u : 0x5410u;
      const uint32_t x01 = __byte_perm(f.w[0][j], f.w[1][j], sel);
      const uint32_t x23 = __byte_perm(f.w[2][j], f.w[3][j], sel);
      const uint32_t a[4] = {bf16_pair_02(x01), bf16_pair_02(x01 >> 8), bf16_pair_02(x23),
                             bf16_pair_02(x23 >> 8)};
      mma_bf16(acc[2 * j + h], a, f.x.x, f.x.y);
    }
  }
}

// grid (column tiles, splits), cluster (1, splits, 1), blockDim = 32 x
// kwarps: warp kw owns the tile's 8*C columns and steps kw, kw + kwarps, ...
// of the block's split. x (T, ldx) bf16 with ldx % 16 == 0 and zeros past K.
// Dynamic shared memory: the (kwarps, T, tile) f32 partials.
template <int C, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) int8_matmul_kernel(
    const uint16_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
    float* __restrict__ out, int T, int K, int N, int ldx, int steps_per_split) {
  constexpr int kTile = 8 * C;
  constexpr int kTiles = C / 2;  // m16 tiles of a warp
  extern __shared__ __align__(16) float red[];
  const int kwarps = blockDim.x / 32;
  const int kw = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;  // the fragments' row / token index
  const int i4 = lane & 3;
  const int n0 = blockIdx.x * kTile;
  const int col = gq * C;  // the lane's first column in the tile
  const int steps = (K + kStep - 1) / kStep;
  const int s0 = blockIdx.y * steps_per_split;
  const int count = min(steps_per_split, steps - s0);  // steps of this block
  const int rem = K % kStep;                            // rows of a partial last step
  const int full = rem != 0 && s0 + count == steps ? count - 1 : count;

  // cursors at step s0 + kw: dead columns read column 0 and tokens >= T
  // read token 0; neither reaches out
  const int ncol = N - (n0 + col);
  const int c0 = ncol > 0 ? n0 + col : 0;
  const int8_t* q = w + ((size_t)(s0 + kw) * kStep + 4 * i4) * N + c0;
  const uint16_t* xp = x + (size_t)(gq < T ? gq : 0) * ldx + (s0 + kw) * kStep + 4 * i4;
  const size_t q_step = (size_t)kwarps * kStep * N;
  const int x_step = kwarps * kStep;
  auto load_next = [&](Frag<C>& f) {
    load_frag<C, kVec, false>(f, q, xp, N, ncol, 0, 0);
    q += q_step;
    xp += x_step;
  };

  // kDepth fragments in turn, kDepth - 1 steps in flight while one is
  // multiplied: step u of a round loads the warp's step kDepth - 1 ahead
  // into the fragment that step u - 1 freed, then multiplies its own. sum is
  // the warp's one tensor-core accumulator (the plan bounds its run).
  float sum[kTiles][4] = {};
  Frag<C> f[kDepth];
#pragma unroll
  for (int u = 0; u < kDepth - 1; ++u)
    if (kw + u * kwarps < full) load_next(f[u]);
  for (int i = kw; i < full; i += kDepth * kwarps) {
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int s = i + u * kwarps;
      if (s < full) {
        if (s + (kDepth - 1) * kwarps < full) load_next(f[(u + kDepth - 1) % kDepth]);
        frag_products<C>(sum, f[u]);
      }
    }
  }
  if (full < count && full % kwarps == kw) {  // the partial last step: the cursor is there
    load_frag<C, kVec, true>(f[0], q, xp, N, ncol, 4 * i4, rem);
    frag_products<C>(sum, f[0]);
  }

  // the warp's (T, 8C) partial: sum (tile t, e) is column col + 2t + e / 2,
  // token 2 i4 + e % 2
  float* part = red + kw * T * kTile;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int tok = 2 * i4 + e;
    if (tok >= T) continue;
#pragma unroll
    for (int j = 0; j < C / 4; ++j)
      *reinterpret_cast<float4*>(part + tok * kTile + col + 4 * j) =
          make_float4(sum[2 * j][e], sum[2 * j][e + 2], sum[2 * j + 1][e], sum[2 * j + 1][e + 2]);
  }

  // the block's k-warps, then the K splits of this column tile (one
  // cluster), each summed in a fixed order: block `rank` sums its share of
  // the (T, tile) outputs over every peer in rank order. One split writes
  // out straight away (a plain launch, no cluster).
  __syncthreads();
  const bool alone = gridDim.y == 1;
  for (int e = threadIdx.x; e < T * kTile; e += blockDim.x) {
    float v = red[e];
    for (int k = 1; k < kwarps; ++k) v += red[k * T * kTile + e];
    const int n = n0 + e % kTile;
    if (!alone) {
      red[e] = v;
    } else if (n < N) {
      out[(size_t)(e / kTile) * N + n] = v * __ldg(scale + n);
    }
  }
  if (alone) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  for (int e = rank * blockDim.x + threadIdx.x; e < T * kTile; e += splits * blockDim.x) {
    const int n = n0 + e % kTile;
    if (n >= N) continue;
    float v[kMaxCluster];
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p) v[p] = p < splits ? cluster.map_shared_rank(red, p)[e] : 0.0f;
    float total = v[0];
#pragma unroll
    for (int p = 1; p < kMaxCluster; ++p)
      if (p < splits) total += v[p];
    out[(size_t)(e / kTile) * N + n] = total * __ldg(scale + n);
  }
  cluster.sync();  // no block leaves while a peer reads its partial
}

template <int C, bool kVec>
int launch(const uint16_t* x, const int8_t* w, const float* scale, float* out, int t, int K, int N, int ldx,
           int splits, int per, int kwarps, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + 8 * C - 1) / (8 * C)), (unsigned)splits, 1);
  cfg.blockDim = dim3((unsigned)(32 * kwarps), 1, 1);
  cfg.dynamicSmemBytes = (size_t)kwarps * t * 8 * C * sizeof(float);  // <= 32 KB
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = (unsigned)splits;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one split: a plain launch (an implicit cluster of one)
  cudaLaunchKernelEx(&cfg, int8_matmul_kernel<C, kVec>, x, w, scale, out, t, K, N, ldx, per);
  return (int)cudaGetLastError();
}

template <int C>
int launch_c(bool vec, const uint16_t* x, const int8_t* w, const float* scale, float* out, int t, int K, int N,
             int ldx, int splits, int per, int kwarps, cudaStream_t s) {
  return vec ? launch<C, true>(x, w, scale, out, t, K, N, ldx, splits, per, kwarps, s)
             : launch<C, false>(x, w, scale, out, t, K, N, ldx, splits, per, kwarps, s);
}

}  // namespace

// x (t, ldx) bf16 (rows padded with zeros from k to ldx), w (k, n) int8,
// scale (n,) f32 -> out (t, n) f32, in one launch: column tiles of `tile`
// (32, 64 or 128) columns x `splits` K splits of `per` whole 16-row steps
// each (1..8, the last may hold fewer, none is empty: splits = ceil(steps /
// per); the splits of a tile are one cluster), `kwarps` warps (1..8) sharing
// a block's steps. ops/int8_matmul.plan chooses all four; the entry checks
// them and returns cudaErrorInvalidValue on any other. Requires 1 <= t <= 8, k, n >= 1, ldx >= k with ldx % 16 == 0 and a
// 16-byte aligned x; n % 16 == 0 with a 16-byte aligned w loads words and
// vectors, any other w single bytes.
extern "C" int rtca_int8_matmul(const void* x, const void* w, const float* scale, float* out, int t, int k, int n,
                                int ldx, int tile, int splits, int per, int kwarps, void* stream) {
  const int steps = (k + kStep - 1) / kStep;
  if (t < 1 || t > kMaxRows || k < 1 || n < 1 || ldx < k || ldx % kStep != 0 ||
      (tile != 32 && tile != 64 && tile != 128) || splits < 1 || splits > kMaxCluster || per < 1 ||
      splits != (steps + per - 1) / per || kwarps < 1 || kwarps > kMaxWarps ||
      (reinterpret_cast<uintptr_t>(x) & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const bool vec = n % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  switch (tile) {
    case 32: return launch_c<4>(vec, xb, wq, scale, out, t, k, n, ldx, splits, per, kwarps, s);
    case 64: return launch_c<8>(vec, xb, wq, scale, out, t, k, n, ldx, splits, per, kwarps, s);
    default: return launch_c<16>(vec, xb, wq, scale, out, t, k, n, ldx, splits, per, kwarps, s);
  }
}
