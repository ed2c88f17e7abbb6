// Affine int4 weight matmul for decode-shaped rows (kernel B5).
//
// Replaces the Pallas TPU kernel realtime_codec_agent_tpu/ops/int4_matmul.py:97
// (int4_matmul -> _kernel_split, :73, called at :151): y (T, N) f32 =
// bf16(x) @ W, where W[k, n] = bf16(fma(q[k, n], d[k / 32, n], -m[k / 32, n])),
// q in [0, 15], d and m f32, f32 products and sums. T <= 8 rows (the frame
// scan runs T = 3, generate_until T = 1), any N, K % 32 == 0.
//
// Leaf layout (unchanged, no re-layout at load): q4 uint8 (K/2, N), d and m
// f32 (K/32, N). Group-contiguous halves: byte row g*16 + j holds K row
// g*32 + j in its low nibble and K row g*32 + 16 + j in its high nibble.
//
// What bounds it on the card: leaf bytes, 0.75 B per weight (half a byte of
// nibbles, 8 bytes of d/m per group of 32); at T = 3 the products are
// ~2e-4 of the tensor cores' bf16 rate. What holds this kernel back is the
// dequantization, not the copies: the weights must stay bit for bit
// bf16(fmaf(q, d, -m)), so every weight costs an f32 FMA, an exact nibble
// -> float conversion (a byte permute and an add) and half a bf16 pack,
// ~5 instructions per weight with the loads and mmas, and the warps wait on
// their chains (PERF.md).
//
// Design (sm_90a):
// - Products on the tensor cores, mma.sync m16n8k16 bf16 -> f32, A = the
//   weights (16 output columns x 16 k) in registers, B = x^T (16 k x 8 token
//   slots). wgmma would add nothing: it needs 64-row tiles and
//   shared-memory B, and the tensor cores are idle here anyway.
// - Permuted k: the sum over k does not depend on the order of the k slots,
//   so the mma's k pair (2i, 2i+1) is the (low, high) nibble of one byte,
//   i.e. K rows (g*32 + j, g*32 + 16 + j), and the B fragment takes x in the
//   same order -- the TPU kernel's x_lo / x_hi split moved into the
//   fragment. Each pack of the dequant's (low, high) pair is then one A
//   register: no unpacking and no scalar FMAs over T.
// - Fragments: a warp owns 32 adjacent output columns. Lane (g, i) (g =
//   lane / 4, i = lane % 4) takes byte rows 4i .. 4i+3 of every group: one
//   32-bit load per row gives columns 4g .. 4g+3, whose bytes 0, 1 are rows
//   g and g + 8 of the warp's first m16 tile and bytes 2, 3 those of the
//   second; row 4i + 2h + b is the lane's k pair b of half h. Its x is then
//   K rows 4i .. 4i+3 and 16 + 4i .. +3 of the group: two 8-byte loads.
//   d and m of its 4 columns are one 16-byte load each. Per group and lane:
//   8 loads, 4 mmas, 8 accumulators.
// - Loads straight into registers, two groups ahead of the products, by
//   every warp (three fragments in turn, no register moves): the bytes in
//   flight are the warps' prefetches. A TMA ring (one producer warp
//   filling stages of 1-8 groups of q4, d, m and x from tensor maps, the
//   consumers releasing them on mbarriers) was built first and measured no
//   faster at any layer shape (PERF.md), so it went.
// - Grid: column tiles of 32, 64 or 128 (1, 2 or 4 warps across) x K
//   splits of whole groups; a block's k-warps (up to 16 warps a block)
//   share its groups (group i to warp i % kwarps). ops/int4_matmul.plan
//   picks the plan per (T, K, N) from the sweep of all plans
//   (tools/int4_plan_sweep.py): few, wide blocks, K split only where a
//   column tile alone would leave most SMs idle. The splits of one column
//   tile form one thread-block cluster (<= 8, the portable size): each
//   block sums its k-warps' partials in shared memory, and after a cluster
//   barrier sums its share of the (T x tile) outputs over the peers'
//   partials through distributed shared memory in rank order; one split is
//   a plain launch that writes out directly. One launch per call, no
//   workspace, no atomics: two launches are bitwise equal.
// - Any N: N % 16 == 0 with aligned leaves loads words and 16-byte d/m
//   vectors (kVec); any other N the same fragments from single bytes and
//   floats, columns past N as 0. The layer shapes never take that path.
//
// Calls wider than 8 rows (prefill, scoring, recompute) take the dequant
// route of ops/nn.qdot instead: int4_dequant_kernel writes the same bf16
// weights as a (K, N) tensor for a dense matmul, the counterpart of the XLA
// dequantization (realtime_codec_agent_tpu/ops/int4_matmul.py dequant_int4).
#include <cooperative_groups.h>

#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 8;                   // dequant kernel: columns per thread (one 16-byte bf16 store)
constexpr int kGroup = 32;                 // K rows per (d, m) pair
constexpr int kHalf = kGroup / 2;          // byte rows per group
constexpr int kWarpCols = 32;              // output columns per warp
constexpr int kMaxCluster = 8;             // the portable cluster size: K splits per column tile
constexpr int kMaxWarps = 16;              // warps per block
constexpr int kMaxThreads = kMaxWarps * 32;

// A nibble (0..15) as float, exactly, with full-rate integer and add
// instructions instead of an int-to-float conversion: 2^23 + v - 2^23.
__device__ __forceinline__ float nibble_to_float(int v) {
  return __int_as_float(0x4B000000 | v) - 8388608.0f;
}

// The A registers of the 4 bytes of word w (byte c: column c of the lane's
// 4): each (low, high) nibble pair as bf16(fma(q, d, -m)). A byte permute
// puts a nibble under the exponent of 2^23 (0x4B0000vv = 2^23 + v) and one
// add removes 2^23: exact, at full rate.
__device__ __forceinline__ void dequant_word(uint32_t w, const float (&d)[4], const float (&neg_m)[4],
                                             uint32_t (&a)[4]) {
  const uint32_t lo = w & 0x0F0F0F0Fu;
  const uint32_t hi = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float ql = __int_as_float(__byte_perm(lo, 0x4B000000u, 0x7540u | c)) - 8388608.0f;
    const float qh = __int_as_float(__byte_perm(hi, 0x4B000000u, 0x7540u | c)) - 8388608.0f;
    a[c] = pack_f32(fmaf(ql, d[c], neg_m[c]), fmaf(qh, d[c], neg_m[c]));
  }
}

// What lane (g, i) holds of one group: the words of byte rows 4i + 2h + b
// at its 4 columns, d and m of those columns, and x of its token g at K
// rows 4i .. 4i+3 (xl) and 16 + 4i .. +3 (xh) of the group, 4 bf16 each.
struct Frag {
  uint32_t w[2][2];
  float4 dv, mv;
  uint2 xl, xh;
};

// one group's loads. q: byte row 4i of the group at the lane's first
// column; ncol: how many of its 4 columns exist (kVec: all or none, and a
// lane with none reads valid memory whose products go unused).
template <bool kVec>
__device__ __forceinline__ void load_frag(Frag& f, const uint8_t* q, const float* d, const float* m,
                                          const uint16_t* x, int N, int ncol) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t v = 0;
    if (kVec) {
      v = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)r * N));
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < ncol) v |= (uint32_t)__ldg(q + (size_t)r * N + c) << (8 * c);
    }
    f.w[r >> 1][r & 1] = v;
  }
  if (kVec) {
    f.dv = __ldg(reinterpret_cast<const float4*>(d));
    f.mv = __ldg(reinterpret_cast<const float4*>(m));
  } else {
    float dv[4], mv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dv[c] = c < ncol ? __ldg(d + c) : 0.0f;
      mv[c] = c < ncol ? __ldg(m + c) : 0.0f;
    }
    f.dv = make_float4(dv[0], dv[1], dv[2], dv[3]);
    f.mv = make_float4(mv[0], mv[1], mv[2], mv[3]);
  }
  f.xl = __ldg(reinterpret_cast<const uint2*>(x));
  f.xh = __ldg(reinterpret_cast<const uint2*>(x + kHalf));
}

// the group's products: the 4 words dequantized into A fragments, B = (x of
// K row j, x of K row 16 + j) for the lane's j = 4i + 2h + b; two m16 tiles
// x two k halves
template <int T>
__device__ __forceinline__ void frag_products(float (&acc)[2][4], const Frag& f) {
  const float dd[4] = {f.dv.x, f.dv.y, f.dv.z, f.dv.w};
  const float nm[4] = {-f.mv.x, -f.mv.y, -f.mv.z, -f.mv.w};
  const uint32_t bx[2][2] = {{__byte_perm(f.xl.x, f.xh.x, 0x5410), __byte_perm(f.xl.x, f.xh.x, 0x7632)},
                             {__byte_perm(f.xl.y, f.xh.y, 0x5410), __byte_perm(f.xl.y, f.xh.y, 0x7632)}};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t p0[4], p1[4];  // k pairs 0 and 1 of half h
    dequant_word(f.w[h][0], dd, nm, p0);
    dequant_word(f.w[h][1], dd, nm, p1);
#pragma unroll
    for (int t = 0; t < 2; ++t) {  // m16 tile t: columns 4g + 2t (rows g) and 4g + 2t + 1 (rows g + 8)
      const uint32_t a[4] = {p0[2 * t], p0[2 * t + 1], p1[2 * t], p1[2 * t + 1]};
      mma_bf16(acc[t], a, bx[h][0], bx[h][1]);
    }
  }
}

// grid (column tiles, splits), cluster (1, splits, 1), blockDim = 32 x
// cwarps x kwarps: warp (cw, kw) = (warp % cwarps, warp / cwarps) owns
// columns cw*32 .. +31 of the tile and groups kw, kw + kwarps, ... of the
// block's split. Dynamic shared memory: the (kwarps, T, tile) f32 partials.
template <int T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) int4_matmul_kernel(
    const uint16_t* __restrict__ x, const uint8_t* __restrict__ q4, const float* __restrict__ d,
    const float* __restrict__ m, float* __restrict__ out, int K, int N, int groups_per_split, int cwarps) {
  extern __shared__ __align__(16) float red[];
  const int kwarps = blockDim.x / 32 / cwarps;
  const int tile = cwarps * kWarpCols;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cw = warp % cwarps;
  const int kw = warp / cwarps;
  const int gq = lane >> 2;  // the fragments' row / token index
  const int i4 = lane & 3;
  const int n0 = blockIdx.x * tile;
  const int col = cw * kWarpCols + 4 * gq;  // the lane's first column in the tile
  const int g0 = blockIdx.y * groups_per_split;
  const int count = min(groups_per_split, K / kGroup - g0);  // groups of this block

  // cursors at group g0 + kw: dead columns read column 0 and tokens >= T
  // read token 0; neither reaches out
  const int ncol = N - (n0 + col);
  const int c0 = ncol > 0 ? n0 + col : 0;
  const int g = g0 + kw;
  const uint8_t* q = q4 + ((size_t)g * kHalf + 4 * i4) * N + c0;
  const float* dp = d + (size_t)g * N + c0;
  const float* mp = m + (size_t)g * N + c0;
  const uint16_t* xp = x + (size_t)(gq < T ? gq : 0) * K + g * kGroup + 4 * i4;
  const size_t q_step = (size_t)kwarps * kHalf * N;
  const size_t dm_step = (size_t)kwarps * N;
  const int x_step = kwarps * kGroup;
  auto load_next = [&](Frag& f) {
    load_frag<kVec>(f, q, dp, mp, xp, N, ncol);
    q += q_step;
    dp += dm_step;
    mp += dm_step;
    xp += x_step;
  };

  // three fragments in turn, two groups in flight while one is multiplied:
  // step j loads the warp's group two ahead into the fragment that step
  // j - 1 freed, then multiplies its own
  float acc[2][4] = {};
  Frag f0, f1, f2;
  auto step = [&](int i, const Frag& cur, Frag& ahead) {
    if (i >= count) return;
    if (i + 2 * kwarps < count) load_next(ahead);
    frag_products<T>(acc, cur);
  };
  if (kw < count) load_next(f0);
  if (kw + kwarps < count) load_next(f1);
  for (int i = kw; i < count; i += 3 * kwarps) {
    step(i, f0, f2);
    step(i + kwarps, f1, f0);
    step(i + 2 * kwarps, f2, f1);
  }

  // the warp's (T, 32) partial: accumulator (tile t, e) is column
  // 4gq + 2t + e / 2, token 2 i4 + e % 2
  float* part = red + kw * T * tile;
  if (2 * i4 < T)
    *reinterpret_cast<float4*>(part + 2 * i4 * tile + col) = make_float4(acc[0][0], acc[0][2], acc[1][0], acc[1][2]);
  if (2 * i4 + 1 < T)
    *reinterpret_cast<float4*>(part + (2 * i4 + 1) * tile + col) =
        make_float4(acc[0][1], acc[0][3], acc[1][1], acc[1][3]);

  // the block's k-warps, then the K splits of this column tile (one
  // cluster), each summed in a fixed order: block `rank` sums its share of
  // the (T, tile) outputs over every peer in rank order. One split writes
  // out straight away (a plain launch, no cluster).
  __syncthreads();
  const bool alone = gridDim.y == 1;
  for (int e = threadIdx.x; e < T * tile; e += blockDim.x) {
    float sum = red[e];
    for (int k = 1; k < kwarps; ++k) sum += red[k * T * tile + e];
    if (!alone) {
      red[e] = sum;
    } else if (n0 + e % tile < N) {
      out[(size_t)(e / tile) * N + n0 + e % tile] = sum;
    }
  }
  if (alone) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  for (int e = rank * blockDim.x + threadIdx.x; e < T * tile; e += splits * blockDim.x) {
    const int n = n0 + e % tile;
    if (n >= N) continue;
    float v[kMaxCluster];
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p) v[p] = p < splits ? cluster.map_shared_rank(red, p)[e] : 0.0f;
    float sum = v[0];
#pragma unroll
    for (int p = 1; p < kMaxCluster; ++p)
      if (p < splits) sum += v[p];
    out[(size_t)(e / tile) * N + n] = sum;
  }
  cluster.sync();  // no block leaves while a peer reads its partial
}

// out (K, N) bf16, out[k, n] = bf16(fma(q[k, n], d[k / 32, n], -m[k / 32, n])),
// the weights int4_matmul_kernel multiplies by.
//
// What bounds it on the card: bytes (per weight half a byte of q4 read and
// two of bf16 written; d and m add a quarter byte), against ~4 integer and
// f32 instructions a weight. A thread owns kRows byte rows of one group's
// 8-column strip (a group's 16 byte rows x 8 columns): it issues the
// strip's q4 loads (8 bytes a row) and its d and m (two 16-byte loads each,
// once for all its rows) before its first store, then writes each byte row
// as two 16-byte rows of bf16 (the low nibbles' K row and the high
// nibbles'). Neighbouring threads take neighbouring strips of one byte row,
// so every warp-wide load and store is one contiguous run (a 16-column
// strip a thread reads 16-byte q4 vectors but stores half sectors: twice
// the L2 write requests, and slower). dequant_rows, the plan, gives a
// thread the most rows that still leave every SM kDequantFill threads; its
// pick lies within a few percent of the best one-call time at each layer
// leaf (tools/wrapper_times.py --rows, PERF.md): the big leaves run near
// the streaming ceiling and the small ones pay the launch.
template <int kRows>
__global__ void __launch_bounds__(256) int4_dequant_kernel(const uint8_t* __restrict__ q4, const float* __restrict__ d,
                                                           const float* __restrict__ m,
                                                           __nv_bfloat16* __restrict__ out, int K, int N) {
  constexpr int kParts = kHalf / kRows;
  const int strips = N / kCols;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)(K / kGroup) * kParts * strips) return;
  const int n0 = (int)(i % strips) * kCols;
  const int rest = (int)(i / strips);
  const int g = rest / kParts;
  const int j0 = (rest % kParts) * kRows;  // the strip's first byte row, 0 .. 15
  uint2 raw[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    raw[r] = __ldg(reinterpret_cast<const uint2*>(q4 + (size_t)(g * kHalf + j0 + r) * N + n0));
  }
  const float4* dv = reinterpret_cast<const float4*>(d + (size_t)g * N + n0);
  const float4* mv = reinterpret_cast<const float4*>(m + (size_t)g * N + n0);
  const float4 d0 = __ldg(dv), d1 = __ldg(dv + 1), m0 = __ldg(mv), m1 = __ldg(mv + 1);
  const float dg[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
  const float neg_m[8] = {-m0.x, -m0.y, -m0.z, -m0.w, -m1.x, -m1.y, -m1.z, -m1.w};
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const uint32_t words[2] = {raw[r].x, raw[r].y};
    uint32_t lo[4], hi[4];  // bf16 pairs of columns (2c, 2c + 1)
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const uint32_t nl = words[w] & 0x0F0F0F0Fu;
      const uint32_t nh = (words[w] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // nibbles as exact floats, as dequant_word: 2^23 + q, minus 2^23
        const int c = 4 * w + 2 * h;
        const float l0 = __int_as_float(__byte_perm(nl, 0x4B000000u, 0x7540u | (2 * h))) - 8388608.0f;
        const float l1 = __int_as_float(__byte_perm(nl, 0x4B000000u, 0x7540u | (2 * h + 1))) - 8388608.0f;
        const float h0 = __int_as_float(__byte_perm(nh, 0x4B000000u, 0x7540u | (2 * h))) - 8388608.0f;
        const float h1 = __int_as_float(__byte_perm(nh, 0x4B000000u, 0x7540u | (2 * h + 1))) - 8388608.0f;
        lo[c / 2] = pack_f32(fmaf(l0, dg[c], neg_m[c]), fmaf(l1, dg[c + 1], neg_m[c + 1]));
        hi[c / 2] = pack_f32(fmaf(h0, dg[c], neg_m[c]), fmaf(h1, dg[c + 1], neg_m[c + 1]));
      }
    }
    *reinterpret_cast<uint4*>(out + (size_t)(g * kGroup + j0 + r) * N + n0) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(out + (size_t)(g * kGroup + kHalf + j0 + r) * N + n0) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
}

// the dequant plan: byte rows of a group strip per thread (16, 8, 4, 2 or
// 1), the most that still give every SM kDequantFill threads (0: the
// vector kernel does not take n, the scalar one runs)
constexpr int kDequantFill = 1024;

int dequant_rows(int k, int n) {
  if (n % kCols != 0) return 0;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      n_sm = 132;
    }
  }
  const long long strips = (long long)(k / kGroup) * (n / kCols);
  int rows = kHalf;
  while (rows > 1 && strips * (kHalf / rows) < (long long)n_sm * kDequantFill) rows /= 2;
  return rows;
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
int launch(const uint16_t* x, const uint8_t* q4, const float* d, const float* m, float* out, int K, int N, int tile,
           int splits, int kwarps, cudaStream_t s) {
  const int per = (K / kGroup + splits - 1) / splits;
  const bool vec = N % 16 == 0 && ((reinterpret_cast<uintptr_t>(q4) | reinterpret_cast<uintptr_t>(d) |
                                    reinterpret_cast<uintptr_t>(m)) & 15) == 0;
  const int cwarps = tile / kWarpCols;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + tile - 1) / tile), (unsigned)splits, 1);
  cfg.blockDim = dim3((unsigned)(32 * cwarps * kwarps), 1, 1);
  cfg.dynamicSmemBytes = (size_t)kwarps * T * tile * sizeof(float);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = (unsigned)splits;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one split: a plain launch (an implicit cluster of one)
  const auto kernel = vec ? int4_matmul_kernel<T, true> : int4_matmul_kernel<T, false>;
  cudaLaunchKernelEx(&cfg, kernel, x, q4, d, m, out, K, N, per, cwarps);
  return (int)cudaGetLastError();
}

}  // namespace

// x (t, k) bf16, q4 (k/2, n) uint8, d and m (k/32, n) f32 -> out (t, n) f32,
// in one launch: column tiles of `tile` (32, 64 or 128) columns x `splits` K
// splits of whole groups (1..8, every split non-empty; the splits of a tile
// are one cluster), `kwarps` warps per 32 columns sharing a block's groups
// (at most 16 warps a block). ops/int4_matmul.plan chooses all three.
// Requires 1 <= t <= 8, k % 32 == 0, n >= 1 and a 16-byte aligned x;
// n % 16 == 0 with 16-byte aligned q4, d, m loads words and vectors, any
// other leaf single bytes.
extern "C" int rtca_int4_matmul(const void* x, const void* q4, const float* d, const float* m, float* out, int t,
                                int k, int n, int tile, int splits, int kwarps, void* stream) {
  const int groups = k / kGroup;
  if (k % kGroup != 0 || groups < 1 || n < 1 || (tile != 32 && tile != 64 && tile != 128) || splits < 1 ||
      splits > kMaxCluster || kwarps < 1 || kwarps * (tile / kWarpCols) > kMaxWarps ||
      (splits - 1) * ((groups + splits - 1) / splits) >= groups || (reinterpret_cast<uintptr_t>(x) & 15))
    return (int)cudaErrorInvalidValue;  // also: an empty split
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  const uint8_t* w = static_cast<const uint8_t*>(q4);
  switch (t) {
    case 1: return launch<1>(xb, w, d, m, out, k, n, tile, splits, kwarps, s);
    case 2: return launch<2>(xb, w, d, m, out, k, n, tile, splits, kwarps, s);
    case 3: return launch<3>(xb, w, d, m, out, k, n, tile, splits, kwarps, s);
    case 4: return launch<4>(xb, w, d, m, out, k, n, tile, splits, kwarps, s);
    case 5: return launch<5>(xb, w, d, m, out, k, n, tile, splits, kwarps, s);
    case 6: return launch<6>(xb, w, d, m, out, k, n, tile, splits, kwarps, s);
    case 7: return launch<7>(xb, w, d, m, out, k, n, tile, splits, kwarps, s);
    case 8: return launch<8>(xb, w, d, m, out, k, n, tile, splits, kwarps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q4 (k/2, n) uint8, d and m (k/32, n) f32 -> out (k, n) bf16.
// Requires k % 32 == 0 and 16-byte aligned q4, d, m and out; n % 8 == 0
// takes the vector kernel with `rows` byte rows a thread (1, 2, 4, 8 or
// 16; 0: the plan's, dequant_rows), any other n the scalar one.
extern "C" int rtca_int4_dequant(const void* q4, const float* d, const float* m, void* out, int k, int n, int rows,
                                 void* stream) {
  if (k % kGroup != 0 || n < 1 || (rows != 0 && (rows > kHalf || kHalf % rows != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  if (k == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* w = static_cast<const uint8_t*>(q4);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (n % kCols != 0) {
    const size_t threads = (size_t)(k / 2) * n;
    int4_dequant_scalar_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(w, d, m, o, k, n);
    return (int)cudaGetLastError();
  }
  if (rows == 0) rows = dequant_rows(k, n);
  const unsigned blocks = (unsigned)(((size_t)(k / 2) / rows * (n / kCols) + 255) / 256);
  switch (rows) {
    case 16: int4_dequant_kernel<16><<<blocks, 256, 0, s>>>(w, d, m, o, k, n); break;
    case 8: int4_dequant_kernel<8><<<blocks, 256, 0, s>>>(w, d, m, o, k, n); break;
    case 4: int4_dequant_kernel<4><<<blocks, 256, 0, s>>>(w, d, m, o, k, n); break;
    case 2: int4_dequant_kernel<2><<<blocks, 256, 0, s>>>(w, d, m, o, k, n); break;
    default: int4_dequant_kernel<1><<<blocks, 256, 0, s>>>(w, d, m, o, k, n); break;
  }
  return (int)cudaGetLastError();
}

// the byte rows of a group strip that one thread of the dequant kernel
// dequantizes at (k, n) under the plan: 16, 8, 4, 2 or 1, or 0 where the
// scalar kernel runs
extern "C" int rtca_int4_dequant_rows(int k, int n) { return k % kGroup != 0 || n < 1 ? 0 : dequant_rows(k, n); }
