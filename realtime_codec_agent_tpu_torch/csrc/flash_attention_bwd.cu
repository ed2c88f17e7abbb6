// Causal flash attention, backward (kernel B4's dq and dk/dv), bf16, head
// dim 64 or 128.
//
// Replaces the backward of the Pallas TPU kernel behind
// realtime_codec_agent_tpu/ops/nn.py _flash_pallas_named_fn: JAX's stock
// _flash_attention_bwd_dkv (:376) and _flash_attention_bwd_dq (:385). Given
// q, k, v, the forward's out and lse, and dO (layouts as the forward: q, out,
// dO (B, T, H, Dh), k, v (B, T, KH, Dh), lse (B, H, T) f32), FlashAttention-2:
//
//   delta_i = sum_d dO_id O_id                     (f32)
//   P_ij    = exp(S_ij * scale - lse_i)            live (i, j) only, else 0
//   dV_j    = sum_i P_ij dO_i          dP_ij = dO_i . V_j
//   dS_ij   = P_ij (dP_ij - delta_i) * scale
//   dQ_i    = sum_j dS_ij K_j          dK_j  = sum_i dS_ij Q_i
//
// (i, j) is live iff j <= i, i < T and valid[b, j] != 0 -- the forward's mask,
// multiplicative: a row with no live key has lse = 0 and P exactly 0 (never
// exp(s)), as in the JAX package's _flash_bwd. Grouped-query attention: dK/dV
// of KV head kh sum over its H / KH query heads.
//
// What bounds it on the card: operations. dq needs 3 causal products (S, dP,
// dQ) and dk/dv 4 (S, dP, dV, dK), 7 * 2 * B * H * (T^2 / 2) * Dh FLOP in
// all, against ~67 MB of bf16 inputs and outputs at B = 4, H = 32, KH = 8,
// T = 2048, Dh = 64 (0.24 TFLOP): far above the tensor-core balance point.
//
// Design (sm_90a), two kernels of one warpgroup (128 threads) a block, the
// forward's machinery (csrc/wgmma_common.cuh):
// - Copies: TMA over 4-D tensor maps (Dh, heads, T, B) in 128-byte-swizzled
//   64 x 64 atoms (Dh 128: two side by side), rows past T as zeros, one
//   mbarrier per buffer. Each block loads its fixed pair of tiles once and
//   streams the other pair through a ring of kStages stages: the tile
//   kStages - 1 ahead is in flight while a tile is computed.
// - Products: S and dP on wgmma m64n64k16 with both operands from shared
//   memory (K-major). P and dS are rounded to bf16 in the accumulator
//   registers (the accumulator layout is the A-fragment layout) and are the
//   register A operand of the products into dQ, dK and dV on wgmma
//   m64n{Dh}k16, whose B operand is the same shared tile read through the
//   transpose bit (MN-major), as the forward reads V.
// - dq kernel: one block per (64-query tile, head, batch), longest first
//   across the whole grid (the tile index is the grid's slowest axis). It
//   first writes delta for its 64 rows (read from device memory; the dk/dv
//   kernel, launched after it on the same stream, reads it), then walks the
//   key tiles from 0 to the diagonal through the K/V ring, dQ in registers.
// - dk/dv kernel: one block per (64-key tile, KV head, batch), longest first
//   across the grid. When that grid would leave SMs idle (few batch rows x
//   KV heads: Qwen2.5's 2 at batch 1 or 2), each key tile's query tiles are
//   split over a cluster of 2 to 8 blocks, whose partial dK/dV block 0
//   sums in rank order through distributed shared memory. K and V land once; Q and dO tiles of the H / KH query heads stream
//   through the ring from the diagonal to the end, dK and dV accumulate in
//   registers (128 f32 a thread at Dh 128): S^T = K Q^T and dP^T = V dO^T,
//   both waited for before P^T and dS^T are formed, so the two 64 x 64
//   score tiles are the only other accumulators live. lse and delta of a
//   tile are read one tile ahead with plain loads, while the previous tile
//   is computed.
// - Masks: the diagonal tile and tiles with a dead key (or, in dk/dv, a
//   query past T) take the masked path; the others skip the tests.
// Every output element is summed by one thread in a fixed order, no atomics:
// two launches on the same inputs give bitwise-equal dq, dk and dv.
#include <cooperative_groups.h>

#include "wgmma_common.cuh"

namespace cg = cooperative_groups;

namespace {

// the streamed tiles' ring (tools/flash_bwd_sweep.py builds other depths)
#ifndef RTCA_FLASH_BWD_STAGES
#define RTCA_FLASH_BWD_STAGES 2
#endif
constexpr int kStages = RTCA_FLASH_BWD_STAGES;
constexpr int kMaxSplits = 8;  // dk/dv cluster size (portable)
constexpr float kLog2e = 1.4426950408889634f;

template <int kHd>
struct BwdSmem {
  static constexpr int kAtoms = kHd / 64;
  static constexpr int kTileBytes = kAtoms * kAtomBytes;  // one 64-row tile
  // the fixed pair (dq: Q and dO; dk/dv: K and V), then the ring's pairs; + 1 KB for the alignment
  static constexpr int kBytes = 1024 + kTileBytes * (2 + 2 * kStages);
};

// exp(x * scale - lse) as exp2(x * scale log2 e - lse log2 e): one FMA and
// the MUFU's ex2
__device__ __forceinline__ float exp_shifted(float x, float scale_l2, float lse_l2) {
  return exp2f(fmaf(x, scale_l2, -lse_l2));
}

// dS = P * (dP - delta) * scale in place of dP, P in place of S (the dq
// kernel: rows r0 and r0 + 8 of this thread, key columns). kMasked tests
// every entry (the diagonal tile and tiles that hold a dead key): a dead
// entry has P = 0.
template <bool kMasked>
__device__ __forceinline__ void ds_rows(float (&s)[8][4], float (&dp)[8][4], const float (&lse_l2)[2],
                                        const float (&delta_r)[2], float scale, float scale_l2,
                                        uint32_t mine, bool diag, int k0, const int (&row)[2], int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const bool on = !kMasked || ((!diag || k0 + 8 * j + 2 * t4 + (e & 1) <= row[i]) && col_bit(mine, j, e));
      const float p = on ? exp_shifted(s[j][e], scale_l2, lse_l2[i]) : 0.0f;
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - delta_r[i]) * scale;
    }
  }
}

// P^T in place of S^T and dS^T in place of dP^T (the dk/dv kernel: rows are
// keys r0 and r0 + 8 of this thread, columns queries q0 + c). stat holds the
// tile's lse * log2 e (stat[0]) and delta (stat[1]) by column. kMasked tests
// every entry (the diagonal tile, a tile past T, a block with a dead key).
template <bool kMasked>
__device__ __forceinline__ void ds_cols(float (&st)[8][4], float (&dpt)[8][4], const float (*stat)[kTile],
                                        float scale, float scale_l2, const bool (&live_k)[2],
                                        const int (&key)[2], int q0, int T, int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t4;
    const float2 l2 = *reinterpret_cast<const float2*>(&stat[0][c]);
    const float2 dl = *reinterpret_cast<const float2*>(&stat[1][c]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qc = q0 + c + (e & 1);
      const int i = e >> 1;
      const bool on = !kMasked || (live_k[i] && key[i] <= qc && qc < T);
      const float p = on ? exp_shifted(st[j][e], scale_l2, (e & 1) ? l2.y : l2.x) : 0.0f;
      st[j][e] = p;
      dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? dl.y : dl.x)) * scale;
    }
  }
}

template <int kHd>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
    const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const uint8_t* __restrict__ valid, __nv_bfloat16* __restrict__ dq,
    float* __restrict__ delta, int T, int H, int KH, float scale) {
  using L = BwdSmem<kHd>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];  // Q and dO, then one per K/V stage
  __shared__ float sDelta[kTile];
  __shared__ uint32_t sLive[2][2];  // key validity of tile kt, by kt & 1

  // blocks start in the order of their linear index, x fastest: the query
  // tile on z puts every head's longest rows first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * kTile;
  const int kvh = h / (H / KH);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's 1 KB period
  const uint32_t sQ = base;
  const uint32_t sDO = base + L::kTileBytes;
  auto sK = [&](int st) { return base + (uint32_t)((2 + st) * L::kTileBytes); };
  auto sV = [&](int st) { return base + (uint32_t)((2 + kStages + st) * L::kTileBytes); };
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto bar_kv = [&](int st) { return smem_u32(&bars[1 + st]); };

  auto issue_kv = [&](int kt) {  // thread 0: K and V of key tile kt into stage kt % kStages
    const int st = kt % kStages;
    mbar_expect(bar_kv(st), 2 * L::kTileBytes);
#pragma unroll
    for (int a = 0; a < L::kAtoms; ++a) {
      tma_load(sK(st) + a * kAtomBytes, &map_k, 64 * a, kvh, kt * kTile, b, bar_kv(st));
      tma_load(sV(st) + a * kAtomBytes, &map_v, 64 * a, kvh, kt * kTile, b, bar_kv(st));
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(smem_u32(&bars[i]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar_q, 2 * L::kTileBytes);
#pragma unroll
    for (int a = 0; a < L::kAtoms; ++a) {
      tma_load(sQ + a * kAtomBytes, &map_q, 64 * a, h, q0, b, bar_q);
      tma_load(sDO + a * kAtomBytes, &map_do, 64 * a, h, q0, b, bar_q);
    }
    for (int kt = 0; kt < kStages - 1 && kt <= qt; ++kt) issue_kv(kt);
  }

  const size_t stat_off = ((size_t)b * H + h) * T;
  {
    // delta while the tiles land: two threads per row, kHd / 2 columns each,
    // O and dO read from device memory
    const int r = threadIdx.x >> 1;
    const int c0 = (threadIdx.x & 1) * (kHd / 2);
    float acc = 0.0f;
    if (q0 + r < T) {
      const size_t off = (((size_t)b * T + q0 + r) * H + h) * kHd + c0;
#pragma unroll
      for (int c = 0; c < kHd / 2; c += 8) {
        const int4 ov = __ldg(reinterpret_cast<const int4*>(out + off + c));
        const int4 dv = __ldg(reinterpret_cast<const int4*>(dout + off + c));
        const __nv_bfloat16* o8 = reinterpret_cast<const __nv_bfloat16*>(&ov);
        const __nv_bfloat16* d8 = reinterpret_cast<const __nv_bfloat16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(__bfloat162float(d8[e]), __bfloat162float(o8[e]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((threadIdx.x & 1) == 0) {
      sDelta[r] = acc;
      if (q0 + r < T) delta[stat_off + q0 + r] = acc;
    }
  }
  // threads 0..63: the validity of key kt * 64 + threadIdx.x, one tile ahead
  auto key_live = [&](int key) {
    return key < T && (valid == nullptr || valid[(size_t)b * T + key] != 0);
  };
  bool live_next = threadIdx.x < kTile && key_live(threadIdx.x);
  __syncthreads();

  const float scale_l2 = scale * kLog2e;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8 of the tile
  int row[2];
  float lse_l2[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + r0 + 8 * i;
    lse_l2[i] = row[i] < T ? lse[stat_off + row[i]] * kLog2e : 0.0f;
    delta_r[i] = sDelta[r0 + 8 * i];
  }
  float acc[kHd / 8][4];
#pragma unroll
  for (int j = 0; j < kHd / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  mbar_wait(bar_q, 0);
  __syncwarp();

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    const int st = kt % kStages;
    const bool diag = kt == qt;
    if (threadIdx.x < kTile) {  // two whole warps
      const uint32_t word = __ballot_sync(0xffffffffu, live_next);
      if (lane == 0) sLive[kt & 1][warp] = word;
    }
    __syncthreads();  // every thread is past tile kt - 1: its stage may be refilled
    if (threadIdx.x == 0 && kt + kStages - 1 <= qt) issue_kv(kt + kStages - 1);
    if (threadIdx.x < kTile && kt < qt) live_next = key_live(k0 + kTile + threadIdx.x);
    const uint64_t live = live_mask(sLive[kt & 1]);
    mbar_wait(bar_kv(st), (uint32_t)((kt / kStages) & 1));
    __syncwarp();

    // S = Q K^T and dP = dO V^T, one commit group
    float s[8][4], dp[8][4];
    wgmma_ss_abt<kHd>(s, sQ, sK(st));
    wgmma_ss_abt<kHd>(dp, sDO, sV(st));
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    if (diag || live != kAllLive) {  // the same for the whole block
      ds_rows<true>(s, dp, lse_l2, delta_r, scale, scale_l2, thread_bits(live, t4), diag, k0, row, t4);
    } else {
      ds_rows<false>(s, dp, lse_l2, delta_r, scale, scale_l2, 0u, diag, k0, row, t4);
    }

    // dQ += dS K (dS rounded to bf16; K MN-major)
    uint32_t da[4][4];
    pack_a(dp, da);
    wgmma_rs_tile<kHd>(acc, da, sK(st));
    wgmma_commit();
    wgmma_wait();
    fence_frags(da);
    fence_regs(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= T) continue;
    __nv_bfloat16* drow = dq + (((size_t)b * T + row[i]) * H + h) * kHd;
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j) {
      *reinterpret_cast<uint32_t*>(drow + 8 * j + 2 * t4) = pack_f32(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

template <int kHd>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
    const float* __restrict__ lse, const float* __restrict__ delta, const uint8_t* __restrict__ valid,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int T, int H, int KH, float scale,
    int splits) {
  using L = BwdSmem<kHd>;
  static_assert(2 * kStages * L::kTileBytes >= 2 * (kHd / 8) * 4 * kThreads * 4, "the ring holds the partials");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];  // K and V, then one per Q/dO stage
  __shared__ __align__(16) float sStat[2][2][kTile];   // by tile n & 1: lse * log2 e, delta
  __shared__ uint32_t sLive[2];

  // x: the block's rank in its cluster of splits; the key tile on z puts
  // every KV head's longest work first (tile 0 sees every query tile)
  const int split = blockIdx.x;
  const int kh = blockIdx.y % KH;
  const int b = blockIdx.y / KH;
  const int kt = blockIdx.z;
  const int k0 = kt * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int n_rep = H / KH;
  const int per_head = (T + kTile - 1) / kTile - kt;  // query tiles kt .. the last
  const int n_tiles = n_rep * per_head;                // tile n: head n / per_head, query tile kt + n % per_head
  // this block's tiles: n_lo .. n_hi - 1, the m-th of them in stage m % kStages
  const int n_lo = (int)((long long)split * n_tiles / splits);
  const int n_hi = (int)((long long)(split + 1) * n_tiles / splits);

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = base + L::kTileBytes;
  auto sQ = [&](int st) { return base + (uint32_t)((2 + st) * L::kTileBytes); };
  auto sDO = [&](int st) { return base + (uint32_t)((2 + kStages + st) * L::kTileBytes); };
  const uint32_t bar_kv = smem_u32(&bars[0]);
  auto bar_q = [&](int st) { return smem_u32(&bars[1 + st]); };

  auto issue_q = [&](int n) {  // thread 0: Q and dO of tile n into stage (n - n_lo) % kStages
    const int st = (n - n_lo) % kStages;
    const int h = kh * n_rep + n / per_head;
    const int q0 = (kt + n % per_head) * kTile;
    mbar_expect(bar_q(st), 2 * L::kTileBytes);
#pragma unroll
    for (int a = 0; a < L::kAtoms; ++a) {
      tma_load(sQ(st) + a * kAtomBytes, &map_q, 64 * a, h, q0, b, bar_q(st));
      tma_load(sDO(st) + a * kAtomBytes, &map_do, 64 * a, h, q0, b, bar_q(st));
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(smem_u32(&bars[i]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar_kv, 2 * L::kTileBytes);
#pragma unroll
    for (int a = 0; a < L::kAtoms; ++a) {
      tma_load(sK + a * kAtomBytes, &map_k, 64 * a, kh, k0, b, bar_kv);
      tma_load(sV + a * kAtomBytes, &map_v, 64 * a, kh, k0, b, bar_kv);
    }
    for (int n = n_lo; n < n_lo + kStages - 1 && n < n_hi; ++n) issue_q(n);
  }
  if (threadIdx.x < kTile) {  // the block's key validity, once
    const int key = k0 + threadIdx.x;
    const bool live = key < T && (valid == nullptr || valid[(size_t)b * T + key] != 0);
    const uint32_t word = __ballot_sync(0xffffffffu, live);
    if (lane == 0) sLive[warp] = word;
  }
  // threads 0..63: lse (times log2 e) and delta of query q0 + threadIdx.x of
  // tile n, read one tile ahead; 0 past T
  float lse_next = 0.0f, delta_next = 0.0f;
  auto load_stat = [&](int n) {
    const int q = (kt + n % per_head) * kTile + threadIdx.x;
    const size_t off = ((size_t)b * H + kh * n_rep + n / per_head) * T + q;
    lse_next = q < T ? lse[off] * kLog2e : 0.0f;
    delta_next = q < T ? delta[off] : 0.0f;
  };
  if (threadIdx.x < kTile && n_lo < n_hi) load_stat(n_lo);
  __syncthreads();

  const uint64_t live = live_mask(sLive);
  const bool all_live = live == kAllLive;
  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8 of the tile
  const bool live_k[2] = {bit(live, r0), bit(live, r0 + 8)};
  const int key[2] = {k0 + r0, k0 + r0 + 8};
  const float scale_l2 = scale * kLog2e;
  float dk_acc[kHd / 8][4], dv_acc[kHd / 8][4];
#pragma unroll
  for (int j = 0; j < kHd / 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.0f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.0f;
  }
  mbar_wait(bar_kv, 0);
  __syncwarp();

  for (int n = n_lo; n < n_hi; ++n) {
    const int m = n - n_lo;
    const int st = m % kStages;
    const int qt = kt + n % per_head;
    const int q0 = qt * kTile;
    if (threadIdx.x < kTile) {
      sStat[m & 1][0][threadIdx.x] = lse_next;
      sStat[m & 1][1][threadIdx.x] = delta_next;
    }
    __syncthreads();  // every thread is past tile n - 1: its stage may be refilled
    if (threadIdx.x == 0 && n + kStages - 1 < n_hi) issue_q(n + kStages - 1);
    if (threadIdx.x < kTile && n + 1 < n_hi) load_stat(n + 1);
    mbar_wait(bar_q(st), (uint32_t)((m / kStages) & 1));
    __syncwarp();

    // S^T = K Q^T and dP^T = V dO^T (rows keys, columns queries), one commit group
    float s[8][4], dp[8][4];
    wgmma_ss_abt<kHd>(s, sK, sQ(st));
    wgmma_ss_abt<kHd>(dp, sV, sDO(st));
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    if (qt > kt && q0 + kTile <= T && all_live) {  // the same for the whole block
      ds_cols<false>(s, dp, sStat[m & 1], scale, scale_l2, live_k, key, q0, T, t4);
    } else {
      ds_cols<true>(s, dp, sStat[m & 1], scale, scale_l2, live_k, key, q0, T, t4);
    }

    // dV += P^T dO and dK += dS^T Q (P^T and dS^T rounded to bf16; dO and Q
    // MN-major), one commit group
    uint32_t pa[4][4], da[4][4];
    pack_a(s, pa);
    pack_a(dp, da);
    wgmma_rs_tile<kHd>(dv_acc, pa, sDO(st));
    wgmma_rs_tile<kHd>(dk_acc, da, sQ(st));
    wgmma_commit();
    wgmma_wait();
    fence_frags(pa);
    fence_frags(da);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
  }

  if (splits > 1) {
    // the cluster's partial dK and dV, summed by block 0 in rank order
    // through distributed shared memory; each block's partials go to its
    // ring, which it no longer reads (thread-major: conflict-free)
    cg::cluster_group cluster = cg::this_cluster();
    float* part = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + 2 * L::kTileBytes);
    constexpr int kN = kHd / 8 * 4;  // accumulator values a thread, each of dK and dV
    __syncthreads();  // the ring's last wgmma reads are done
    if (split != 0) {
#pragma unroll
      for (int j = 0; j < kHd / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          part[(4 * j + e) * kThreads + threadIdx.x] = dk_acc[j][e];
          part[(kN + 4 * j + e) * kThreads + threadIdx.x] = dv_acc[j][e];
        }
    }
    cluster.sync();
    if (split == 0) {
      for (int r = 1; r < splits; ++r) {
        const float* peer = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int j = 0; j < kHd / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dk_acc[j][e] += peer[(4 * j + e) * kThreads + threadIdx.x];
            dv_acc[j][e] += peer[(kN + 4 * j + e) * kThreads + threadIdx.x];
          }
      }
    }
    cluster.sync();  // no block leaves while block 0 reads its partials
    if (split != 0) return;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= T) continue;
    const size_t off = (((size_t)b * T + key[i]) * KH + kh) * kHd;
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j + 2 * t4) = pack_f32(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j + 2 * t4) = pack_f32(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

bool bad_shape(int B, int T, int H, int KH, int Dh) {
  return B < 1 || T < 1 || KH < 1 || H % KH != 0 || (long long)KH * B > 65535 || B > 65535 ||
         (T + kTile - 1) / kTile > 65535 || (Dh != 64 && Dh != 128);
}

// the kernel's dynamic shared memory, set once per instantiation
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

template <int kHd>
int launch_dq(const void* q, const void* k, const void* v, const void* out, const void* dout, const float* lse,
              const uint8_t* valid, void* dq, float* delta, int B, int T, int H, int KH, float scale,
              cudaStream_t st) {
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, B, T, H, kHd) || !make_map(&mk, k, B, T, KH, kHd) || !make_map(&mv, v, B, T, KH, kHd) ||
      !make_map(&mdo, dout, B, T, H, kHd)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int kSmem = BwdSmem<kHd>::kBytes;
  static bool attr_set = false;
  const cudaError_t e = allow_smem(flash_bwd_dq_kernel<kHd>, kSmem, attr_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (T + kTile - 1) / kTile);
  flash_bwd_dq_kernel<kHd><<<grid, kThreads, kSmem, st>>>(
      mq, mk, mv, mdo, static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout), lse, valid,
      static_cast<__nv_bfloat16*>(dq), delta, T, H, KH, scale);
  return (int)cudaGetLastError();
}

// the dk/dv kernel's dynamic shared memory, set once, and the blocks the
// card holds at once at its occupancy (0 on an error)
template <int kHd>
int dkv_slots() {
  static int slots = 0;
  static bool attr_set = false;
  if (slots == 0 && allow_smem(flash_bwd_dkv_kernel<kHd>, BwdSmem<kHd>::kBytes, attr_set) == cudaSuccess) {
    int dev = 0, n_sm = 0, occ = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, flash_bwd_dkv_kernel<kHd>, kThreads,
                                                      BwdSmem<kHd>::kBytes) == cudaSuccess) {
      slots = n_sm * occ;
    }
  }
  return slots;
}

// dk/dv splits: the fewest (a power of two up to kMaxSplits) whose blocks
// fill every slot of the card. Grids of fewer blocks (B * KH small:
// Qwen2.5's 2 KV heads at batch 1 or 2) otherwise leave SMs idle while the
// longest block walks all H / KH heads alone.
template <int kHd>
int dkv_splits(int B, int T, int KH, int slots) {
  const long long blocks = (long long)((T + kTile - 1) / kTile) * KH * B;
  int s = 1;
  while (s < kMaxSplits && blocks * s < slots) s *= 2;
  return s;
}

template <int kHd>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               const uint8_t* valid, void* dk, void* dv, int B, int T, int H, int KH, float scale, int splits,
               cudaStream_t st) {
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, B, T, H, kHd) || !make_map(&mk, k, B, T, KH, kHd) || !make_map(&mv, v, B, T, KH, kHd) ||
      !make_map(&mdo, dout, B, T, H, kHd)) {
    return (int)cudaErrorInvalidValue;
  }
  const int slots = dkv_slots<kHd>();
  if (slots == 0) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidValue);
  }
  if (splits == 0) splits = dkv_splits<kHd>(B, T, KH, slots);
  if (splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((unsigned)splits, (unsigned)(KH * B), (unsigned)((T + kTile - 1) / kTile));
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = BwdSmem<kHd>::kBytes;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, flash_bwd_dkv_kernel<kHd>, mq, mk, mv, mdo, lse, delta, valid,
                     static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), T, H, KH, scale, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dq (B, T, H, Dh) bf16 and delta (B, H, T) f32 from q, k, v, out, dout (bf16,
// contiguous, 16-byte aligned, the forward's layouts), lse (B, H, T) f32 and
// valid (B, T) uint8 or null; Dh 64 or 128. Launch before
// rtca_flash_attention_bwd_dkv on the same stream: that kernel reads delta.
extern "C" int rtca_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* out,
                                           const void* dout, const float* lse, const uint8_t* valid, void* dq,
                                           float* delta, int B, int T, int H, int KH, int Dh, float scale,
                                           void* stream) {
  if (bad_shape(B, T, H, KH, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return Dh == 64 ? launch_dq<64>(q, k, v, out, dout, lse, valid, dq, delta, B, T, H, KH, scale, st)
                  : launch_dq<128>(q, k, v, out, dout, lse, valid, dq, delta, B, T, H, KH, scale, st);
}

// dk, dv (B, T, KH, Dh) bf16 from q, k, v, dout (bf16, as above), lse and
// delta (B, H, T) f32, valid (B, T) uint8 or null. splits: the blocks (one
// cluster) that share a key tile's query tiles, 1 .. 8, or 0 for the
// kernel's own choice (rtca_flash_attention_bwd_dkv_splits).
extern "C" int rtca_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                            const float* lse, const float* delta, const uint8_t* valid, void* dk,
                                            void* dv, int B, int T, int H, int KH, int Dh, float scale, int splits,
                                            void* stream) {
  if (bad_shape(B, T, H, KH, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return Dh == 64 ? launch_dkv<64>(q, k, v, dout, lse, delta, valid, dk, dv, B, T, H, KH, scale, splits, st)
                  : launch_dkv<128>(q, k, v, dout, lse, delta, valid, dk, dv, B, T, H, KH, scale, splits, st);
}

// the splits the dk/dv kernel picks for a shape (0 for a shape it refuses)
extern "C" int rtca_flash_attention_bwd_dkv_splits(int B, int T, int KH, int Dh) {
  if (bad_shape(B, T, KH, KH, Dh)) return 0;
  return Dh == 64 ? dkv_splits<64>(B, T, KH, dkv_slots<64>()) : dkv_splits<128>(B, T, KH, dkv_slots<128>());
}
