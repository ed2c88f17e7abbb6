// Causal flash attention, backward (kernel B4's dq and dk/dv), in f32, head
// dim 64 or 128: the gradient of the f32 forward in flash_attention_f32.cu
// (training and scoring at compute_dtype="float32"). The bf16 kernels are in
// flash_attention_bwd.cu.
//
// Replaces, like the bf16 kernels, the backward of the Pallas TPU kernel
// behind realtime_codec_agent_tpu/ops/nn.py _flash_pallas_named_fn: JAX's
// stock _flash_attention_bwd_dkv (:376) and _flash_attention_bwd_dq (:385),
// which take f32 as well as bf16. Same contract as the bf16 kernels and the
// plain flash_causal_attention_bwd: q, out, dO (B, T, H, Dh), k, v (B, T,
// KH, Dh) read unrepeated (query head h reads KV head h / (H / KH)), lse
// (B, H, T) from the forward, valid (B, T) uint8 or null;
//
//   delta_i = sum_d dO_id O_id
//   P_ij    = exp(S_ij * scale - lse_i)      live (i, j) only, else 0
//   dV_j    = sum_i P_ij dO_i          dP_ij = dO_i . V_j
//   dS_ij   = P_ij (dP_ij - delta_i) * scale
//   dQ_i    = sum_j dS_ij K_j          dK_j  = sum_i dS_ij Q_i
//
// (i, j) is live iff j <= i < T and valid[b, j] != 0: a row with no live key
// gets P = 0 everywhere, so dQ = 0, whatever its lse.
//
// What bounds it on the card: operations, on the f32 units (the tensor
// cores take no full-precision f32 operand, and TF32 would not be
// token-exact): dq runs 3 causal products (S, dP, dQ), dk/dv 4 (S, dP, dV,
// dK), 2 B H (T^2 / 2) Dh FLOP each against 67 TFLOP/s.
//
// Design (csrc/flash_f32_simt.cuh, register-tiled SIMT; 256 threads a
// block, a thread's 4 x 4 scores and 4 rows x Dh / 16 dims of each output):
// - dq kernel: one block per (64-query tile, head, batch row), the tile
//   index the grid's slowest axis, longest first. Q and dO land once (with
//   the key tile 0 pair); it writes delta for its rows first (the dk/dv
//   kernel, launched after it on the same stream, reads it), then walks the
//   key tiles from 0 to the diagonal, K and V through two cp.async stages:
//   S = Q K^T and dP = dO V^T on dot_tile, dS into shared memory, dQ += dS K
//   on acc_tile, dQ in registers.
// - dk/dv kernel: one block per (64-key tile, KV head, batch row), the key
//   tile the grid's slowest axis (tile 0 sees every query tile). K and V
//   land once; the Q and dO tiles of the H / KH query heads stream through
//   two cp.async stages with their lse and delta, from the diagonal tile to
//   the last, head by head: S^T = K Q^T and dP^T = V dO^T (keys as rows),
//   P^T and dS^T into shared memory for dV += P^T dO and dK += dS^T Q (at
//   Dh 128 in one buffer, dS^T after dV's product: two 64-row tiles of K
//   and V, four of the ring and one P buffer already fill 217 KB).
// - Where the grid would leave the card unbalanced (few batch rows x KV
//   heads: Qwen2.5's 2 at batch 1 or 2, where tile 0's 6 x 32 query tiles
//   set the time), each key tile's (head, query tile) list is split over a
//   cluster of 2 to 8 blocks: the fewest splits whose longest block is no
//   longer than the card's average work a block slot (dkv_splits), and the
//   blocks' partial dK/dV are summed by block 0 in rank order through
//   distributed shared memory.
// Every output element is summed by one thread in a fixed order (the
// heads of a KV head in order, the cluster's partials in rank order), no
// atomics: two launches give bitwise-equal dq, dk, dv and delta.
#include <cooperative_groups.h>

#include "flash_f32_simt.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSplits = 8;  // dk/dv cluster size (portable)

// dk/dv's dot_tile unroll: whole at Dh 64; 4 at Dh 128, where unrolling it
// whole beside acc_tile's whole loop and dK and dV's accumulators spills
// (measured on the card: PERF.md's findings)
template <int kD>
constexpr int kDkvDotUnroll = kD == 64 ? kD / 4 : 4;

template <int kD>
struct BwdF32Smem {
  using L = SimtTile<kD>;
  // dk/dv's P^T and dS^T: two buffers (two barriers a tile) where they fit,
  // one (four barriers) at Dh 128, where two would pass 227 KB
  static constexpr int kDkvBufs = kD == 64 ? 2 : 1;
  // dq: Q, dO, two stages of (K, V), dS; dk/dv: K, V, two stages of (Q,
  // dO), P^T and dS^T, then the lse and delta of both stages
  static constexpr int kDq = (int)sizeof(float) * (6 * L::kFloats + L::kPFloats);
  static constexpr int kDkv = (int)sizeof(float) * (6 * L::kFloats + kDkvBufs * L::kPFloats + 2 * 2 * kTile);
};

template <int kD>
__global__ void __launch_bounds__(kSimtThreads, 1) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ out, const float* __restrict__ dout, const float* __restrict__ lse,
    const uint8_t* __restrict__ valid, float* __restrict__ dq, float* __restrict__ delta, int T, int H, int KH,
    float scale) {
  using L = SimtTile<kD>;
  constexpr int kE = L::kE;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int i0 = qt * kTile;
  const int ty = simt_ty();
  const int tx = simt_tx();

  extern __shared__ __align__(16) float smem_bwd_f32[];
  float* sQ = smem_bwd_f32;
  float* sDO = smem_bwd_f32 + L::kFloats;
  auto sK = [&](int st) { return smem_bwd_f32 + (2 + 2 * st) * L::kFloats; };
  auto sV = [&](int st) { return smem_bwd_f32 + (3 + 2 * st) * L::kFloats; };
  float* sDS = smem_bwd_f32 + 6 * L::kFloats;
  __shared__ uint32_t sLive[2][2];
  __shared__ float sDelta[kTile];

  const size_t q_stride = (size_t)H * kD;
  const size_t kv_stride = (size_t)KH * kD;
  const size_t q_off = (size_t)b * T * q_stride + (size_t)h * kD;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)(h / (H / KH)) * kD;

  stage_rows<kD>(sQ, q + q_off, i0, T, q_stride);
  stage_rows<kD>(sDO, dout + q_off, i0, T, q_stride);
  stage_rows<kD>(sK(0), k + kv_off, 0, T, kv_stride);
  stage_rows<kD>(sV(0), v + kv_off, 0, T, kv_stride);
  cp_async_commit();
  store_live(sLive[0], threadIdx.x < kTile && key_live(valid, b, T, threadIdx.x));

  {  // delta of the tile's rows: thread t sums float4s t % 4 + 4i of row t / 4
     // of dO * O, then two shuffles
    const int r = threadIdx.x >> 2;
    const int part = threadIdx.x & 3;
    const int row = i0 + r;
    float s = 0.0f;
    if (row < T) {
      const float4* g4 = reinterpret_cast<const float4*>(dout + q_off + (size_t)row * q_stride);
      const float4* o4 = reinterpret_cast<const float4*>(out + q_off + (size_t)row * q_stride);
#pragma unroll
      for (int i = 0; i < kD / 16; ++i) s = dot4(g4[part + 4 * i], o4[part + 4 * i], s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) {
      sDelta[r] = s;
      if (row < T) delta[((size_t)b * H + h) * T + row] = s;
    }
  }
  __syncthreads();
  float dlt[4], lse_r[4];  // of the thread's rows
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = i0 + ty + 16 * a;
    dlt[a] = sDelta[ty + 16 * a];
    lse_r[a] = row < T ? lse[((size_t)b * H + h) * T + row] : 0.0f;
  }

  float4 acc[4][kE];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[a][e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every thread is done with tile kt - 1's stage and dS
    const bool more = kt < qt;
    bool next_live = false;
    if (more) {
      const int k1 = (kt + 1) * kTile;
      stage_rows<kD>(sK(st ^ 1), k + kv_off, k1, T, kv_stride);
      stage_rows<kD>(sV(st ^ 1), v + kv_off, k1, T, kv_stride);
      cp_async_commit();
      next_live = threadIdx.x < kTile && key_live(valid, b, T, k1 + threadIdx.x);
    }
    float s[4][4] = {};
    float dp[4][4] = {};
    dot_tile<kD>(s, sQ, sK(st), ty, tx);
    dot_tile<kD>(dp, sDO, sV(st), ty, tx);
    if (more) store_live(sLive[st ^ 1], next_live);  // the load was issued before the products
    uint32_t on = col_bits(live_mask(sLive[st]), tx) * 0x1111u;  // bit 4a + c: (a, c) is live
    if (kt == qt) on = causal_bits<false>(on, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = on_bit(on, a, c) ? prob(s[a][c], scale, lse_r[a]) : 0.0f;
        sDS[r * kLdP + tx + 16 * c] = p * (dp[a][c] - dlt[a]) * scale;
      }
    }
    __syncthreads();  // dS complete
    acc_tile<kD>(acc, sDS, sK(st), ty, tx);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = i0 + ty + 16 * a;
    if (row >= T) continue;
#pragma unroll
    for (int e = 0; e < kE; ++e) *reinterpret_cast<float4*>(dq + q_off + chunk_off(row, q_stride, tx, e)) = acc[a][e];
  }
}

template <int kD>
__global__ void __launch_bounds__(kSimtThreads, 1) flash_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ valid, float* __restrict__ dk, float* __restrict__ dv, int T, int H, int KH,
    float scale, int splits) {
  using L = SimtTile<kD>;
  constexpr int kE = L::kE;
  // x: the block's rank in its cluster of splits; the key tile on z puts
  // every KV head's longest work first
  const int split = blockIdx.x;
  const int kh = blockIdx.y % KH;
  const int b = blockIdx.y / KH;
  const int kt = blockIdx.z;
  const int k0 = kt * kTile;
  const int ty = simt_ty();
  const int tx = simt_tx();
  const int n_rep = H / KH;
  const int per_head = (T + kTile - 1) / kTile - kt;  // query tiles kt .. the last
  const int n_tiles = n_rep * per_head;                // tile n: head n / per_head, query tile kt + n % per_head
  const int n_lo = (int)((long long)split * n_tiles / splits);
  const int n_hi = (int)((long long)(split + 1) * n_tiles / splits);

  extern __shared__ __align__(16) float smem_bwd_f32[];
  float* sK = smem_bwd_f32;
  float* sV = smem_bwd_f32 + L::kFloats;
  auto sQ = [&](int st) { return smem_bwd_f32 + (2 + 2 * st) * L::kFloats; };
  auto sDO = [&](int st) { return smem_bwd_f32 + (3 + 2 * st) * L::kFloats; };
  constexpr int kBufs = BwdF32Smem<kD>::kDkvBufs;
  float* sP = smem_bwd_f32 + 6 * L::kFloats;
  float* sDS = sP + (kBufs - 1) * L::kPFloats;
  float* sStat = sP + kBufs * L::kPFloats;
  auto sLse = [&](int st) { return sStat + 2 * kTile * st; };
  auto sDelta = [&](int st) { return sStat + 2 * kTile * st + kTile; };

  const size_t q_stride = (size_t)H * kD;
  const size_t kv_stride = (size_t)KH * kD;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)kh * kD;

  auto issue = [&](int n, int st) {  // tile n's Q, dO, lse and delta into stage st
    const int h = kh * n_rep + n / per_head;
    const int i0 = (kt + n % per_head) * kTile;
    const size_t q_off = (size_t)b * T * q_stride + (size_t)h * kD;
    stage_rows<kD>(sQ(st), q + q_off, i0, T, q_stride);
    stage_rows<kD>(sDO(st), dout + q_off, i0, T, q_stride);
    if (threadIdx.x < 2 * kTile) {
      const int c = threadIdx.x & (kTile - 1);
      const size_t stat = ((size_t)b * H + h) * T + i0;
      const bool in = i0 + c < T;
      const float* src = threadIdx.x < kTile ? lse : delta;
      cp_async4((threadIdx.x < kTile ? sLse(st) : sDelta(st)) + c, src + stat + (in ? c : 0), in);
    }
    cp_async_commit();
  };

  if (n_lo < n_hi) {  // a cluster's block may have no tile (T of a tile or two)
    stage_rows<kD>(sK, k + kv_off, k0, T, kv_stride);
    stage_rows<kD>(sV, v + kv_off, k0, T, kv_stride);
    issue(n_lo, 0);
  }
  uint32_t keys_on = 0;  // bits 4a .. 4a + 3: the thread's key row a is live
#pragma unroll
  for (int a = 0; a < 4; ++a) keys_on |= key_live(valid, b, T, k0 + ty + 16 * a) ? 0xFu << (4 * a) : 0u;

  float4 dk_acc[4][kE], dv_acc[4][kE];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      dk_acc[a][e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dv_acc[a][e] = dk_acc[a][e];
    }

  for (int n = n_lo; n < n_hi; ++n) {
    const int st = (n - n_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile n landed; every thread is done with tile n - 1's stage and P / dS
    if (n + 1 < n_hi) issue(n + 1, st ^ 1);
    const int i0 = (kt + n % per_head) * kTile;
    float s[4][4] = {};
    float dp[4][4] = {};
    dot_tile<kD, kDkvDotUnroll<kD>>(s, sK, sQ(st), ty, tx);  // S^T: keys x queries
    dot_tile<kD, kDkvDotUnroll<kD>>(dp, sV, sDO(st), ty, tx);  // dP^T
    uint32_t on = keys_on;  // bit 4a + c: (a, c) is live
    if (i0 + kTile > T) {  // the last query tile: queries past T
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (i0 + tx + 16 * c >= T) on &= ~(0x1111u << c);
    }
    if (i0 == k0) on = causal_bits<true>(on, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ci = tx + 16 * c;
        const float p = on_bit(on, a, c) ? prob(s[a][c], scale, sLse(st)[ci]) : 0.0f;
        dp[a][c] = p * (dp[a][c] - sDelta(st)[ci]) * scale;  // dS^T
        s[a][c] = p;
        sP[r * kLdP + ci] = s[a][c];
        if (kBufs == 2) sDS[r * kLdP + ci] = dp[a][c];
      }
    }
    __syncthreads();  // P^T (and dS^T) complete
    acc_tile<kD>(dv_acc, sP, sDO(st), ty, tx);
    if (kBufs == 1) {
      __syncthreads();  // every thread is done with P^T
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sDS[(ty + 16 * a) * kLdP + tx + 16 * c] = dp[a][c];
      __syncthreads();  // dS^T complete
    }
    acc_tile<kD>(dk_acc, sDS, sQ(st), ty, tx);
  }

  if (splits > 1) {
    // the cluster's partial dK and dV, summed by block 0 in rank order
    // through distributed shared memory; each block's partials go to its
    // ring, which it no longer reads (thread-major float4s: conflict-free)
    cg::cluster_group cluster = cg::this_cluster();
    float4* part = reinterpret_cast<float4*>(sQ(0));
    constexpr int kN = 4 * kE;  // float4s a thread, each of dK and dV
    __syncthreads();  // the ring's last reads are done
    if (split != 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          part[(a * kE + e) * kSimtThreads + threadIdx.x] = dk_acc[a][e];
          part[(kN + a * kE + e) * kSimtThreads + threadIdx.x] = dv_acc[a][e];
        }
    }
    cluster.sync();
    if (split == 0) {
      for (int rk = 1; rk < splits; ++rk) {
        const float4* peer = cluster.map_shared_rank(part, rk);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            const float4 pk = peer[(a * kE + e) * kSimtThreads + threadIdx.x];
            const float4 pv = peer[(kN + a * kE + e) * kSimtThreads + threadIdx.x];
            dk_acc[a][e] = make_float4(dk_acc[a][e].x + pk.x, dk_acc[a][e].y + pk.y, dk_acc[a][e].z + pk.z,
                                       dk_acc[a][e].w + pk.w);
            dv_acc[a][e] = make_float4(dv_acc[a][e].x + pv.x, dv_acc[a][e].y + pv.y, dv_acc[a][e].z + pv.z,
                                       dv_acc[a][e].w + pv.w);
          }
      }
    }
    cluster.sync();  // no block leaves while block 0 reads its partials
  }
  if (split != 0) return;

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= T) continue;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const size_t off = kv_off + chunk_off(key, kv_stride, tx, e);
      *reinterpret_cast<float4*>(dk + off) = dk_acc[a][e];
      *reinterpret_cast<float4*>(dv + off) = dv_acc[a][e];
    }
  }
}

bool bad_shape(int B, int T, int H, int KH, int Dh) {
  return B < 1 || T < 1 || KH < 1 || H % KH != 0 || H > 65535 || B > 65535 || (long long)KH * B > 65535 ||
         (T + kTile - 1) / kTile > 65535 || (Dh != 64 && Dh != 128);
}

template <int kD>
int launch_dq(const float* q, const float* k, const float* v, const float* out, const float* dout,
              const float* lse, const uint8_t* valid, float* dq, float* delta, int B, int T, int H, int KH,
              float scale, cudaStream_t st) {
  constexpr int kSmem = BwdF32Smem<kD>::kDq;
  static bool attr_set = false;
  const cudaError_t e = allow_smem(flash_bwd_dq_f32_kernel<kD>, kSmem, attr_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (T + kTile - 1) / kTile);
  flash_bwd_dq_f32_kernel<kD><<<grid, kSimtThreads, kSmem, st>>>(q, k, v, out, dout, lse, valid, dq, delta, T, H,
                                                                 KH, scale);
  return (int)cudaGetLastError();
}

// the dk/dv kernel's dynamic shared memory, set once, and the blocks the
// card holds at once at its occupancy (0 on an error)
template <int kD>
int dkv_slots() {
  static int slots = 0;
  static bool attr_set = false;
  if (slots == 0 && allow_smem(flash_bwd_dkv_f32_kernel<kD>, BwdF32Smem<kD>::kDkv, attr_set) == cudaSuccess) {
    int dev = 0, n_sm = 0, occ = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, flash_bwd_dkv_f32_kernel<kD>, kSimtThreads,
                                                      BwdF32Smem<kD>::kDkv) == cudaSuccess) {
      slots = n_sm * occ;
    }
  }
  return slots;
}

// dk/dv splits: the fewest (a power of two up to kMaxSplits) whose longest
// block, key tile 0 with all (n_rep x n_qt) query tiles over s blocks, is no
// longer than the card's average work a slot, (n_rep x n_qt (n_qt + 1) / 2
// x KH x B) / slots tiles, i.e. s KH B (n_qt + 1) >= 2 slots. n_rep cancels,
// so the plan needs no H.
int dkv_splits(int B, int T, int KH, int slots) {
  const long long n_qt = (T + kTile - 1) / kTile;
  int s = 1;
  while (s < kMaxSplits && s * (long long)KH * B * (n_qt + 1) < 2LL * slots) s *= 2;
  return s;
}

template <int kD>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout, const float* lse,
               const float* delta, const uint8_t* valid, float* dk, float* dv, int B, int T, int H, int KH,
               float scale, int splits, cudaStream_t st) {
  const int slots = dkv_slots<kD>();
  if (slots == 0) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidValue);
  }
  if (splits == 0) splits = dkv_splits(B, T, KH, slots);
  if (splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((unsigned)splits, (unsigned)(KH * B), (unsigned)((T + kTile - 1) / kTile));
  cfg.blockDim = dim3(kSimtThreads, 1, 1);
  cfg.dynamicSmemBytes = BwdF32Smem<kD>::kDkv;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, flash_bwd_dkv_f32_kernel<kD>, q, k, v, dout, lse, delta, valid, dk, dv, T, H, KH, scale,
                     splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dq (B, T, H, Dh) and delta (B, H, T) f32 from q, k, v, out, dout (B, T, H,
// Dh), lse (B, H, T) f32, valid (B, T) uint8 or null; k, v (B, T, KH, Dh);
// Dh 64 or 128, every tensor contiguous and 16-byte aligned. Launch before
// rtca_flash_attention_bwd_dkv_f32 on the same stream: that kernel reads
// delta.
extern "C" int rtca_flash_attention_bwd_dq_f32(const float* q, const float* k, const float* v, const float* out,
                                               const float* dout, const float* lse, const uint8_t* valid, float* dq,
                                               float* delta, int B, int T, int H, int KH, int Dh, float scale,
                                               void* stream) {
  if (bad_shape(B, T, H, KH, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return Dh == 64 ? launch_dq<64>(q, k, v, out, dout, lse, valid, dq, delta, B, T, H, KH, scale, st)
                  : launch_dq<128>(q, k, v, out, dout, lse, valid, dq, delta, B, T, H, KH, scale, st);
}

// dk, dv (B, T, KH, Dh) f32 from q, k, v, dout (as above), lse and delta
// (B, H, T) f32 (delta from rtca_flash_attention_bwd_dq_f32), valid or null.
// splits: the blocks (one cluster) that share a key tile's (head, query
// tile) list, 1 .. 8, or 0 for the kernel's own choice
// (rtca_flash_attention_bwd_dkv_f32_splits).
extern "C" int rtca_flash_attention_bwd_dkv_f32(const float* q, const float* k, const float* v, const float* dout,
                                                const float* lse, const float* delta, const uint8_t* valid, float* dk,
                                                float* dv, int B, int T, int H, int KH, int Dh, float scale,
                                                int splits, void* stream) {
  if (bad_shape(B, T, H, KH, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return Dh == 64 ? launch_dkv<64>(q, k, v, dout, lse, delta, valid, dk, dv, B, T, H, KH, scale, splits, st)
                  : launch_dkv<128>(q, k, v, dout, lse, delta, valid, dk, dv, B, T, H, KH, scale, splits, st);
}

// the splits the f32 dk/dv kernel picks for a shape (0 for a shape it refuses)
extern "C" int rtca_flash_attention_bwd_dkv_f32_splits(int B, int T, int KH, int Dh) {
  if (bad_shape(B, T, KH, KH, Dh)) return 0;
  return dkv_splits(B, T, KH, Dh == 64 ? dkv_slots<64>() : dkv_slots<128>());
}
