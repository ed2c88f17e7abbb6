// Causal flash attention, backward (kernel B4's dq and dk/dv), bf16.
//
// Replaces the backward of the Pallas TPU kernel behind
// realtime_codec_agent_tpu/ops/nn.py _flash_pallas_named_fn: JAX's stock
// _flash_attention_bwd_dkv (:376) and _flash_attention_bwd_dq (:385). Given
// q, k, v, the forward's out and lse, and dO (layouts as the forward: q, out,
// dO (B, T, H, 64), k, v (B, T, KH, 64), lse (B, H, T) f32), FlashAttention-2:
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
// What bounds it on the card: 2.5x the forward's FLOP (five products over the
// causal half: S, dP, dV, dQ, dK; S is computed twice, once in each kernel) --
// at B = 4, H = 32, KH = 8, T = 2048 about 0.2 TFLOP per layer for ~67 MB of
// bf16 inputs and outputs, far above the tensor-core balance point.
//
// Design: two kernels, both mma.sync.m16n8k16 bf16 -> f32 with 4 warps of 16
// rows over 64-row tiles, P and dS rounded to bf16 only as operands (the
// accumulator layout of S is the A operand layout, as in the forward).
//   dq kernel: one block per (query tile, head, batch). It first writes
//     delta for its 64 rows (its own pass over dO and O; the dk/dv kernel,
//     launched after it on the same stream, reads it), then walks the key
//     tiles from 0 up to the causal diagonal, accumulating dQ in registers.
//   dk/dv kernel: one block per (key tile, KV head, batch). It holds its K and
//     V fragments in registers and walks the query tiles from the diagonal to
//     the end, for each of the H / KH query heads of its group, so that dK and
//     dV of a KV head accumulate in registers: no (B, T, H, 64) temporary and
//     no atomics. Key tiles launch longest-first (the first tiles see every
//     query tile).
// Every output element is summed by one thread in a fixed order: two launches
// on the same inputs give bitwise-equal dq, dk and dv.
#include "flash_common.cuh"

namespace {

// dS = P * (dP - delta) * scale in place of the dq kernel's scores (rows r0
// and r0 + 8 of this thread, key columns). kMasked tests every entry (the
// diagonal tile and tiles that hold an invalid key): a dead entry has P = 0.
template <bool kMasked>
__device__ __forceinline__ void ds_rows(float (&s)[8][4], const float (&dp)[8][4],
                                        const float (&lse_r)[2], const float (&delta_r)[2],
                                        float scale, uint32_t mine, bool diag, int k0,
                                        const int (&row)[2], int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const bool on = !kMasked || ((!diag || k0 + 8 * j + 2 * t4 + (e & 1) <= row[i]) && col_bit(mine, j, e));
      const float p = on ? expf(s[j][e] * scale - lse_r[i]) : 0.0f;
      s[j][e] = p * (dp[j][e] - delta_r[i]) * scale;
    }
  }
}

// P^T in place of the dk/dv kernel's transposed scores and dS^T in place of
// dP^T (rows: keys r0 and r0 + 8 of this thread; columns: queries q0 ..).
// kMasked tests every entry (the diagonal tile, a tile past T, a tile whose
// keys are not all valid).
template <bool kMasked>
__device__ __forceinline__ void ds_cols(float (&st)[8][4], float (&dpt)[8][4], const float* sLse,
                                        const float* sDelta, float scale, const bool (&live_k)[2],
                                        const int (&key)[2], int q0, int T, int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qc = 8 * j + 2 * t4 + (e & 1);
      const int i = e >> 1;
      const bool on = !kMasked || (live_k[i] && key[i] <= q0 + qc && q0 + qc < T);
      const float p = on ? expf(st[j][e] * scale - sLse[qc]) : 0.0f;
      st[j][e] = p;
      dpt[j][e] = p * (dpt[j][e] - sDelta[qc]) * scale;
    }
  }
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const uint8_t* __restrict__ valid, __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
    int T, int H, int KH, float scale) {
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  __shared__ __align__(16) __nv_bfloat16 sQ[kTile][kRow];
  __shared__ __align__(16) __nv_bfloat16 sDO[kTile][kRow];
  __shared__ __align__(16) __nv_bfloat16 sK[kTile][kRow];
  __shared__ __align__(16) __nv_bfloat16 sV[kTile][kRow];
  __shared__ float sDelta[kTile];
  __shared__ uint32_t sLive[2];

  const size_t q_stride = (size_t)H * kDh;
  const size_t kv_stride = (size_t)KH * kDh;
  const size_t q_off = (size_t)b * T * q_stride + (size_t)h * kDh;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)(h / (H / KH)) * kDh;
  const size_t stat_off = ((size_t)b * H + h) * T;

  load_tile(sQ, q + q_off, q_stride, q0, T);
  load_tile(sDO, dout + q_off, q_stride, q0, T);
  __syncthreads();
  {
    // delta: two threads per row, 32 columns each, O read from device memory
    const int r = threadIdx.x >> 1;
    const int c0 = (threadIdx.x & 1) * 32;
    float acc = 0.0f;
    if (q0 + r < T) {
      const __nv_bfloat16* orow = out + q_off + (size_t)(q0 + r) * q_stride + c0;
#pragma unroll
      for (int c = 0; c < 32; c += 8) {
        const int4 ov = __ldg(reinterpret_cast<const int4*>(orow + c));
        const __nv_bfloat16* o8 = reinterpret_cast<const __nv_bfloat16*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc = fmaf(__bfloat162float(sDO[r][c0 + c + e]), __bfloat162float(o8[e]), acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((threadIdx.x & 1) == 0) {
      sDelta[r] = acc;
      if (q0 + r < T) delta[stat_off + q0 + r] = acc;
    }
  }
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8 of the tile
  uint32_t qa[4][4], da[4][4];
  load_a_frags(qa, sQ, r0, t4);
  load_a_frags(da, sDO, r0, t4);
  float lse_r[2], delta_r[2];
  int row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + r0 + 8 * i;
    lse_r[i] = row[i] < T ? lse[stat_off + row[i]] : 0.0f;
    delta_r[i] = sDelta[r0 + 8 * i];
  }

  float acc[8][4];
  zero(acc);
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous tile
    load_tile(sK, k + kv_off, kv_stride, k0, T);
    load_tile(sV, v + kv_off, kv_stride, k0, T);
    load_live(sLive, valid, b, T, k0);
    __syncthreads();
    const uint64_t live = live_mask(sLive);
    const bool diag = kt == qt;

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_abt(s, qa, sK, g, t4);   // S = Q K^T
    mma_abt(dp, da, sV, g, t4);  // dP = dO V^T
    if (diag || live != kAllLive) {  // the same for the whole block
      ds_rows<true>(s, dp, lse_r, delta_r, scale, thread_bits(live, t4), diag, k0, row, t4);
    } else {
      ds_rows<false>(s, dp, lse_r, delta_r, scale, 0u, diag, k0, row, t4);
    }
    mma_pb(acc, s, sK, g, t4);  // dQ += dS K
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] < T) store_row(dq + q_off + (size_t)row[i] * q_stride, acc, i, t4, 1.0f);
  }
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ valid, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int T, int H, int KH, float scale) {
  const int kt = blockIdx.x;  // longest first: tile 0 sees every query tile
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int n_rep = H / KH;
  const int n_qt = (T + kTile - 1) / kTile;

  __shared__ __align__(16) __nv_bfloat16 sQ[kTile][kRow];
  __shared__ __align__(16) __nv_bfloat16 sDO[kTile][kRow];
  __shared__ __align__(16) __nv_bfloat16 sKV[kTile][kRow];
  __shared__ float sLse[kTile];
  __shared__ float sDelta[kTile];
  __shared__ uint32_t sLive[2];

  const size_t q_stride = (size_t)H * kDh;
  const size_t kv_stride = (size_t)KH * kDh;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)kh * kDh;

  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8 of the tile
  uint32_t ka[4][4], va[4][4];
  load_tile(sKV, k + kv_off, kv_stride, k0, T);
  load_live(sLive, valid, b, T, k0);
  __syncthreads();
  load_a_frags(ka, sKV, r0, t4);
  const uint64_t live = live_mask(sLive);
  const bool live_k[2] = {bit(live, r0), bit(live, r0 + 8)};
  __syncthreads();
  load_tile(sKV, v + kv_off, kv_stride, k0, T);
  __syncthreads();
  load_a_frags(va, sKV, r0, t4);
  const int key[2] = {k0 + r0, k0 + r0 + 8};

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int hr = 0; hr < n_rep; ++hr) {
    const int h = kh * n_rep + hr;
    const size_t q_off = (size_t)b * T * q_stride + (size_t)h * kDh;
    const size_t stat_off = ((size_t)b * H + h) * T;
    for (int qt = kt; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // every warp is done with the previous tile
      load_tile(sQ, q + q_off, q_stride, q0, T);
      load_tile(sDO, dout + q_off, q_stride, q0, T);
      for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        const bool in = q0 + i < T;
        sLse[i] = in ? lse[stat_off + q0 + i] : 0.0f;
        sDelta[i] = in ? delta[stat_off + q0 + i] : 0.0f;
      }
      __syncthreads();

      // below the diagonal tile with every query row inside T
      const bool interior = qt > kt && q0 + kTile <= T;
      float st[8][4], dpt[8][4];  // S^T and dP^T: rows = keys, columns = queries
      zero(st);
      zero(dpt);
      mma_abt(st, ka, sQ, g, t4);    // S^T = K Q^T
      mma_abt(dpt, va, sDO, g, t4);  // dP^T = V dO^T
      if (interior && live == kAllLive) {  // the same for the whole block
        ds_cols<false>(st, dpt, sLse, sDelta, scale, live_k, key, q0, T, t4);
      } else {
        ds_cols<true>(st, dpt, sLse, sDelta, scale, live_k, key, q0, T, t4);
      }
      mma_pb(dv_acc, st, sDO, g, t4);  // dV += P^T dO
      mma_pb(dk_acc, dpt, sQ, g, t4);  // dK += dS^T Q
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] < T) {
      store_row(dk + kv_off + (size_t)key[i] * kv_stride, dk_acc, i, t4, 1.0f);
      store_row(dv + kv_off + (size_t)key[i] * kv_stride, dv_acc, i, t4, 1.0f);
    }
  }
}

bool bad_shape(int B, int T, int H, int KH) {
  return B < 1 || T < 1 || KH < 1 || H % KH != 0 || H > 65535 || B > 65535 || KH > 65535;
}

}  // namespace

// dq (B, T, H, 64) bf16 and delta (B, H, T) f32 from q, k, v, out, dout (bf16,
// contiguous, the forward's layouts), lse (B, H, T) f32 and valid (B, T) uint8
// or null. Launch before rtca_flash_attention_bwd_dkv on the same stream: that
// kernel reads delta.
extern "C" int rtca_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* out, const void* dout, const float* lse,
                                           const uint8_t* valid, void* dq, float* delta, int B,
                                           int T, int H, int KH, float scale, void* stream) {
  if (bad_shape(B, T, H, KH)) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  flash_bwd_dq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), lse, valid, static_cast<__nv_bfloat16*>(dq), delta,
      T, H, KH, scale);
  return (int)cudaGetLastError();
}

// dk, dv (B, T, KH, 64) bf16 from q, k, v, dout (bf16), lse and delta (B, H,
// T) f32, valid (B, T) uint8 or null.
extern "C" int rtca_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse, const float* delta,
                                            const uint8_t* valid, void* dk, void* dv, int B, int T,
                                            int H, int KH, float scale, void* stream) {
  if (bad_shape(B, T, H, KH)) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kTile - 1) / kTile, KH, B);
  flash_bwd_dkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      valid, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), T, H, KH, scale);
  return (int)cudaGetLastError();
}
