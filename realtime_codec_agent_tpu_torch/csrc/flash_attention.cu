// Causal flash attention, forward (kernel B4), with an optional key-validity
// mask.
//
// Replaces the forward of the Pallas TPU kernel behind
// realtime_codec_agent_tpu/ops/nn.py flash_attention_pallas (:284) ->
// _flash_pallas_named_fn (:332), JAX's stock TPU flash kernel: per (batch,
// head), out = softmax(Q K^T * scale, causal) V with f32 running max and sum,
// the probabilities rounded to the value type before the P.V product, and the
// per-row logsumexp as the residual statistic. Its backward (dq, dk/dv) is
// csrc/flash_attention_bwd.cu.
//
// Validity mask: key j counts for query i iff j <= i and valid[b, j] != 0,
// applied multiplicatively to P, and a row with no live key gives out = 0 and
// lse = 0. That is the contract of the JAX package's XLA path
// (_flash_fwd_impl) and of the plain version. The Pallas kernel takes the
// mask as segment ids (SegmentIds(q=valid, kv=valid), ops/nn.py:317-320): it
// agrees on every valid query row and differs only on pad rows, whose outputs
// its docstring calls garbage and the loss masks. Following the plain
// contract, kernel and plain version agree on every row.
//
// What bounds it on the card: 4 * B * H * (T^2 / 2) * Dh FLOP (the causal
// half of QK^T and PV) against B * T * (H + 2 * KH) * Dh bf16 input bytes --
// at B = 2, H = 32, KH = 8, T = 2048 about 34 GFLOP for 25 MB, far above the
// tensor-core balance point, so the tensor cores are the resource.
//
// Design (FlashAttention-2 on mma.sync): one block of 4 warps per (64-query
// tile, head, batch); each warp owns 16 query rows, keeps their Q fragments
// and the f32 output accumulators in registers, and walks the 64-key tiles up
// to the causal diagonal (tiles above it are skipped, as the Pallas causal
// grid skips them). Scores and P.V run on mma.sync.m16n8k16 bf16 -> f32; the
// score accumulators' layout is the A operand layout of the P.V product, so P
// goes from registers to the tensor cores without touching shared memory.
// Grouped-query attention reads KV head h / (H / KH) directly: no
// head-repeated K/V copy. Query tiles launch longest-first. The f32
// instantiation (the card-against-CPU reference of small f32 models) is a
// scalar-FMA kernel with the same tiling: the tensor cores take no
// full-precision f32 operand.
#include "flash_common.cuh"

namespace {

// One key tile's online-softmax step for a warp's 16 rows (r0 and r0 + 8 of
// this thread): scale the scores, fold the tile's row max into the running
// max, rescale l and the output accumulators, and turn s into P. A dead entry
// (outside the causal window, or an invalid key) enters with probability
// exactly 0. kMasked tests every entry: the diagonal tile and tiles that hold
// an invalid key; the other tiles skip the test.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&o)[8][4], float (&m_run)[2],
                                             float (&l_run)[2], float scale, uint32_t mine,
                                             bool diag, int k0, int row0, int t4) {
  auto dead = [&](int j, int e) {
    return kMasked && ((diag && k0 + 8 * j + 2 * t4 + (e & 1) > row0 + 8 * (e >> 1)) ||
                       !col_bit(mine, j, e));
  };
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float val = dead(j, e) ? kNeg : s[j][e] * scale;
      s[j][e] = val;
      mx[e >> 1] = fmaxf(mx[e >> 1], val);
    }
  }
  float corr[2];
  float m_new[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    m_new[i] = fmaxf(m_run[i], mx[i]);
    corr[i] = expf(m_run[i] - m_new[i]);
    m_run[i] = m_new[i];
    l_run[i] *= corr[i];
  }
  // masked entries contribute exactly 0 (never exp of the fill value)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = dead(j, e) ? 0.0f : expf(s[j][e] - m_new[e >> 1]);
      s[j][e] = p;
      l_run[e >> 1] += p;
    }
    o[j][0] *= corr[0];
    o[j][1] *= corr[0];
    o[j][2] *= corr[1];
    o[j][3] *= corr[1];
  }
}

__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ valid,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int H, int KH, float scale) {
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread in group

  __shared__ __align__(16) __nv_bfloat16 sQ[kTile][kRow];
  __shared__ __align__(16) __nv_bfloat16 sK[kTile][kRow];
  __shared__ __align__(16) __nv_bfloat16 sV[kTile][kRow];
  __shared__ uint32_t sLive[2];  // key validity of the tile, a 64-bit mask

  const size_t q_stride = (size_t)H * kDh;
  const size_t kv_stride = (size_t)KH * kDh;
  const __nv_bfloat16* qb = q + (size_t)b * T * q_stride + (size_t)h * kDh;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)(h / (H / KH)) * kDh;
  const __nv_bfloat16* kb = k + kv_off;
  const __nv_bfloat16* vb = v + kv_off;

  load_tile(sQ, qb, q_stride, q0, T);
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8 of the tile
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(&sQ[r0][16 * kk + 2 * t4]);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(&sQ[r0 + 8][16 * kk + 2 * t4]);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(&sQ[r0][16 * kk + 8 + 2 * t4]);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(&sQ[r0 + 8][16 * kk + 8 + 2 * t4]);
  }
  const int row0 = q0 + r0;  // and row0 + 8

  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m_run[2] = {kNeg, kNeg};
  float l_run[2] = {0.0f, 0.0f};  // this thread's share of the row sum
  const uint16_t* sVu = reinterpret_cast<const uint16_t*>(&sV[0][0]);

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    const bool diag = kt == qt;
    __syncthreads();  // every warp is done with the previous tile
    load_tile(sK, kb, kv_stride, k0, T);
    load_tile(sV, vb, kv_stride, k0, T);
    load_live(sLive, valid, b, T, k0);
    __syncthreads();
    const uint64_t live = live_mask(sLive);

    // S = Q K^T: n-tile j holds keys 8j .. 8j + 7
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&sK[8 * j + g][16 * kk + 2 * t4]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&sK[8 * j + g][16 * kk + 8 + 2 * t4]);
        mma_bf16(s[j], qa[kk], b0, b1);
      }
    }
    if (diag || live != kAllLive) {  // the same for the whole block
      softmax_tile<true>(s, o, m_run, l_run, scale, thread_bits(live, t4), diag, k0, row0, t4);
    } else {
      softmax_tile<false>(s, o, m_run, l_run, scale, 0u, diag, k0, row0, t4);
    }
    // O += P V: P (rounded to bf16) straight from the score registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]), pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]), pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key_a = 16 * kk + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 8 * j + g;
        const uint32_t b0 = pack_raw(sVu[key_a * kRow + d], sVu[(key_a + 1) * kRow + d]);
        const uint32_t b1 = pack_raw(sVu[(key_a + 8) * kRow + d], sVu[(key_a + 9) * kRow + d]);
        mma_bf16(o[j], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    const int row = row0 + 8 * i;
    if (row >= T) continue;
    const float l_safe = fmaxf(l_run[i], 1e-30f);
    __nv_bfloat16* orow = out + ((size_t)b * T + row) * q_stride + (size_t)h * kDh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
          pack_f32(o[j][2 * i] / l_safe, o[j][2 * i + 1] / l_safe);
    }
    if (lse != nullptr && t4 == 0) {
      lse[((size_t)b * H + h) * T + row] = l_run[i] > 0.0f ? m_run[i] + logf(l_safe) : 0.0f;
    }
  }
}

// f32: one thread per query row (64 a block), keys in steps of 16 with one
// rescale per step; K and V tiles staged in shared memory and read as
// broadcasts (every thread reads the same key).
constexpr int kStep = 16;

__global__ void __launch_bounds__(kTile) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ valid, float* __restrict__ out, float* __restrict__ lse, int T, int H,
    int KH, float scale) {
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = qt * kTile + threadIdx.x;

  __shared__ __align__(16) float sK[kTile][kDh];
  __shared__ __align__(16) float sV[kTile][kDh];
  __shared__ uint32_t sLive[2];

  const size_t q_stride = (size_t)H * kDh;
  const size_t kv_stride = (size_t)KH * kDh;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)(h / (H / KH)) * kDh;
  float qr[kDh];
  float o[kDh];
  const float* qrow = q + ((size_t)b * T + row) * q_stride + (size_t)h * kDh;
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    qr[d] = row < T ? qrow[d] : 0.0f;
    o[d] = 0.0f;
  }
  float m_run = kNeg;
  float l_run = 0.0f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    {
      const int key = k0 + threadIdx.x;
      const float4* ks = reinterpret_cast<const float4*>(k + kv_off + (size_t)key * kv_stride);
      const float4* vs = reinterpret_cast<const float4*>(v + kv_off + (size_t)key * kv_stride);
#pragma unroll
      for (int d4 = 0; d4 < kDh / 4; ++d4) {
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        reinterpret_cast<float4*>(sK[threadIdx.x])[d4] = key < T ? ks[d4] : zero;
        reinterpret_cast<float4*>(sV[threadIdx.x])[d4] = key < T ? vs[d4] : zero;
      }
    }
    load_live(sLive, valid, b, T, k0);
    __syncthreads();
    const uint64_t live = live_mask(sLive);
    for (int c0 = 0; c0 < kTile; c0 += kStep) {
      float s[kStep];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < kStep; ++c) {
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < kDh; ++d) dot = fmaf(qr[d], sK[c0 + c][d], dot);
        s[c] = (k0 + c0 + c > row || !bit(live, c0 + c)) ? kNeg : dot * scale;
        mx = fmaxf(mx, s[c]);
      }
      const float m_new = fmaxf(m_run, mx);
      const float corr = expf(m_run - m_new);
      m_run = m_new;
      l_run *= corr;
#pragma unroll
      for (int d = 0; d < kDh; ++d) o[d] *= corr;
#pragma unroll
      for (int c = 0; c < kStep; ++c) {
        const float p = (k0 + c0 + c > row || !bit(live, c0 + c)) ? 0.0f : expf(s[c] - m_new);
        l_run += p;
#pragma unroll
        for (int d = 0; d < kDh; ++d) o[d] = fmaf(p, sV[c0 + c][d], o[d]);
      }
    }
  }
  if (row >= T) return;
  const float l_safe = fmaxf(l_run, 1e-30f);
  float* orow = out + ((size_t)b * T + row) * q_stride + (size_t)h * kDh;
#pragma unroll
  for (int d = 0; d < kDh; ++d) orow[d] = o[d] / l_safe;
  if (lse != nullptr) {
    lse[((size_t)b * H + h) * T + row] = l_run > 0.0f ? m_run + logf(l_safe) : 0.0f;
  }
}

}  // namespace

// q (B, T, H, 64), k and v (B, T, KH, 64), out (B, T, H, 64): bf16 (is_f32 = 0)
// or f32, contiguous; H % KH == 0. valid (B, T) uint8 key validity, or null
// (every key valid). lse (B, H, T) f32, or null. Causal, scale applied to the
// scores.
extern "C" int rtca_flash_attention(const void* q, const void* k, const void* v,
                                    const uint8_t* valid, void* out, float* lse, int B, int T, int H,
                                    int KH, float scale, int is_f32, void* stream) {
  if (B < 1 || T < 1 || KH < 1 || H % KH != 0 || H > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  if (is_f32) {
    flash_fwd_f32_kernel<<<grid, kTile, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        valid, static_cast<float*>(out), lse, T, H, KH, scale);
  } else {
    flash_fwd_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), valid, static_cast<__nv_bfloat16*>(out), lse, T, H,
        KH, scale);
  }
  return (int)cudaGetLastError();
}
