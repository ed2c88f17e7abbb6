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
// What bounds it on the card: operations. 4 * B * H * (T^2 / 2) * Dh FLOP
// (the causal half of QK^T and PV) against B * T * (H + 2 * KH) * Dh bf16
// input bytes -- at B = 2, H = 32, KH = 8, T = 2048, Dh = 64 about 34 GFLOP
// for 25 MB, far above the tensor-core balance point.
//
// Design (bf16, head dim 64 or 128, sm_90a): one block of one warpgroup (128
// threads) per (64-query tile, head, batch); query tiles launch longest first.
// - Copies: TMA (cp.async.bulk.tensor, 4-D maps over (Dh, heads, T, B), so
//   grouped-query attention reads KV head h / (H / KH) unrepeated and rows
//   past T arrive as zeros) with an mbarrier per buffer. The Q tile lands
//   once; K and V tiles of 64 keys go through a ring of two stages in
//   dynamic shared memory: tile kt + 1 is in flight while tile kt's math
//   runs. The key validity of tile kt + 1 is read while tile kt is computed.
// - Layouts: 128-byte swizzle, the TMA's and wgmma's own: a 64-column atom of
//   64 rows x 128 B (8 KB); Dh = 128 is two atoms side by side.
// - S = Q K^T on wgmma m64n64k16 (Q and K from shared memory, K-major).
// - The online softmax in the accumulator registers (a thread owns rows
//   16 w + l / 4 and + 8, the m16n8 layout of every warp): the diagonal tile
//   and tiles with an invalid key are masked, tiles above the diagonal are
//   never loaded.
// - O += P V on wgmma m64n{Dh}k16 with A = P straight from the score
//   registers (rounded to bf16 pairs: the accumulator layout is the A
//   fragment layout) and B = V from shared memory through the transpose bit
//   (MN-major).
// Every block computes its rows alone and in a fixed order: bitwise
// repeatable, no atomics. A block waits for each of its wgmma groups (S,
// then P V), so its tensor-core work and its softmax alternate; the 2-4
// blocks an SM overlap each other's. Not here yet: a producer warp, register
// reallocation and persistent scheduling (PERF.md has its time against
// SDPA's).
//
// The f32 instantiation (the card-against-CPU reference of small f32 models)
// is a scalar-FMA kernel with the same tiling, at Dh 64 or 128, in
// csrc/flash_attention_f32.cu: the tensor cores take no full-precision f32
// operand.
#include "wgmma_common.cuh"

// the f32 instantiation, csrc/flash_attention_f32.cu
extern "C" int rtca_flash_attention_f32(const void* q, const void* k, const void* v, const uint8_t* valid,
                                        void* out, float* lse, int B, int T, int H, int KH, int Dh, float scale,
                                        cudaStream_t st);

namespace {

// One key tile's online-softmax step for a thread's two rows (r0 and r0 + 8
// of its warp's 16): scale the scores, fold the tile's row max into the
// running max, rescale l and the output accumulators, and turn s into P. A
// dead entry (outside the causal window, or an invalid key) enters with
// probability exactly 0. kMasked tests every entry: the diagonal tile and
// tiles that hold an invalid key; the other tiles skip the test.
template <bool kMasked, int kOT>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&o)[kOT][4], float (&m_run)[2],
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
  }
#pragma unroll
  for (int j = 0; j < kOT; ++j) {
    o[j][0] *= corr[0];
    o[j][1] *= corr[0];
    o[j][2] *= corr[1];
    o[j][3] *= corr[1];
  }
}

// The K/V ring: 2 stages (16 KB each at head dim 64: 41 KB a block; 32 KB
// at 128: 81 KB, 2 blocks an SM); tile kt + 1 is requested while tile kt is
// computed. A deeper ring at head dim 64 leaves room for 3 blocks an SM
// instead of 4, and each block waits for its own wgmma groups: it ran
// slower.
constexpr int kStages = 2;

template <int kHd>
struct FwdSmem {
  static constexpr int kAtoms = kHd / 64;
  static constexpr int kTileBytes = kAtoms * kAtomBytes;                 // one 64-row tile of Q, K or V
  static constexpr int kBytes = 1024 + kTileBytes * (1 + 2 * kStages);  // + slack for 1 KB alignment
};

template <int kHd>
__global__ void __launch_bounds__(kThreads) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const uint8_t* __restrict__ valid,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int H, int KH, float scale) {
  using L = FwdSmem<kHd>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];  // Q, then one per K/V stage
  __shared__ uint32_t sLive[2][2];                      // key validity of tile kt, by kt & 1

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kTile;
  const int kvh = h / (H / KH);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread in group

  // 1 KB-aligned tiles (the 128-byte swizzle's period)
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  auto sK = [&](int st) { return base + (uint32_t)((1 + st) * L::kTileBytes); };
  auto sV = [&](int st) { return base + (uint32_t)((1 + kStages + st) * L::kTileBytes); };
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto bar_kv = [&](int st) { return smem_u32(&bars[1 + st]); };
  const CUtensorMap* mq = &map_q;
  const CUtensorMap* mk = &map_k;
  const CUtensorMap* mv = &map_v;

  auto issue_kv = [&](int kt) {  // thread 0: K and V of key tile kt into stage kt % kStages
    const int st = kt % kStages;
    mbar_expect(bar_kv(st), 2 * L::kTileBytes);
#pragma unroll
    for (int a = 0; a < L::kAtoms; ++a) {
      tma_load(sK(st) + a * kAtomBytes, mk, 64 * a, kvh, kt * kTile, b, bar_kv(st));
      tma_load(sV(st) + a * kAtomBytes, mv, 64 * a, kvh, kt * kTile, b, bar_kv(st));
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(smem_u32(&bars[i]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar_q, L::kTileBytes);
#pragma unroll
    for (int a = 0; a < L::kAtoms; ++a) tma_load(sQ + a * kAtomBytes, mq, 64 * a, h, q0, b, bar_q);
    issue_kv(0);
  }
  // threads 0..63: the validity of key kt * 64 + threadIdx.x, read one tile
  // ahead so that the load's latency hides behind a tile's math
  auto key_live = [&](int key) {
    return key < T && (valid == nullptr || valid[(size_t)b * T + key] != 0);
  };
  bool live_next = threadIdx.x < kTile && key_live(threadIdx.x);
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8 of the tile
  const int row0 = q0 + r0;
  float o[kHd / 8][4];
#pragma unroll
  for (int j = 0; j < kHd / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m_run[2] = {kNeg, kNeg};
  float l_run[2] = {0.0f, 0.0f};  // this thread's share of the row sum
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
    if (threadIdx.x == 0 && kt + 1 <= qt) issue_kv(kt + 1);
    if (threadIdx.x < kTile && kt < qt) live_next = key_live(k0 + kTile + threadIdx.x);
    const uint64_t live = live_mask(sLive[kt & 1]);
    mbar_wait(bar_kv(st), (uint32_t)((kt / kStages) & 1));
    __syncwarp();

    // S = Q K^T
    float s[8][4];
    wgmma_ss_abt<kHd>(s, sQ, sK(st));
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    if (diag || live != kAllLive) {  // the same for the whole block
      softmax_tile<true>(s, o, m_run, l_run, scale, thread_bits(live, t4), diag, k0, row0, t4);
    } else {
      softmax_tile<false>(s, o, m_run, l_run, scale, 0u, diag, k0, row0, t4);
    }

    // O += P V (P rounded to bf16; V MN-major)
    uint32_t pa[4][4];
    pack_a(s, pa);
    wgmma_rs_tile<kHd>(o, pa, sV(st));
    wgmma_commit();
    wgmma_wait();
    fence_frags(pa);
    fence_regs(o);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    const int row = row0 + 8 * i;
    if (row >= T) continue;
    const float l_safe = fmaxf(l_run[i], 1e-30f);
    __nv_bfloat16* orow = out + ((size_t)b * T + row) * H * kHd + (size_t)h * kHd;
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
          pack_f32(o[j][2 * i] / l_safe, o[j][2 * i + 1] / l_safe);
    }
    if (lse != nullptr && t4 == 0) {
      lse[((size_t)b * H + h) * T + row] = l_run[i] > 0.0f ? m_run[i] + logf(l_safe) : 0.0f;
    }
  }
}


template <int kHd>
int launch_bf16(const void* q, const void* k, const void* v, const uint8_t* valid, void* out, float* lse, int B,
                int T, int H, int KH, float scale, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, T, H, kHd) || !make_map(&mk, k, B, T, KH, kHd) || !make_map(&mv, v, B, T, KH, kHd)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  constexpr int kSmem = FwdSmem<kHd>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(flash_fwd_wgmma_kernel<kHd>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  flash_fwd_wgmma_kernel<kHd><<<grid, kThreads, kSmem, st>>>(mq, mk, mv, valid, static_cast<__nv_bfloat16*>(out),
                                                             lse, T, H, KH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, T, H, Dh), k and v (B, T, KH, Dh), out (B, T, H, Dh): bf16 (is_f32 =
// 0) or f32, contiguous, 16-byte aligned; Dh 64 or 128; H % KH == 0. valid
// (B, T) uint8 key validity, or null (every key valid). lse (B, H, T) f32, or
// null. Causal, scale applied to the scores.
extern "C" int rtca_flash_attention(const void* q, const void* k, const void* v, const uint8_t* valid, void* out,
                                    float* lse, int B, int T, int H, int KH, int Dh, float scale, int is_f32,
                                    void* stream) {
  if (B < 1 || T < 1 || KH < 1 || H % KH != 0 || H > 65535 || B > 65535 || (Dh != 64 && Dh != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) return rtca_flash_attention_f32(q, k, v, valid, out, lse, B, T, H, KH, Dh, scale, st);
  return Dh == 64 ? launch_bf16<64>(q, k, v, valid, out, lse, B, T, H, KH, scale, st)
                  : launch_bf16<128>(q, k, v, valid, out, lse, B, T, H, KH, scale, st);
}
