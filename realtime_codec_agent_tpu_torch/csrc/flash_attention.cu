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
#include <cuda.h>
#include "flash_common.cuh"

// the f32 instantiation, csrc/flash_attention_f32.cu
extern "C" int rtca_flash_attention_f32(const void* q, const void* k, const void* v, const uint8_t* valid,
                                        void* out, float* lse, int B, int T, int H, int KH, int Dh, float scale,
                                        cudaStream_t st);

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(bar), "r"(bytes) : "memory");
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

// one (64 columns x 1 head x 64 rows x 1 batch row) box of a 4-D map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int head, int row, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128 B)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keep the compiler from moving reads or writes of accumulators across the
// asynchronous wgmma window
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d (64 x 64) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major);
// accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, bf16 pairs in registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128) += A (64 x 16, bf16 pairs in registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int kHd>
__device__ __forceinline__ void wgmma_pv(float (&o)[kHd / 8][4], const uint32_t (&a)[4], uint64_t desc_v);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[8][4], const uint32_t (&a)[4], uint64_t desc_v) {
  wgmma_rs_n64(o, a, desc_v);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[16][4], const uint32_t (&a)[4], uint64_t desc_v) {
  wgmma_rs_n128(o, a, desc_v);
}

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

constexpr int kAtomBytes = kTile * 128;  // 64 rows x 64 bf16 columns, 128-byte swizzled

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

    // S = Q K^T: k-step kk reads 16 columns of Q and K (32 bytes into an atom)
    float s[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
      const uint32_t off = (uint32_t)((kk / 4) * kAtomBytes + (kk % 4) * 32);
      wgmma_ss_n64(s, sw128_desc(sQ + off, 16, 1024), sw128_desc(sK(st) + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    if (diag || live != kAllLive) {  // the same for the whole block
      softmax_tile<true>(s, o, m_run, l_run, scale, thread_bits(live, t4), diag, k0, row0, t4);
    } else {
      softmax_tile<false>(s, o, m_run, l_run, scale, 0u, diag, k0, row0, t4);
    }

    // O += P V: k-step kk takes keys 16 kk .. 16 kk + 15 (rows of V, 2 KB
    // apart); the next 64 columns of V are the next atom (LBO). P (rounded
    // to bf16) is the A fragments of the four k-steps.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_pv<kHd>(o, pa[kk], sw128_desc(sV(st) + kk * 16 * 128, kAtomBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait();
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

// cuTensorMapEncodeTiled, a driver function, reached through the runtime so
// the library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 4-D map over x (B, T, NH, Dh) bf16: boxes of 64 columns x 1 head x 64
// rows x 1 batch row, 128-byte swizzled; rows past T read as zeros
bool make_map(CUtensorMap* map, const void* x, int B, int T, int NH, int Dh) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)NH, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Dh * 2, (cuuint64_t)NH * Dh * 2, (cuuint64_t)T * NH * Dh * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kTile, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
