// GQA decode attention: the whole small-T two-piece attention in one launch
// (kernel B3).
//
// Replaces the Pallas TPU kernels realtime_codec_agent_tpu/ops/decode_attention.py
// (decode_attention_partials -> _kernel, :237; decode_attention_partials_grid
// -> _grid_kernel, :180) and the XLA small-T branch they stood beside
// (realtime_codec_agent_tpu/models/llama.py _gqa_two_piece_attention, T < 9):
// the G*T query rows of each (batch row b, KV head kh) attend the cache keys
// at index < cache_valid[b] and the W keys of the new-key window where
// new_pos <= q_pos, in one softmax; the output is normalized and written in
// q's dtype in (B, T, H, Dh) order. Row r of a KV head is query head
// kh*G + r / T at token r % T.
//
// What bounds it on the card: the (K, V) bytes of the valid prefix -- 2
// FLOPs per key byte per row at 1..64 rows, far below the tensor cores'
// balance point -- and, at the hot loop's 2,048 valid keys (4 MB over all
// heads), latency: one launch, one round of loads, one tile of products per
// warp, two cluster barriers and the per-row epilogue, each a chain of a
// microsecond or two.
//
// Design (sm_90a):
// - One launch, no scratch, no atomics: grid (splits, B*KH); the splits of
//   one (b, kh) are one thread-block cluster. Each block reads cache_valid[b]
//   on the device and takes an equal share of the 32-key tiles below it: no
//   block works on the stale cache, and nothing depends on a host value, so
//   the launch can be captured in a CUDA graph. ops/decode_attention.plan
//   picks the splits and the key warps per (B*KH, rows, head_dim) from
//   what rtca_decode_attention_plan reports of each plan.
// - Warps: one per (16-row m-tile, key warp), at most 8 a block; the key
//   warps (up to 8) of a block take its 32-key tiles in turn: short tiles
//   and many warps, since each warp's chain of products and exponentials,
//   not the bytes, sets the time. K and V stream with cp.async, 16 bytes a
//   thread at constant pointer steps, kStages rounds of one tile per key
//   warp in flight, into rows padded by 16 bytes (conflict-free fragment
//   reads); keys past cache_valid are zero-filled and masked.
// - bf16: mma.sync m16n8k16, Q as A fragments held in registers, S = Q K^T,
//   the online softmax in the accumulator layout, and P V with P split into
//   three bf16 terms (hi + mid + lo, ~2^-27 of P), so the cache piece keeps
//   f32 probabilities as the plain version does. The products are issued
//   k-step by k-step over independent accumulators, and P V of each tile
//   goes to a fresh accumulator folded into the running one by f32 FMAs:
//   the tensor cores' sums (which truncate) then never span more than one
//   tile. f32: the same tiles on the SIMT units (lanes over keys for S,
//   over head dims for P V).
// - Epilogue: each warp leaves (m, l, acc) of its rows in shared memory,
//   the block merges its key warps in order; after a cluster barrier block
//   `rank` owns rows rank, rank + splits, ... and merges the splits through
//   distributed shared memory in rank order (every peer's row loaded
//   first), then folds in the window by the same online softmax: the
//   scores of its first kWinStage keys computed and their values staged
//   while the first tiles are in flight, any further keys (a long chunk's
//   frame scan, a long generate_until) scored and read from global memory
//   32 at a time in the epilogue; window probabilities rounded to v's dtype
//   for P V (the JAX path's astype) and unrounded in the denominator, as
//   ops/decode_attention.merge_window does. W is not bounded.
//   cache_valid == 0 leaves m = -1e30, l = 0, and the window alone decides.
//   Two launches are bitwise equal.
#include <cooperative_groups.h>

#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;         // keys per tile (a multiple of 32)
constexpr int kNJ = kTile / 8;    // S's n-tiles (8 keys)
constexpr int kNK = kTile / 16;   // P V's k-steps (16 keys)
constexpr int kStages = 2;        // rounds of tiles in flight
constexpr int kMaxRows = 64;      // G*T rows per (b, kh): 4 m-tiles
constexpr int kWinStage = 72;     // window keys staged in shared memory (generate_until: 64 + 1)
constexpr int kMaxSplits = 16;    // cluster size (above 8: non-portable)
constexpr int kMaxKWarps = 8;
constexpr int kMaxWarps = 8;
constexpr int kMaxSmem = 227 * 1024;
constexpr float kNeg = -1e30f;

struct Args {
  const void* q;
  const void* kb;
  const void* vb;
  const void* kn;
  const void* vn;
  const void* qpos;
  const void* npos;
  const int* cv;
  void* out;
  int B, T, H, KH, S, W, G, R, kwarps, qpos64, npos64;
  float scale;
  long long sq[3], skb[3], svb[3], skn[3], svn[3], sqp[2], snp[2], scv;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long load_pos(const void* p, int is64, long long i) {
  return is64 ? static_cast<const long long*>(p)[i] : (long long)static_cast<const int*>(p)[i];
}

// 16 bytes global -> shared; size 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// D += A B on the tensor cores (m16n8k16, bf16 -> f32). Not volatile, unlike
// mma_sync.cuh's: ptxas may interleave independent products.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the three bf16 terms of a pair of probabilities: hi + mid + lo = (x, y)
// to ~2^-27
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(rx - mf.x, ry - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int kDh, typename T>
struct Geo {
  static constexpr int kRow = kDh + 16 / (int)sizeof(T);  // padded shared row, elements
  static constexpr int kTileBytes = kTile * kRow * (int)sizeof(T);
  static constexpr int kChunks = kDh * (int)sizeof(T) / 16;  // 16-byte pieces per key
};

// dynamic shared memory: [stages | partials] (the partials and the key
// warps' merge weights reuse the stage buffers once the loop is done), the
// staged window's values (w = min(W, kWinStage) keys), its scores for the
// block's rows, and (f32) each warp's 16 x kTile probabilities
template <int kDh, typename T>
__host__ __device__ constexpr int stage_bytes(int kwarps) {
  return kStages * kwarps * 2 * Geo<kDh, T>::kTileBytes;
}
__host__ __device__ constexpr int partial_bytes(int kwarps, int mtiles, int dh) {
  return kwarps * mtiles * 16 * (dh + 3) * 4;
}
template <int kDh, typename T>
__host__ __device__ constexpr int smem_bytes(int kwarps, int mtiles, int own_rows, int w) {
  const int a = stage_bytes<kDh, T>(kwarps);
  const int b = partial_bytes(kwarps, mtiles, kDh);
  return (a > b ? a : b) + w * kDh * (int)sizeof(T) + own_rows * w * 4 +
         (sizeof(T) == 4 ? kwarps * mtiles * 16 * kTile * 4 : 0);
}

template <int kDh, typename T>
__global__ void __launch_bounds__(kMaxWarps * 32) decode_attention_kernel(const Args a) {
  using G_ = Geo<kDh, T>;
  constexpr int kRow = G_::kRow;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bkh = blockIdx.y;
  const int b = bkh / a.KH;
  const int kh = bkh % a.KH;
  const int KW = a.kwarps;
  const int MT = (a.R + 15) / 16;
  const int Rp = MT * 16;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mt = warp % MT;
  const int kw = warp / MT;
  const int gq = lane >> 2;
  const int i4 = lane & 3;
  const T* q = static_cast<const T*>(a.q);
  const T* kb = static_cast<const T*>(a.kb) + b * a.skb[0] + kh * a.skb[2];
  const T* vb = static_cast<const T*>(a.vb) + b * a.svb[0] + kh * a.svb[2];
  const T* kn = static_cast<const T*>(a.kn) + b * a.skn[0] + kh * a.skn[2];
  const T* vn = static_cast<const T*>(a.vn) + b * a.svn[0] + kh * a.svn[2];
  const int cv = max(0, min(a.cv[b * a.scv], a.S));

  const int n_tiles = (cv + kTile - 1) / kTile;
  const int t0 = rank * n_tiles / splits;
  const int t1 = (rank + 1) * n_tiles / splits;
  const int rounds = (t1 - t0 + KW - 1) / KW;
  const int stage_sz = stage_bytes<kDh, T>(KW);
  const int base_sz = stage_sz > partial_bytes(KW, MT, kDh) ? stage_sz : partial_bytes(KW, MT, kDh);
  const int own_rows = (a.R + splits - 1) / splits;
  const int Ws = min(a.W, kWinStage);  // staged window keys
  T* v_win = reinterpret_cast<T*>(smem + base_sz);  // (Ws, Dh)
  float* s_win = reinterpret_cast<float*>(smem + base_sz + Ws * kDh * (int)sizeof(T));  // (own rows, Ws)
  float* p_buf = s_win + own_rows * Ws;  // f32 only

  // round i: tile t0 + i*KW + k of key warp k, K then V, to stage i %
  // kStages. Thread (row r_t, 16-byte piece c_t) copies rows r_t, r_t +
  // rstep, ... of each tile: constant pointer steps, no division per copy.
  const int rstep = blockDim.x / G_::kChunks;
  const int r_t = threadIdx.x / G_::kChunks;
  const int c_t = (threadIdx.x % G_::kChunks) * (16 / (int)sizeof(T));
  const long long k_step = rstep * a.skb[1];
  const long long v_step = rstep * a.svb[1];
  const int d_step = rstep * kRow * (int)sizeof(T);
  auto load_round = [&](int i) {
    unsigned char* st = smem + (size_t)(i % kStages) * KW * 2 * G_::kTileBytes;
    for (int k = 0; k < KW; ++k) {
      const int tile = t0 + i * KW + k;
      if (tile >= t1) break;
      int key = tile * kTile + r_t;
      const T* kp = kb + key * a.skb[1] + c_t;
      const T* vp = vb + key * a.svb[1] + c_t;
      unsigned char* dk = st + 2 * k * G_::kTileBytes + r_t * kRow * (int)sizeof(T) + c_t * (int)sizeof(T);
      for (int row = r_t; row < kTile; row += rstep) {
        const bool live = key < cv;  // past cache_valid: zeros, from a valid address
        cp_async16(dk, live ? kp : kb, live);
        cp_async16(dk + G_::kTileBytes, live ? vp : vb, live);
        key += rstep;
        kp += k_step;
        vp += v_step;
        dk += d_step;
      }
    }
  };
  // the staged window's values, with the first round
  for (int e = threadIdx.x; e < Ws * G_::kChunks; e += blockDim.x) {
    const int j = e / G_::kChunks;
    const int c = e % G_::kChunks;
    cp_async16(reinterpret_cast<unsigned char*>(v_win + j * kDh) + c * 16,
               vn + j * a.svn[1] + c * (16 / (int)sizeof(T)), true);
  }
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < rounds) load_round(s);
    cp_async_commit();
  }

  // the query row r: head kh*G + r/T at token r%T
  auto q_row = [&](int r) -> const T* {
    return q + b * a.sq[0] + (r % a.T) * a.sq[1] + (kh * a.G + r / a.T) * a.sq[2];
  };

  auto q_pos_of = [&](int r) { return load_pos(a.qpos, a.qpos64, b * a.sqp[0] + (r % a.T) * a.sqp[1]); };
  // the scaled score of query row qr (at position qp) against window key j,
  // -1e30 where the key is not visible
  auto win_score = [&](const T* qr, long long qp, int j) -> float {
    const T* kr = kn + j * a.skn[1];
    float part4[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // four chains, summed in order
#pragma unroll
    for (int c = 0; c < G_::kChunks; ++c) {
      const int4 kv = __ldg(reinterpret_cast<const int4*>(kr) + c);
      const int4 qv = __ldg(reinterpret_cast<const int4*>(qr) + c);
      const T* ke = reinterpret_cast<const T*>(&kv);
      const T* qe = reinterpret_cast<const T*>(&qv);
#pragma unroll
      for (int e = 0; e < 16 / (int)sizeof(T); ++e) part4[e & 3] = fmaf(to_f32(qe[e]), to_f32(ke[e]), part4[e & 3]);
    }
    const float dot = (part4[0] + part4[1]) + (part4[2] + part4[3]);
    const long long np = load_pos(a.npos, a.npos64, b * a.snp[0] + j * a.snp[1]);
    return np <= qp ? dot * a.scale : kNeg;
  };
  // the staged window's scores of the block's own rows, while the first
  // tiles load
  for (int r = rank + splits * warp; r < a.R; r += splits * nwarps) {
    const int lr = (r - rank) / splits;
    const T* qr = q_row(r);
    const long long qp = q_pos_of(r);
    for (int j = lane; j < Ws; j += 32) s_win[lr * Ws + j] = win_score(qr, qp, j);
  }

  // ---- the cache piece: this block's tiles, online softmax per warp ----
  const int r0 = mt * 16 + gq;  // mma rows r0 and r0 + 8
  float* part = reinterpret_cast<float*>(smem);
  float* pm = part + KW * Rp * kDh;
  float* pl = pm + KW * Rp;
  if constexpr (!kF32) {
    uint32_t qa[kDh / 16][4];
    const T* q0 = r0 < a.R ? q_row(r0) : nullptr;
    const T* q1 = r0 + 8 < a.R ? q_row(r0 + 8) : nullptr;
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      const int d = 16 * kk + 2 * i4;
      qa[kk][0] = q0 ? *reinterpret_cast<const uint32_t*>(q0 + d) : 0u;
      qa[kk][1] = q1 ? *reinterpret_cast<const uint32_t*>(q1 + d) : 0u;
      qa[kk][2] = q0 ? *reinterpret_cast<const uint32_t*>(q0 + d + 8) : 0u;
      qa[kk][3] = q1 ? *reinterpret_cast<const uint32_t*>(q1 + d + 8) : 0u;
    }
    float m[2] = {kNeg, kNeg};
    float l[2] = {0.0f, 0.0f};  // this thread's columns; summed over the quad at the end
    float acc[kDh / 8][4];
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    for (int i = 0; i < rounds; ++i) {
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const int tile = t0 + i * KW + kw;
      if (tile < t1) {
        const unsigned char* st = smem + (size_t)(i % kStages) * KW * 2 * G_::kTileBytes;
        const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(st + 2 * kw * G_::kTileBytes);
        const uint16_t* vs = reinterpret_cast<const uint16_t*>(st + (2 * kw + 1) * G_::kTileBytes);
        // S = Q K^T: k-steps outer, so consecutive products are independent
        float s[kNJ][4];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kDh / 16; ++kk)
#pragma unroll
          for (int j = 0; j < kNJ; ++j) {
            const __nv_bfloat16* kr = ks + (8 * j + gq) * kRow + 16 * kk + 2 * i4;
            mma(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kr), *reinterpret_cast<const uint32_t*>(kr + 8));
          }
        const int key0 = tile * kTile + 2 * i4;
        float mx[2] = {kNeg, kNeg};
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = key0 + 8 * j + (e & 1) < cv ? s[j][e] * a.scale : kNeg;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        float corr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float mn = fmaxf(m[h], mx[h]);
          corr[h] = expf(m[h] - mn);
          m[h] = mn;
          l[h] *= corr[h];
        }
        // P in the A layout of the k-step kk (keys 16kk .. 16kk + 15), as
        // three bf16 terms: [kk][0] lo, [1] mid, [2] hi
        uint32_t pf[kNK][3][4];
#pragma unroll
        for (int kk = 0; kk < kNK; ++kk)
#pragma unroll
          for (int h = 0; h < 4; ++h) {  // A register h: n-tile 2kk + h / 2, rows gq (+ 8 for odd h)
            float pp[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int j = 2 * kk + (h >> 1);
              const int e = 2 * (h & 1) + c;
              pp[c] = key0 + 8 * j + c < cv ? expf(s[j][e] - m[h & 1]) : 0.0f;
              l[h & 1] += pp[c];
            }
            split3(pp[0], pp[1], pf[kk][2][h], pf[kk][1][h], pf[kk][0][h]);
          }
        // P V into a fresh accumulator per 8 n-tiles (the tensor cores' sums
        // stay within one tile), small terms first, then folded into acc
#pragma unroll
        for (int jh = 0; jh < kDh / 64; ++jh) {
          float t[8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j) t[j][0] = t[j][1] = t[j][2] = t[j][3] = 0.0f;
#pragma unroll
          for (int kk = 0; kk < kNK; ++kk) {
            const int ka = 16 * kk + 2 * i4;
            uint32_t b[8][2];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int d = 64 * jh + 8 * j + gq;
              b[j][0] = pack_raw(vs[ka * kRow + d], vs[(ka + 1) * kRow + d]);
              b[j][1] = pack_raw(vs[(ka + 8) * kRow + d], vs[(ka + 9) * kRow + d]);
            }
#pragma unroll
            for (int term = 0; term < 3; ++term)
#pragma unroll
              for (int j = 0; j < 8; ++j) mma(t[j], pf[kk][term], b[j][0], b[j][1]);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float(&o)[4] = acc[8 * jh + j];
            o[0] = fmaf(o[0], corr[0], t[j][0]);
            o[1] = fmaf(o[1], corr[0], t[j][1]);
            o[2] = fmaf(o[2], corr[1], t[j][2]);
            o[3] = fmaf(o[3], corr[1], t[j][3]);
          }
        }
      }
      __syncthreads();
      if (i + kStages < rounds) load_round(i + kStages);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();  // the stage buffers become the partials
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    float* p0 = part + (kw * Rp + r0) * kDh;
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      *reinterpret_cast<float2*>(p0 + 8 * j + 2 * i4) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(p0 + 8 * kDh + 8 * j + 2 * i4) = make_float2(acc[j][2], acc[j][3]);
    }
    if (i4 == 0) {
      pm[kw * Rp + r0] = m[0];
      pl[kw * Rp + r0] = l[0];
      pm[kw * Rp + r0 + 8] = m[1];
      pl[kw * Rp + r0 + 8] = l[1];
    }
  } else {
    // f32: lanes over keys (lane, lane + 32, ...) for S, over head dims for P V
    constexpr int kDl = kDh / 32;
    float* pw = p_buf + warp * 16 * kTile;
    float m[16], l[16], acc[16][kDl];
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      m[rr] = kNeg;
      l[rr] = 0.0f;
#pragma unroll
      for (int c = 0; c < kDl; ++c) acc[rr][c] = 0.0f;
    }
    for (int i = 0; i < rounds; ++i) {
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const int tile = t0 + i * KW + kw;
      if (tile < t1) {
        const unsigned char* st = smem + (size_t)(i % kStages) * KW * 2 * G_::kTileBytes;
        const float* ks = reinterpret_cast<const float*>(st + 2 * kw * G_::kTileBytes);
        const float* vs = reinterpret_cast<const float*>(st + (2 * kw + 1) * G_::kTileBytes);
        constexpr int kKeys = kTile / 32;  // keys per lane: lane, lane + 32, ...
        bool live[kKeys];
#pragma unroll
        for (int u = 0; u < kKeys; ++u) live[u] = tile * kTile + lane + 32 * u < cv;
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          const int r = mt * 16 + rr;
          float sk[kKeys];
#pragma unroll
          for (int u = 0; u < kKeys; ++u) sk[u] = 0.0f;
          if (r < a.R) {
            const float* qr = reinterpret_cast<const float*>(q_row(r));
#pragma unroll 16
            for (int d = 0; d < kDh; ++d) {
              const float qd = __ldg(qr + d);
#pragma unroll
              for (int u = 0; u < kKeys; ++u) sk[u] = fmaf(qd, ks[(lane + 32 * u) * kRow + d], sk[u]);
            }
          }
          float mx = kNeg;
#pragma unroll
          for (int u = 0; u < kKeys; ++u) {
            sk[u] = live[u] ? sk[u] * a.scale : kNeg;
            mx = fmaxf(mx, sk[u]);
          }
          const float mn = fmaxf(m[rr], warp_max(mx));
          const float corr = expf(m[rr] - mn);
          float ps = 0.0f;
#pragma unroll
          for (int u = 0; u < kKeys; ++u) {
            const float p = live[u] ? expf(sk[u] - mn) : 0.0f;
            ps += p;
            pw[rr * kTile + lane + 32 * u] = p;
          }
          l[rr] = l[rr] * corr + warp_sum(ps);
          m[rr] = mn;
#pragma unroll
          for (int c = 0; c < kDl; ++c) acc[rr][c] *= corr;
        }
        __syncwarp();
#pragma unroll
        for (int rr = 0; rr < 16; ++rr)
#pragma unroll
          for (int c = 0; c < kDl; ++c) {
            float pv = 0.0f;
#pragma unroll 16
            for (int k = 0; k < kTile; ++k) pv = fmaf(pw[rr * kTile + k], vs[k * kRow + lane + 32 * c], pv);
            acc[rr][c] += pv;
          }
        __syncwarp();
      }
      __syncthreads();
      if (i + kStages < rounds) load_round(i + kStages);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int row = kw * Rp + mt * 16 + rr;
#pragma unroll
      for (int c = 0; c < kDl; ++c) part[row * kDh + lane + 32 * c] = acc[rr][c];
      if (lane == 0) {
        pm[row] = m[rr];
        pl[row] = l[rr];
      }
    }
  }

  // ---- epilogue: merge the key warps, then the cluster's splits, then
  // fold in the window ----
  if (KW > 1) {  // into key warp 0's slot, in key-warp order
    __syncthreads();
    float* wts = pl + KW * Rp;
    for (int row = threadIdx.x; row < Rp; row += blockDim.x) {
      float mb = kNeg;
      for (int k = 0; k < KW; ++k) mb = fmaxf(mb, pm[k * Rp + row]);
      float lb = 0.0f;
      for (int k = 0; k < KW; ++k) {
        const float w = expf(pm[k * Rp + row] - mb);
        wts[k * Rp + row] = w;
        lb = fmaf(pl[k * Rp + row], w, lb);
      }
      pm[row] = mb;
      pl[row] = lb;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < Rp * kDh; e += blockDim.x) {
      const int row = e / kDh;
      float sum = 0.0f;
      for (int k = 0; k < KW; ++k) sum = fmaf(part[k * Rp * kDh + e], wts[k * Rp + row], sum);
      part[e] = sum;
    }
  }
  cluster.sync();
  constexpr int kDl = kDh / 32;
  for (int r = rank + splits * warp; r < a.R; r += splits * nwarps) {
    const int lr = (r - rank) / splits;
    const float me = lane < splits ? cluster.map_shared_rank(pm, lane)[r] : kNeg;
    const float le = lane < splits ? cluster.map_shared_rank(pl, lane)[r] : 0.0f;
    const float m_tot = warp_max(me);
    const float we = lane < splits ? expf(me - m_tot) : 0.0f;
    const float l_tot = warp_sum(le * we);
    // every split's partial row at once, then summed in rank order
    float v[kMaxSplits][kDl];
#pragma unroll
    for (int e = 0; e < kMaxSplits; ++e)
#pragma unroll
      for (int c = 0; c < kDl; ++c) v[e][c] = e < splits ? cluster.map_shared_rank(part, e)[r * kDh + lane + 32 * c] : 0.0f;
    float acc[kDl];
#pragma unroll
    for (int c = 0; c < kDl; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int e = 0; e < kMaxSplits; ++e) {
      if (e >= splits) break;
      const float w = __shfl_sync(0xffffffffu, we, e);
#pragma unroll
      for (int c = 0; c < kDl; ++c) acc[c] = fmaf(v[e][c], w, acc[c]);
    }
    // the window: the staged keys' scores were computed above, the rest
    // (keys Ws .. W - 1) are scored here
    const T* qr = q_row(r);
    const long long qp = q_pos_of(r);
    float* sw = s_win + lr * Ws;
    float mw = kNeg;
    for (int j = lane; j < Ws; j += 32) mw = fmaxf(mw, sw[j]);
    for (int j = Ws + lane; j < a.W; j += 32) mw = fmaxf(mw, win_score(qr, qp, j));
    const float m_fin = fmaxf(m_tot, warp_max(mw));
    float ps = 0.0f;
    for (int j = lane; j < Ws; j += 32) {
      const float p = expf(sw[j] - m_fin);
      ps += p;
      sw[j] = to_f32(from_f32<T>(p));  // rounded to v's dtype for P V
    }
    __syncwarp();
    float pv[4][kDl];  // key j into chain j % 4, the chains summed in order
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < kDl; ++c) pv[u][c] = 0.0f;
    for (int j0 = 0; j0 < Ws; j0 += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u;
        const float p = j < Ws ? sw[j] : 0.0f;
        const T* vr = v_win + (j < Ws ? j : 0) * kDh + lane;
#pragma unroll
        for (int c = 0; c < kDl; ++c) pv[u][c] = fmaf(p, to_f32(vr[32 * c]), pv[u][c]);
      }
    }
    // keys past the stage, 32 at a time: their rounded probabilities go
    // through the row's first 32 score slots (read above), their values
    // come from global memory
    for (int j0 = Ws; j0 < a.W; j0 += 32) {
      const int n = min(32, a.W - j0);
      __syncwarp();
      const float p = lane < n ? expf(win_score(qr, qp, j0 + lane) - m_fin) : 0.0f;
      ps += p;
      sw[lane] = to_f32(from_f32<T>(p));
      __syncwarp();
      for (int u0 = 0; u0 < n; u0 += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = u0 + u;
          const float pj = j < n ? sw[j] : 0.0f;
          const T* vr = vn + (j0 + (j < n ? j : 0)) * a.svn[1] + lane;
#pragma unroll
          for (int c = 0; c < kDl; ++c) pv[u][c] = fmaf(pj, to_f32(__ldg(vr + 32 * c)), pv[u][c]);
        }
      }
    }
    ps = warp_sum(ps);
    const float corr = expf(m_tot - m_fin);
    const float l = l_tot * corr + ps;
    T* o = static_cast<T*>(a.out) + (((size_t)b * a.T + r % a.T) * a.H + kh * a.G + r / a.T) * kDh + lane;
#pragma unroll
    for (int c = 0; c < kDl; ++c) {
      const float pvc = (pv[0][c] + pv[1][c]) + (pv[2][c] + pv[3][c]);
      o[32 * c] = from_f32<T>((acc[c] * corr + pvc) / fmaxf(l, 1e-30f));
    }
  }
  cluster.sync();  // no block leaves while a peer reads its partials
}

// whether the kernel takes a plan for `rows` query rows a (b, kh): at most
// kMaxWarps warps a block and the shared memory within kMaxSmem
bool takes(int rows, int splits, int kwarps) {
  const int mtiles = (rows + 15) / 16;
  return rows >= 1 && rows <= kMaxRows && splits >= 1 && splits <= kMaxSplits && kwarps >= 1 &&
         kwarps <= kMaxKWarps && mtiles * kwarps <= kMaxWarps;
}

template <int kDh, typename T>
int block_smem(int rows, int splits, int kwarps, int w) {
  return smem_bytes<kDh, T>(kwarps, (rows + 15) / 16, (rows + splits - 1) / splits, min(w, kWinStage));
}

// the launch configuration of one cluster per (b, kh) pair, the kernel's
// attributes set once
template <int kDh, typename T>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int rows, int splits, int kwarps,
                      int w, int bkh) {
  auto kernel = decode_attention_kernel<kDh, T>;
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    attrs_set = true;
  }
  cfg = {};
  cfg.gridDim = dim3((unsigned)splits, (unsigned)bkh, 1);
  cfg.blockDim = dim3((unsigned)(32 * ((rows + 15) / 16) * kwarps), 1, 1);
  cfg.dynamicSmemBytes = (size_t)block_smem<kDh, T>(rows, splits, kwarps, w);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int kDh, typename T>
int launch(const Args& a, int splits, cudaStream_t s) {
  if (block_smem<kDh, T>(a.R, splits, a.kwarps, a.W) > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t e = configure<kDh, T>(cfg, attr, a.R, splits, a.kwarps, a.W, a.B * a.KH);
  if (e != cudaSuccess) return (int)e;
  cfg.stream = s;
  cudaLaunchKernelEx(&cfg, decode_attention_kernel<kDh, T>, a);
  return (int)cudaGetLastError();
}

// out: the block's dynamic shared memory (at a window of kWinStage keys or
// more) and how many of the plan's clusters the card holds at once; -1, -1
// when the kernel does not take the plan
template <int kDh, typename T>
int plan_fit(int rows, int splits, int kwarps, long long* out) {
  out[0] = out[1] = -1;
  const int smem = block_smem<kDh, T>(rows, splits, kwarps, kWinStage);
  if (!takes(rows, splits, kwarps) || smem > kMaxSmem) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<kDh, T>(cfg, attr, rows, splits, kwarps, kWinStage, 1);
  int clusters = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, decode_attention_kernel<kDh, T>, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a plan the card cannot place is not a sticky error
    clusters = 0;
  }
  out[0] = smem;
  out[1] = clusters;
  return 0;
}

}  // namespace

// One call of the small-T two-piece attention. ptrs: q (B, T, H, Dh), k_big
// and v_big (B, S, KH, Dh), k_new and v_new (B, W, KH, Dh), all bf16 or all
// f32 with the head dim contiguous and every row 16-byte aligned; q_pos
// (Bq, T) and new_pos (Bn, W), int32 or int64; cache_valid (Bc,) int32; out
// (B, T, H, Dh) contiguous, q's dtype. dims: B, T, H, KH, S, W, Dh, is_f32,
// qpos_is_i64, npos_is_i64, splits, kwarps, then element strides q (b, t,
// h), k_big (b, s, h), v_big, k_new (b, w, h), v_new, q_pos (b, t), new_pos
// (b, w), cache_valid (b) -- 0 for a broadcast leading dim. Requires Dh in
// {64, 128}, G*T <= 64, W >= 1, and a plan rtca_decode_attention_plan
// accepts.
extern "C" int rtca_decode_attention(const void* const* ptrs, const long long* dims, float scale, void* stream) {
  Args a = {};
  a.q = ptrs[0];
  a.kb = ptrs[1];
  a.vb = ptrs[2];
  a.kn = ptrs[3];
  a.vn = ptrs[4];
  a.qpos = ptrs[5];
  a.npos = ptrs[6];
  a.cv = static_cast<const int*>(ptrs[7]);
  a.out = const_cast<void*>(ptrs[8]);
  a.B = (int)dims[0];
  a.T = (int)dims[1];
  a.H = (int)dims[2];
  a.KH = (int)dims[3];
  a.S = (int)dims[4];
  a.W = (int)dims[5];
  const int dh = (int)dims[6];
  const int is_f32 = (int)dims[7];
  a.qpos64 = (int)dims[8];
  a.npos64 = (int)dims[9];
  const int splits = (int)dims[10];
  a.kwarps = (int)dims[11];
  const long long* st = dims + 12;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = st[i];
    a.skb[i] = st[3 + i];
    a.svb[i] = st[6 + i];
    a.skn[i] = st[9 + i];
    a.svn[i] = st[12 + i];
  }
  a.sqp[0] = st[15];
  a.sqp[1] = st[16];
  a.snp[0] = st[17];
  a.snp[1] = st[18];
  a.scv = st[19];
  a.scale = scale;
  if (a.B < 1 || a.T < 1 || a.KH < 1 || a.H % a.KH != 0 || a.S < 0) return (int)cudaErrorInvalidValue;
  a.G = a.H / a.KH;
  a.R = a.G * a.T;
  if (!takes(a.R, splits, a.kwarps) || a.W < 1 || (long long)a.B * a.KH > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) return is_f32 ? launch<64, float>(a, splits, s) : launch<64, __nv_bfloat16>(a, splits, s);
  if (dh == 128) return is_f32 ? launch<128, float>(a, splits, s) : launch<128, __nv_bfloat16>(a, splits, s);
  return (int)cudaErrorInvalidValue;
}

// A launch plan's fit, for ops/decode_attention.plan: out[0] the block's
// dynamic shared memory, out[1] how many of its clusters (splits blocks of
// ceil(rows/16) * kwarps warps) the card holds at once (the CUDA runtime's
// occupancy, registers and GPC layout included); both -1 when the kernel
// does not take the plan. Returns a CUDA error code.
extern "C" int rtca_decode_attention_plan(int rows, int dh, int is_f32, int splits, int kwarps, long long* out) {
  if (dh == 64) return is_f32 ? plan_fit<64, float>(rows, splits, kwarps, out)
                              : plan_fit<64, __nv_bfloat16>(rows, splits, kwarps, out);
  if (dh == 128) return is_f32 ? plan_fit<128, float>(rows, splits, kwarps, out)
                               : plan_fit<128, __nv_bfloat16>(rows, splits, kwarps, out);
  return (int)cudaErrorInvalidValue;
}
