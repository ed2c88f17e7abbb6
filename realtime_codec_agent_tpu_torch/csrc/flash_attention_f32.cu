// Causal flash attention, forward (kernel B4), in f32: the card-against-CPU
// reference of small f32 models and the forward of f32 training
// (compute_dtype="float32"). The bf16 kernel is csrc/flash_attention.cu;
// this file holds the f32 forward, compiled in parallel with it.
//
// Replaces, like the bf16 kernel, the forward of the Pallas TPU kernel
// behind realtime_codec_agent_tpu/ops/nn.py flash_attention_pallas (:284),
// with the same causal and validity-mask contract.
//
// What bounds it on the card: operations, on the f32 units (the tensor
// cores take no full-precision f32 operand): 2 causal products (S = Q K^T,
// O = P V), 4 B H (T^2 / 2) Dh FLOP against 67 TFLOP/s.
//
// Design (csrc/flash_f32_simt.cuh, register-tiled SIMT): one block of 256
// threads per (64-query tile, head, batch row), the query tile the grid's
// slowest axis, longest first. Q lands once; K and V tiles stream through
// two cp.async stages (the next pair in flight while this one is
// computed). Per key tile: S on dot_tile (a thread's 4 x 4 scores), the
// mask, the row max (three shuffles over a warp's 8 lanes of the row, the
// two groups' maxima exchanged through shared memory), one rescale of the
// thread's running sum and output, P into shared memory, then O += P V on
// acc_tile: three barriers a tile. The row sum stays a per-thread partial
// until the end (one sum a row). Every value is summed by one thread in a
// fixed order: two launches give bitwise-equal out and lse. 128 registers a
// thread at Dh 64 (two blocks an SM; ptxas spills 4 bytes), 190 at Dh 128
// (one block: 183 KB of shared memory).
#include "flash_f32_simt.cuh"

namespace {

template <int kD>
struct FwdSmem {
  using L = SimtTile<kD>;
  // Q, then two stages of (K, V), then P
  static constexpr int kBytes = (int)sizeof(float) * (5 * L::kFloats + L::kPFloats);
};

template <int kD>
__global__ void __launch_bounds__(kSimtThreads, kD == 64 ? 2 : 1) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ valid, float* __restrict__ out, float* __restrict__ lse, int T, int H, int KH,
    float scale) {
  using L = SimtTile<kD>;
  constexpr int kE = L::kE;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int i0 = qt * kTile;
  const int ty = simt_ty();
  const int tx = simt_tx();
  const int half = tx >> 3;  // which of the row's two 8-lane groups
  const float escale = scale * kLog2e;  // scores in the exponent's domain (base 2)

  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;
  auto sK = [&](int st) { return smem_f32 + (1 + 2 * st) * L::kFloats; };
  auto sV = [&](int st) { return smem_f32 + (2 + 2 * st) * L::kFloats; };
  float* sP = smem_f32 + 5 * L::kFloats;
  __shared__ uint32_t sLive[2][2];
  __shared__ float sRow[2][kTile];  // each group's row max (a tile), then row sum (the end)

  const size_t q_stride = (size_t)H * kD;
  const size_t kv_stride = (size_t)KH * kD;
  const size_t q_off = (size_t)b * T * q_stride + (size_t)h * kD;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)(h / (H / KH)) * kD;

  stage_rows<kD>(sQ, q + q_off, i0, T, q_stride);
  stage_rows<kD>(sK(0), k + kv_off, 0, T, kv_stride);
  stage_rows<kD>(sV(0), v + kv_off, 0, T, kv_stride);
  cp_async_commit();
  store_live(sLive[0], threadIdx.x < kTile && key_live(valid, b, T, threadIdx.x));

  float4 o[4][kE];
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNeg;
    l[a] = 0.0f;
#pragma unroll
    for (int e = 0; e < kE; ++e) o[a][e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every thread is done with tile kt - 1's stage, P and row maxima
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
    dot_tile<kD>(s, sQ, sK(st), ty, tx);
    if (more) store_live(sLive[st ^ 1], next_live);  // the load was issued before the product
    uint32_t on = col_bits(live_mask(sLive[st]), tx) * 0x1111u;  // bit 4a + c: score (a, c) is live
    if (kt == qt) on = causal_bits<false>(on, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = on_bit(on, a, c) ? s[a][c] * escale : kNeg;
        mx = fmaxf(mx, s[a][c]);
      }
      mx = lanes_max8(mx);
      if ((tx & 7) == 0) sRow[half][r] = mx;
    }
    __syncthreads();  // both groups' row maxima
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const float m_new = fmaxf(m[a], fmaxf(sRow[0][r], sRow[1][r]));
      const float corr = ex2(m[a] - m_new);
      m[a] = m_new;
      l[a] *= corr;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        o[a][e].x *= corr;
        o[a][e].y *= corr;
        o[a][e].z *= corr;
        o[a][e].w *= corr;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = on_bit(on, a, c) ? ex2(s[a][c] - m_new) : 0.0f;
        l[a] += p;
        sP[r * kLdP + tx + 16 * c] = p;
      }
    }
    __syncthreads();  // P complete
    acc_tile<kD>(o, sP, sV(st), ty, tx);
  }

  // the row sums: each group's 8 lanes, then the two groups in order
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float part = lanes_sum8(l[a]);
    if ((tx & 7) == 0) sRow[half][ty + 16 * a] = part;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const int row = i0 + r;
    if (row >= T) continue;
    const float l_row = sRow[0][r] + sRow[1][r];
    const float l_safe = fmaxf(l_row, 1e-30f);
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      *reinterpret_cast<float4*>(out + q_off + chunk_off(row, q_stride, tx, e)) =
          make_float4(o[a][e].x / l_safe, o[a][e].y / l_safe, o[a][e].z / l_safe, o[a][e].w / l_safe);
    }
    if (lse != nullptr && tx == 0) {  // m is in the exponent's domain
      const float lse_row = (m[a] + log2f(l_safe)) * kLn2;
      lse[((size_t)b * H + h) * T + row] = l_row > 0.0f ? lse_row : 0.0f;
    }
  }
}

template <int kD>
int launch_f32(const void* q, const void* k, const void* v, const uint8_t* valid, void* out, float* lse, int B,
               int T, int H, int KH, float scale, cudaStream_t st) {
  const int n_qt = (T + kTile - 1) / kTile;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  const cudaError_t e = allow_smem(flash_fwd_f32_kernel<kD>, FwdSmem<kD>::kBytes, attr_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, n_qt);
  flash_fwd_f32_kernel<kD><<<grid, kSimtThreads, FwdSmem<kD>::kBytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), valid,
      static_cast<float*>(out), lse, T, H, KH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// is_f32 = 1 of rtca_flash_attention (csrc/flash_attention.cu): q, k, v, out
// f32, Dh 64 or 128, checked by the caller.
extern "C" int rtca_flash_attention_f32(const void* q, const void* k, const void* v, const uint8_t* valid,
                                        void* out, float* lse, int B, int T, int H, int KH, int Dh, float scale,
                                        cudaStream_t st) {
  return Dh == 64 ? launch_f32<64>(q, k, v, valid, out, lse, B, T, H, KH, scale, st)
                  : launch_f32<128>(q, k, v, valid, out, lse, B, T, H, KH, scale, st);
}
