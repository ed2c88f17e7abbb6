// Causal flash attention, backward (kernel B4's dq and dk/dv), in f32, head
// dim 64 or 128: the gradient of the f32 forward in flash_attention_f32.cu
// (training and scoring at compute_dtype="float32"). The bf16 kernels, the
// ones the bf16 main paths run, are in flash_attention_bwd.cu.
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
// cores take no full-precision f32 operand): dq runs 3 causal products (S,
// dP, dQ), dk/dv 4 (S, dP, dV, dK). It is kept right, not fast (the f32
// path is the debugging one); PERF.md has its times against that bound.
//
// Design, the f32 forward's, narrower: 64 rows a block, kD / 16 adjacent
// threads a row, each owning 16 of its dims, so that a thread keeps its
// row's operand pairs and its one or two gradient accumulators (48 or 64
// floats) in registers at both head dims, within 128 registers (256 or 512
// threads a block, 16 warps an SM); the threads of a row add their parts of
// each dot product with two or three xor shuffles, so every thread of the
// row holds the same sum. (32 dims a thread took all 255 registers, spilled
// and was many times slower.) A thread's dims are every (kD / 16)-th
// float4 of the row (part p owns float4s p, p + kD / 16, ...), so the
// threads of a row read neighbouring 16-byte words of a staged row: no bank
// conflicts. The streamed tiles are staged in shared memory and read as
// broadcasts (the rows of a warp read the same element).
// - dq kernel: one block per (64-query tile, head, batch), the tile index the
//   grid's slowest axis, longest first. It writes delta for its rows first
//   (the dk/dv kernel, launched after it on the same stream, reads it), then
//   walks the key tiles from 0 to the diagonal: K and V staged, dQ in
//   registers.
// - dk/dv kernel: one block per (64-key tile, KV head, batch), longest
//   first. K and V of its keys in registers; the Q and dO tiles of the H / KH
//   query heads of its KV head staged in turn, head by head, from the
//   diagonal tile to the last, with their lse and delta.
// Every output element is summed by one thread in a fixed order (the
// heads of a KV head in order inside the block), no atomics: two launches on
// the same inputs give bitwise-equal dq, dk, dv and delta.
#include "flash_common.cuh"

namespace {

constexpr int kPart = 16;  // dims per thread
constexpr int kChunks = kPart / 4;  // float4s per thread

// the sum of a dot product's parts over the kSplit adjacent threads of a row
template <int kSplit>
__device__ __forceinline__ float row_sum(float x) {
  if (kSplit >= 2) x += __shfl_xor_sync(0xffffffffu, x, 1);
  if (kSplit >= 4) x += __shfl_xor_sync(0xffffffffu, x, 2);
  if (kSplit >= 8) x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// float4 i of part p of a row: float4 i * kSplit + p of its kD / 4
template <int kSplit>
__device__ __forceinline__ int chunk(int i, int p) {
  return i * kSplit + p;
}

// a thread's part p of row `row` of a (B, T, heads, kD) f32 tensor (at `src`,
// the head's first element of batch row 0), zeros past T
template <int kD>
__device__ __forceinline__ void load_part(float4 (&dst)[kChunks], const float* src, int row, int T,
                                          size_t row_stride, int p) {
  constexpr int kSplit = kD / kPart;
  const float4* s = reinterpret_cast<const float4*>(src + (size_t)row * row_stride);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) dst[i] = row < T ? s[chunk<kSplit>(i, p)] : zero;
}

// a 64-row tile (rows row0 ..) into shared memory, zeros past T: thread t
// copies part t % kSplit of row t / kSplit
template <int kD>
__device__ __forceinline__ void stage_tile(float4 (*dst)[kD / 4], const float* src, int row0, int T,
                                           size_t row_stride) {
  constexpr int kSplit = kD / kPart;
  const int r = threadIdx.x / kSplit;
  const int p = threadIdx.x % kSplit;
  float4 part[kChunks];
  load_part<kD>(part, src, row0 + r, T, row_stride, p);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) dst[r][chunk<kSplit>(i, p)] = part[i];
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

template <int kD>
__global__ void __launch_bounds__(kTile * (kD / kPart), 128 / kD) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ out, const float* __restrict__ dout, const float* __restrict__ lse,
    const uint8_t* __restrict__ valid, float* __restrict__ dq, float* __restrict__ delta, int T, int H, int KH,
    float scale) {
  constexpr int kSplit = kD / kPart;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int row = qt * kTile + threadIdx.x / kSplit;
  const int p = threadIdx.x % kSplit;

  extern __shared__ __align__(16) float4 smem_bwd_f32[];
  float4(*sK)[kD / 4] = reinterpret_cast<float4(*)[kD / 4]>(smem_bwd_f32);
  float4(*sV)[kD / 4] = reinterpret_cast<float4(*)[kD / 4]>(smem_bwd_f32 + kTile * kD / 4);
  __shared__ uint32_t sLive[2];

  const size_t q_stride = (size_t)H * kD;
  const size_t kv_stride = (size_t)KH * kD;
  const size_t head_off = (size_t)b * T * q_stride + (size_t)h * kD;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)(h / (H / KH)) * kD;
  float4 qr[kChunks], dor[kChunks], acc[kChunks];
  load_part<kD>(qr, q + head_off, row, T, q_stride, p);
  load_part<kD>(dor, dout + head_off, row, T, q_stride, p);
  load_part<kD>(acc, out + head_off, row, T, q_stride, p);
  float dlt = 0.0f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    dlt = dot4(dor[i], acc[i], dlt);
    acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  dlt = row_sum<kSplit>(dlt);
  const size_t stat = ((size_t)b * H + h) * T + row;
  const float lse_row = row < T ? lse[stat] : 0.0f;
  if (row < T && p == 0) delta[stat] = dlt;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage_tile<kD>(sK, k + kv_off, k0, T, kv_stride);
    stage_tile<kD>(sV, v + kv_off, k0, T, kv_stride);
    load_live(sLive, valid, b, T, k0);
    __syncthreads();
    const uint64_t live = live_mask(sLive);
    // one key at a time: its K and V parts serve the dot products and the dQ
    // update from registers (a wider step kept them live and spilled)
#pragma unroll 1
    for (int c = 0; c < kTile; ++c) {
      float4 kc[kChunks], vc[kChunks];
      float sc = 0.0f, pc = 0.0f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        kc[i] = sK[c][chunk<kSplit>(i, p)];
        vc[i] = sV[c][chunk<kSplit>(i, p)];
        sc = dot4(qr[i], kc[i], sc);
        pc = dot4(dor[i], vc[i], pc);
      }
      sc = row_sum<kSplit>(sc);
      pc = row_sum<kSplit>(pc);
      const bool on = k0 + c <= row && bit(live, c);
      const float pr = on ? expf(sc * scale - lse_row) : 0.0f;
      const float ds = pr * (pc - dlt) * scale;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) axpy4(ds, kc[i], acc[i]);
    }
  }
  if (row >= T) return;
  float4* dst = reinterpret_cast<float4*>(dq + head_off + (size_t)row * q_stride);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) dst[chunk<kSplit>(i, p)] = acc[i];
}

template <int kD>
__global__ void __launch_bounds__(kTile * (kD / kPart), 128 / kD) flash_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ valid, float* __restrict__ dk, float* __restrict__ dv, int T, int H, int KH,
    float scale) {
  constexpr int kSplit = kD / kPart;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int kt = blockIdx.z;
  const int key = kt * kTile + threadIdx.x / kSplit;
  const int p = threadIdx.x % kSplit;
  const int n_rep = H / KH;

  extern __shared__ __align__(16) float4 smem_bwd_f32[];
  float4(*sQ)[kD / 4] = reinterpret_cast<float4(*)[kD / 4]>(smem_bwd_f32);
  float4(*sO)[kD / 4] = reinterpret_cast<float4(*)[kD / 4]>(smem_bwd_f32 + kTile * kD / 4);
  __shared__ float sLse[kTile];
  __shared__ float sDelta[kTile];

  const size_t q_stride = (size_t)H * kD;
  const size_t kv_stride = (size_t)KH * kD;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)kh * kD;
  float4 kr[kChunks], vr[kChunks], dk_acc[kChunks], dv_acc[kChunks];
  load_part<kD>(kr, k + kv_off, key, T, kv_stride, p);
  load_part<kD>(vr, v + kv_off, key, T, kv_stride, p);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    dk_acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dv_acc[i] = dk_acc[i];
  }
  const bool key_live = key < T && (valid == nullptr || valid[(size_t)b * T + key] != 0);
  const int n_qt = (T + kTile - 1) / kTile;

  for (int g = 0; g < n_rep; ++g) {
    const int h = kh * n_rep + g;
    const size_t head_off = (size_t)b * T * q_stride + (size_t)h * kD;
    for (int qt = kt; qt < n_qt; ++qt) {
      const int i0 = qt * kTile;
      __syncthreads();
      stage_tile<kD>(sQ, q + head_off, i0, T, q_stride);
      stage_tile<kD>(sO, dout + head_off, i0, T, q_stride);
      if (threadIdx.x < kTile) {
        const int i = i0 + threadIdx.x;
        const size_t stat = ((size_t)b * H + h) * T + i;
        sLse[threadIdx.x] = i < T ? lse[stat] : 0.0f;
        sDelta[threadIdx.x] = i < T ? delta[stat] : 0.0f;
      }
      __syncthreads();
#pragma unroll 1
      for (int c = 0; c < kTile; ++c) {  // one query at a time, as dq's keys
        float4 qc[kChunks], oc[kChunks];
        float sc = 0.0f, pc = 0.0f;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          qc[j] = sQ[c][chunk<kSplit>(j, p)];
          oc[j] = sO[c][chunk<kSplit>(j, p)];
          sc = dot4(kr[j], qc[j], sc);
          pc = dot4(vr[j], oc[j], pc);
        }
        sc = row_sum<kSplit>(sc);
        pc = row_sum<kSplit>(pc);
        const int i = i0 + c;
        const bool on = key_live && key <= i && i < T;
        const float pr = on ? expf(sc * scale - sLse[c]) : 0.0f;
        const float ds = pr * (pc - sDelta[c]) * scale;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          axpy4(pr, oc[j], dv_acc[j]);
          axpy4(ds, qc[j], dk_acc[j]);
        }
      }
    }
  }
  if (key >= T) return;
  float4* dk_row = reinterpret_cast<float4*>(dk + kv_off + (size_t)key * kv_stride);
  float4* dv_row = reinterpret_cast<float4*>(dv + kv_off + (size_t)key * kv_stride);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    dk_row[chunk<kSplit>(i, p)] = dk_acc[i];
    dv_row[chunk<kSplit>(i, p)] = dv_acc[i];
  }
}

bool bad_shape(int B, int T, int H, int KH, int Dh) {
  return B < 1 || T < 1 || KH < 1 || H % KH != 0 || H > 65535 || B > 65535 || (T + kTile - 1) / kTile > 65535 ||
         (Dh != 64 && Dh != 128);
}

// both kernels stage two 64-row tiles of kD floats (above 48 KB at kD 128)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

template <int kD>
int launch_dq(const float* q, const float* k, const float* v, const float* out, const float* dout,
              const float* lse, const uint8_t* valid, float* dq, float* delta, int B, int T, int H, int KH,
              float scale, cudaStream_t st) {
  constexpr int kSmem = 2 * kTile * kD * (int)sizeof(float);
  static bool attr_set = false;
  const cudaError_t e = allow_smem(flash_bwd_dq_f32_kernel<kD>, kSmem, attr_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (T + kTile - 1) / kTile);
  flash_bwd_dq_f32_kernel<kD><<<grid, kTile * (kD / kPart), kSmem, st>>>(q, k, v, out, dout, lse, valid, dq, delta,
                                                                         T, H, KH, scale);
  return (int)cudaGetLastError();
}

template <int kD>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout, const float* lse,
               const float* delta, const uint8_t* valid, float* dk, float* dv, int B, int T, int H, int KH,
               float scale, cudaStream_t st) {
  constexpr int kSmem = 2 * kTile * kD * (int)sizeof(float);
  static bool attr_set = false;
  const cudaError_t e = allow_smem(flash_bwd_dkv_f32_kernel<kD>, kSmem, attr_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(KH, B, (T + kTile - 1) / kTile);
  flash_bwd_dkv_f32_kernel<kD><<<grid, kTile * (kD / kPart), kSmem, st>>>(q, k, v, dout, lse, delta, valid, dk, dv,
                                                                          T, H, KH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dq (B, T, H, Dh) and delta (B, H, T) f32 from q, out, dout (B, T, H, Dh),
// k, v (B, T, KH, Dh) f32, lse (B, H, T) f32, valid (B, T) uint8 or null;
// Dh 64 or 128, every tensor contiguous and 16-byte aligned.
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
extern "C" int rtca_flash_attention_bwd_dkv_f32(const float* q, const float* k, const float* v, const float* dout,
                                                const float* lse, const float* delta, const uint8_t* valid, float* dk,
                                                float* dv, int B, int T, int H, int KH, int Dh, float scale,
                                                void* stream) {
  if (bad_shape(B, T, H, KH, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return Dh == 64 ? launch_dkv<64>(q, k, v, dout, lse, delta, valid, dk, dv, B, T, H, KH, scale, st)
                  : launch_dkv<128>(q, k, v, dout, lse, delta, valid, dk, dv, B, T, H, KH, scale, st);
}
