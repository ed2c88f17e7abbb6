// Causal flash attention, forward (kernel B4), in f32: the card-against-CPU
// reference of small f32 models (compute_dtype="float32"). The bf16 kernel,
// the one the main paths run, is csrc/flash_attention.cu; this file holds
// the f32 instantiation, compiled in parallel with it.
//
// Replaces, like the bf16 kernel, the forward of the Pallas TPU kernel
// behind realtime_codec_agent_tpu/ops/nn.py flash_attention_pallas (:284),
// with the same causal and validity-mask contract.
//
// What bounds it on the card: operations, on the f32 units (the tensor
// cores take no full-precision f32 operand). It is kept for correctness,
// not speed.
#include "flash_common.cuh"

namespace {

// f32: one query row per kD / 64 threads (each owns 64 of the row's dims;
// 64 rows a block), keys in steps of 16 with one rescale per step; K and V
// tiles staged in (dynamic) shared memory and read as broadcasts (the
// threads of a row read the same key). At Dh = 128 the two threads of a row
// add their halves of each dot product with one shuffle, so a thread keeps
// 64 query and 64 output values in registers at both head dims.
constexpr int kStep = 16;
constexpr int kPart = 64;  // dims per thread

template <int kD>
__global__ void __launch_bounds__(kTile * (kD / kPart)) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ valid, float* __restrict__ out, float* __restrict__ lse, int T, int H,
    int KH, float scale) {
  constexpr int kSplit = kD / kPart;  // threads per row, adjacent lanes
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = qt * kTile + threadIdx.x / kSplit;
  const int d0 = (threadIdx.x % kSplit) * kPart;  // this thread's dims d0 .. d0 + 63

  extern __shared__ __align__(16) float smem_f32[];
  float(*sK)[kD] = reinterpret_cast<float(*)[kD]>(smem_f32);
  float(*sV)[kD] = reinterpret_cast<float(*)[kD]>(smem_f32 + kTile * kD);
  __shared__ uint32_t sLive[2];

  const size_t q_stride = (size_t)H * kD;
  const size_t kv_stride = (size_t)KH * kD;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)(h / (H / KH)) * kD;
  float qr[kPart];
  float o[kPart];
  const float* qrow = q + ((size_t)b * T + row) * q_stride + (size_t)h * kD + d0;
#pragma unroll
  for (int d = 0; d < kPart; ++d) {
    qr[d] = row < T ? qrow[d] : 0.0f;
    o[d] = 0.0f;
  }
  float m_run = kNeg;
  float l_run = 0.0f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    {  // thread i stages dims d0 .. d0 + 63 of key i / kSplit
      const int c = threadIdx.x / kSplit;
      const int key = k0 + c;
      const float4* ks = reinterpret_cast<const float4*>(k + kv_off + (size_t)key * kv_stride + d0);
      const float4* vs = reinterpret_cast<const float4*>(v + kv_off + (size_t)key * kv_stride + d0);
#pragma unroll
      for (int d4 = 0; d4 < kPart / 4; ++d4) {
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        reinterpret_cast<float4*>(&sK[c][d0])[d4] = key < T ? ks[d4] : zero;
        reinterpret_cast<float4*>(&sV[c][d0])[d4] = key < T ? vs[d4] : zero;
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
        for (int d = 0; d < kPart; ++d) dot = fmaf(qr[d], sK[c0 + c][d0 + d], dot);
        if (kSplit == 2) dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        s[c] = (k0 + c0 + c > row || !bit(live, c0 + c)) ? kNeg : dot * scale;
        mx = fmaxf(mx, s[c]);
      }
      const float m_new = fmaxf(m_run, mx);
      const float corr = expf(m_run - m_new);
      m_run = m_new;
      l_run *= corr;
#pragma unroll
      for (int d = 0; d < kPart; ++d) o[d] *= corr;
#pragma unroll
      for (int c = 0; c < kStep; ++c) {
        const float p = (k0 + c0 + c > row || !bit(live, c0 + c)) ? 0.0f : expf(s[c] - m_new);
        l_run += p;
#pragma unroll
        for (int d = 0; d < kPart; ++d) o[d] = fmaf(p, sV[c0 + c][d0 + d], o[d]);
      }
    }
  }
  if (row >= T) return;
  const float l_safe = fmaxf(l_run, 1e-30f);
  float* orow = out + ((size_t)b * T + row) * q_stride + (size_t)h * kD + d0;
#pragma unroll
  for (int d = 0; d < kPart; ++d) orow[d] = o[d] / l_safe;
  if (lse != nullptr && d0 == 0) {
    lse[((size_t)b * H + h) * T + row] = l_run > 0.0f ? m_run + logf(l_safe) : 0.0f;
  }
}

template <int kD>
int launch_f32(const void* q, const void* k, const void* v, const uint8_t* valid, void* out, float* lse, int B,
               int T, int H, int KH, float scale, cudaStream_t st) {
  constexpr int kSmem = 2 * kTile * kD * (int)sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(flash_fwd_f32_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  flash_fwd_f32_kernel<kD><<<grid, kTile * (kD / kPart), kSmem, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                       static_cast<const float*>(v), valid, static_cast<float*>(out),
                                                       lse, T, H, KH, scale);
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
