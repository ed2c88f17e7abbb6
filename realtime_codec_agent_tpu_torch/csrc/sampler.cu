// The whole seeded draw of one sampled token in one launch (kernel S1).
//
// Not a Pallas kernel: it replaces the jitted sampler of the JAX package,
// realtime_codec_agent_tpu/ops/sampling.py:119-164 (`sample_token`, its
// categorical draw at :161), for one row: the additive logit bias, the
// repeat / frequency / presence penalties over the 64-entry window, the
// min_token_id floor, the exact top-k with top_k_exact's tie rules on both of
// its routes, the dynamic cutoff scalars[7], then on the device either greedy
// (temp <= 0: rank 0) or softmax, top-p, min-p, keep rank 0, divide by
// max(temp, 1e-6), add the Gumbel noise of fold_in(PRNGKey(seed), step) and
// take the argmax (lowest rank on ties). The sampled id is written as an
// int64 at a device address; nothing is read back on the host. The plain
// version is ops/sampling.sample_token_plain; its noise is csrc/threefry.cu's.
//
// What bounds it on the card: one read of the V logits (1,037,376 bytes at V
// = 259,344: 0.31 us at 3.35 TB/s); everything after the top-k works on k <=
// 1,024 values. What held the draw back was launches: the eager plain draw
// is ~40 of them (two index_adds, five wheres, a radix sort of the whole
// vocab, softmax, cumsum, argmax, the gather) plus S1's noise. Here it is one.
//
// Design: one thread-block cluster (up to 16 blocks of 1,024 threads, the
// plan from ops/sampling.sample_plan). Block r owns logits [r * slice, (r +
// 1) * slice) (slice a multiple of 256) and stages them into shared memory as
// order-preserving 32-bit keys (16-byte loads), with the no-penalty
// arithmetic and the floor applied as it reads; the <= 68 bias and window ids
// are then patched by one warp each (first occurrence of an id) with the
// full chain, so the other elements pay no search. Every block then gathers
// all group maxima through distributed shared memory and ranks its own
// groups against them: the two-stage route keeps its k best 256-groups; the
// direct route (groups: the widest power of two <= 256 that still gives >= k
// of them) keeps the elements >= the k-th largest group maximum, the only
// ones that can be in the top-k. The tie key is the route's order among
// equal values: the vocab index on the direct route, (group rank) * 256 +
// position on the two-stage one. A count exchange over the cluster says how
// many elements take part. At most 1,024 (the common case: a few hundred at
// V = 259,344, k = 100) go to block 0 at once as (key, tie, index) triples.
// More (small vocabularies, k = 1,024, a floor that leaves ties at NEG_INF)
// first run a radix select over the cluster: four 8-bit digit passes over
// the keys (warp-aggregated shared histograms, summed over the cluster in
// rank order), then up to three passes over the 24-bit tie key when more
// elements equal the k-th key than the top-k takes; the k selected triples
// go. Block 0 ranks its triples by counting (several threads a triple when
// they are few), then runs the tail over the k values: softmax (summed in
// the order of PyTorch's warp softmax), a sequential cumulative sum in rank
// order, the keep masks, the temperature, the threefry noise of rank i in
// the registers of the thread that owns it, and the argmax. No float atomics
// and fixed reduction orders: the result is bitwise repeatable.
//
// Float contraction: every step the plain version rounds on its own is
// written with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn (nvcc would fuse
// `x - c * f` into an FMA), and expf / logf are the full-precision functions
// PyTorch's kernels call, so the top-k values equal the plain version's bit
// for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 16;    // cluster size (above 8: non-portable)
constexpr int kMaxK = 1024;       // one rank per thread of block 0
constexpr int kMaxSpecial = 128;  // bias + window entries
constexpr int kMaxSmem = 200 * 1024;  // dynamic; the static Shared block takes ~5 KB more
constexpr float kNegInf = -1e30f;  // ops/sampling.NEG_INF
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Args {
  const float* logits;
  const float* scalars;
  const int64_t* bias_ids;
  const float* bias_vals;
  const int64_t* window_ids;
  const float* window_mask;
  const void* step_ptr;
  int64_t* out;
  float* dbg_vals;  // optional: the top-k values after the cutoff, the ids and the probabilities
  int64_t* dbg_ids;
  float* dbg_probs;
  int V, k, n_scalars, n_bias, n_window;
  int two_stage;  // top_k_exact's two-stage route (V % 256 == 0, k <= V / 256, V >= 16,384)
  int group;      // width of the groups whose maxima prefilter (two-stage: 256); 0 = none
  int groups;     // ceil(V / group)
  int slice;      // logits per block, a multiple of 256
  int step_kind;
  uint32_t seed_hi, seed_lo, step_host;
  // rows (blockIdx.y): row r reads its logits at logits + r * row_stride and
  // its own scalars, bias and window, writes out[r] and, with row_keys on
  // the device, draws with that row's key instead of the fields above:
  // key_cols 2, (R, 2) int64 (seed, step), the key PRNGKey(seed) = (0, seed
  // mod 2^32); key_cols 3, (R, 3) int64 (k1, k2, step), any threefry key
  // (k1, k2) (each mod 2^32); either way the noise of fold_in(key, step)
  long long row_stride;
  const int64_t* row_keys;
  int key_cols;
};

// 32-bit keys whose unsigned order is the floats' order
__device__ __forceinline__ uint32_t to_key(float f) {
  const uint32_t b = __float_as_uint(f);
  return b ^ ((b >> 31) ? kFull : 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) { return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : kFull)); }

// the dynamic shared memory of a block, in 32-bit words: the keys of its
// slice, all group maxima, its own groups' maxima and ranks, block 0's <=
// kMaxK (key, tie) pairs and indices and its tail (values, ids,
// probabilities, sums)
struct Layout {
  int keys, allmax, gmax, grank, sel, sel_idx, tv, ti, tp, tc, words;
  __host__ __device__ Layout(int slice, int group, int groups, int k) {
    const int lg = group > 0 ? slice / group : 0;
    keys = 0;
    allmax = keys + slice;
    gmax = allmax + (group > 0 ? (groups + 3) & ~3 : 0);  // allmax padded to whole uint4s
    grank = gmax + lg;
    sel = (grank + lg + 1) & ~1;  // (key, tie) pairs, 8-byte aligned: up to kMaxK of them
    sel_idx = sel + 2 * kMaxK;
    tv = sel_idx + kMaxK;
    ti = tv + k;
    tp = ti + k;
    tc = tp + k;
    words = tc + k;
  }
};

struct Shared {
  uint32_t hist[2][256];  // this block's digit histogram (double-buffered: peers read it after a cluster barrier)
  uint32_t ghist[256];    // the cluster's histogram of the current pass
  int sid[kMaxSpecial];
  float sval[kMaxSpecial];
  uint32_t bin, before;  // find_bin's answer
  uint32_t tau;                              // direct route: the k-th largest group maximum (published by its owner)
  int tau_set;
  int pcount, total;  // this block's participants; the cluster's
  int count, base, slot;
  float sum;
  float red_z[kWarps];
  int red_i[kWarps];
};

// the cluster's histogram of an 8-bit digit: digit(j) in [0, 256) counts
// local element j, -1 leaves it out. Every block ends with the same ghist.
template <class Digit>
__device__ void cluster_histogram(cg::cluster_group& cluster, int nb, Shared& sh, int& parity, int n, Digit digit) {
  uint32_t* h = sh.hist[parity];
  parity ^= 1;
  if (threadIdx.x < 256) h[threadIdx.x] = 0;
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + (int)threadIdx.x;
    const int d = j < n ? digit(j) : -1;
    if (__ballot_sync(kFull, d >= 0) == 0) continue;
    const unsigned peers = __match_any_sync(kFull, d);  // one shared atomic per distinct digit of the warp
    if (d >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&h[d], (uint32_t)__popc(peers));
  }
  cluster.sync();
  if (threadIdx.x < 256) {  // all remote reads in flight at once, then summed in rank order
    uint32_t v[kMaxBlocks];
#pragma unroll
    for (int r = 0; r < kMaxBlocks; ++r) v[r] = r < nb ? cluster.map_shared_rank(h, r)[threadIdx.x] : 0u;
    uint32_t s = 0;
#pragma unroll
    for (int r = 0; r < kMaxBlocks; ++r) s += v[r];
    sh.ghist[threadIdx.x] = s;
  }
  __syncthreads();
}

// warp 0 finds the bin in which the need-th element falls, counting the
// bins from the top (desc) or the bottom; sh.bin, sh.before (the elements in
// the bins before it)
__device__ void find_bin(Shared& sh, uint32_t need, bool desc) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint32_t c[8], s = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int p = lane * 8 + e;
      c[e] = sh.ghist[desc ? 255 - p : p];
      s += c[e];
    }
    uint32_t incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    const uint32_t excl = incl - s;
    if (excl < need && need <= incl) {
      uint32_t acc = excl;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (acc + c[e] >= need) {
          const int p = lane * 8 + e;
          sh.bin = desc ? 255 - p : p;
          sh.before = acc;
          break;
        }
        acc += c[e];
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) sample_token_kernel(const Args rows) {
  extern __shared__ __align__(16) uint32_t dyn[];
  // this cluster's row: the pointers and key of row blockIdx.y (row 0 is the
  // arguments as given, so one row is the single draw)
  Args a = rows;
  {
    const long long r = blockIdx.y;
    a.logits += r * a.row_stride;
    a.scalars += r * a.n_scalars;
    a.bias_ids += r * a.n_bias;
    a.bias_vals += r * a.n_bias;
    a.window_ids += r * a.n_window;
    a.window_mask += r * a.n_window;
    a.out += r;
    if (a.dbg_vals != nullptr) {
      a.dbg_vals += r * a.k;
      a.dbg_ids += r * a.k;
    }
    if (a.dbg_probs != nullptr) a.dbg_probs += r * a.k;
    if (a.row_keys != nullptr) {
      const int64_t* key = a.row_keys + a.key_cols * r;
      a.seed_hi = a.key_cols == 3 ? (uint32_t)key[0] : 0u;
      a.seed_lo = (uint32_t)key[a.key_cols - 2];
      a.step_ptr = key + a.key_cols - 1;
      a.step_kind = 2;
    }
  }
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = rank * a.slice;
  const int n = max(0, min(a.slice, a.V - lo));
  const Layout L(a.slice, a.group, a.groups, a.k);
  uint32_t* keys = dyn + L.keys;

  const float rep = a.scalars[3], freq = a.scalars[4], pres = a.scalars[5], min_id = a.scalars[6];

  // the bias and window entries, loaded first so their latency overlaps the staging
  const int ns = a.n_bias + a.n_window;
  int64_t sid = -1;
  float sval = 0.0f;
  if (tid < ns) {
    const bool is_bias = tid < a.n_bias;
    sid = is_bias ? a.bias_ids[tid] : a.window_ids[tid - a.n_bias];
    sval = is_bias ? a.bias_vals[tid] : a.window_mask[tid - a.n_bias];
  }

  // ---- stage the slice: bias-free, penalty-free arithmetic and the floor
  // (counts 0: out - 0 * freq - 0, which only ever flips a -0)
  const float z0 = __fmul_rn(0.0f, freq);
  auto stage = [&](float x, int j) -> uint32_t {
    return to_key((float)(lo + j) >= min_id ? __fsub_rn(__fsub_rn(x, z0), 0.0f) : kNegInf);
  };
  const int n4 = (reinterpret_cast<uintptr_t>(a.logits) & 15) == 0 ? n >> 2 : 0;  // 16-byte loads where aligned
  {
    const float4* src = reinterpret_cast<const float4*>(a.logits + lo);  // lo is a multiple of 256
    uint4* dst = reinterpret_cast<uint4*>(keys);
    for (int q0 = 0; q0 < n4; q0 += 4 * kThreads) {
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = q0 + u * kThreads + tid;
        x[u] = q < n4 ? __ldg(src + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = q0 + u * kThreads + tid;
        if (q < n4) dst[q] = make_uint4(stage(x[u].x, 4 * q), stage(x[u].y, 4 * q + 1), stage(x[u].z, 4 * q + 2),
                                        stage(x[u].w, 4 * q + 3));
      }
    }
    for (int j = 4 * n4 + tid; j < n; j += kThreads) keys[j] = stage(__ldg(a.logits + lo + j), j);
  }
  // ---- the bias and window ids: the full chain, once per distinct id
  if (tid < ns) {
    sh.sid[tid] = (sid >= 0 && sid < a.V) ? (int)sid : -1;
    sh.sval[tid] = sval;
  }
  if (tid == 0) {
    sh.pcount = 0;
    sh.count = 0;
    sh.slot = 0;
    sh.tau_set = 0;
  }
  __syncthreads();
  for (int t = warp; t < ns; t += kWarps) {  // a warp per entry: the first of its id in this slice patches it
    const int id = sh.sid[t];
    if (id < lo || id >= lo + n) continue;
    bool dup = false;
    float c = 0.0f;  // the window count, summed over the lanes in a fixed order (exact for 0 / 1 masks)
    for (int j = lane; j < ns; j += 32) {
      const bool same = sh.sid[j] == id;
      dup |= same && j < t;
      if (same && j >= a.n_bias) c = __fadd_rn(c, sh.sval[j]);
    }
    if (__any_sync(kFull, dup)) continue;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c = __fadd_rn(c, __shfl_xor_sync(kFull, c, off));
    if (lane == 0) {
      // the staged value stands in for the raw logit: it differs only in the
      // sign of a zero, which the chain below never carries to its result
      // (and a floored id ends at NEG_INF either way)
      float x = from_key(keys[id - lo]);
      for (int j = 0; j < a.n_bias; ++j)
        if (sh.sid[j] == id) x = __fadd_rn(x, sh.sval[j]);  // index_add, in index order
      const bool present = c > 0.0f;
      if (present) x = x > 0.0f ? __fdiv_rn(x, rep) : __fmul_rn(x, rep);
      x = __fsub_rn(__fsub_rn(x, __fmul_rn(c, freq)), present ? pres : 0.0f);
      keys[id - lo] = to_key((float)id >= min_id ? x : kNegInf);
    }
  }
  __syncthreads();

  // ---- group maxima: every block gathers all of them and ranks its own
  // groups by (maximum desc, group index asc)
  uint32_t* allmax = dyn + L.allmax;
  uint32_t* gmax = dyn + L.gmax;
  int* grank = reinterpret_cast<int*>(dyn + L.grank);
  uint32_t tau = 0;  // direct route: elements below it cannot be in the top-k
  if (a.group > 0) {
    const int lg = (n + a.group - 1) / a.group;
    const int per_block = a.slice / a.group;
    for (int q = warp; q < lg; q += kWarps) {
      uint32_t m = 0;
      const int end = min(n, (q + 1) * a.group);
      for (int e = q * a.group + lane; e < end; e += 32) m = max(m, keys[e]);
      m = __reduce_max_sync(kFull, m);
      if (lane == 0) gmax[q] = m;
    }
    cluster.sync();
    const int g4 = (a.groups + 3) >> 2;
    for (int h = tid; h < 4 * g4; h += kThreads)  // the padding reads 0, below every key
      allmax[h] = h < a.groups ? cluster.map_shared_rank(gmax, h / per_block)[h % per_block] : 0u;
    __syncthreads();
    const uint4* allmax4 = reinterpret_cast<const uint4*>(allmax);
    for (int q = warp; q < lg; q += kWarps) {
      const uint32_t m = gmax[q];
      const int gq = rank * per_block + q;
      int c = 0;
      for (int h4 = lane; h4 < g4; h4 += 32) {
        const uint4 o = allmax4[h4];
        const int h = 4 * h4;
        c += (int)((o.x > m) | ((o.x == m) & (h < gq))) + (int)((o.y > m) | ((o.y == m) & (h + 1 < gq))) +
             (int)((o.z > m) | ((o.z == m) & (h + 2 < gq))) + (int)((o.w > m) | ((o.w == m) & (h + 3 < gq)));
      }
      c = __reduce_add_sync(kFull, c);
      if (lane == 0) {
        grank[q] = c < a.k ? c : -1;
        if (!a.two_stage && c == a.k - 1) {
          sh.tau = m;
          sh.tau_set = 1;
        }
      }
    }
    if (!a.two_stage) {
      cluster.sync();  // the owner of the (k-1)-th group has published its maximum
      if (warp == 0) {    // lane r reads block r
        const bool set = lane < nb && *cluster.map_shared_rank(&sh.tau_set, lane);
        const uint32_t t = set ? *cluster.map_shared_rank(&sh.tau, lane) : 0u;
        const unsigned owner = __ballot_sync(kFull, set);
        const uint32_t got = __shfl_sync(kFull, t, __ffs(owner) - 1);
        if (lane == 0) sh.tau = got;
      }
    }
    __syncthreads();
    if (!a.two_stage) tau = sh.tau;
  }

  // the elements that take part and their tie keys (the route's order among
  // equal values)
  const bool two = a.two_stage != 0;
  auto part = [&](int j) -> bool { return two ? grank[j >> 8] >= 0 : keys[j] >= tau; };
  auto tie = [&](int j) -> uint32_t { return two ? (uint32_t)grank[j >> 8] * 256u + (uint32_t)(j & 255) : (uint32_t)(lo + j); };

  // ---- how many take part: few (the prefilter's common case) go to block 0
  // as they are, which ranks them; else a radix select over the cluster first
  {
    int c = 0;
    for (int j = tid; j < n; j += kThreads) c += part(j);
    c = __reduce_add_sync(kFull, c);
    if (lane == 0 && c) atomicAdd(&sh.pcount, c);
  }
  cluster.sync();
  if (warp == 0) {  // lane r reads block r's count
    const int v = lane < nb ? *cluster.map_shared_rank(&sh.pcount, lane) : 0;
    const int before = __reduce_add_sync(kFull, lane < rank ? v : 0);
    const int total = __reduce_add_sync(kFull, v);
    if (lane == 0) {
      sh.base = before;
      sh.total = total;
    }
  }
  __syncthreads();
  uint2* lsel = cluster.map_shared_rank(reinterpret_cast<uint2*>(dyn + L.sel), 0);
  int* lidx = cluster.map_shared_rank(reinterpret_cast<int*>(dyn + L.sel_idx), 0);
  const bool few = sh.total <= kMaxK;  // the same in every block
  if (few) {
    for (int j = tid; j < n; j += kThreads) {
      if (part(j)) {
        const int s = sh.base + atomicAdd(&sh.slot, 1);  // the slot order does not matter: block 0 ranks by value
        lsel[s] = make_uint2(keys[j], tie(j));
        lidx[s] = lo + j;
      }
    }
  } else {
    // ---- radix select of the k-th largest (key, tie) over the cluster
    int parity = 0;
    uint32_t prefix = 0, need = (uint32_t)a.k, n_eq = 0;
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      const uint32_t hi = pass == 0 ? 0u : prefix >> (shift + 8);
      cluster_histogram(cluster, nb, sh, parity, n, [&](int j) -> int {
        const uint32_t key = keys[j];
        if (!part(j) || (pass > 0 && (key >> (shift + 8)) != hi)) return -1;
        return (int)((key >> shift) & 255u);
      });
      find_bin(sh, need, true);
      prefix |= sh.bin << shift;
      need -= sh.before;
      n_eq = sh.ghist[sh.bin];
      __syncthreads();  // sh.bin / sh.before are rewritten by the next pass
    }
    const uint32_t kth = prefix;
    uint32_t tstar = kFull;  // every element equal to the k-th key is taken
    if (need < n_eq) {       // more equal keys than the top-k takes: the smallest ties
      uint32_t tprefix = 0;
      for (int pass = 0; pass < 3; ++pass) {
        const int shift = 16 - 8 * pass;
        const uint32_t hi = pass == 0 ? 0u : tprefix >> (shift + 8);
        cluster_histogram(cluster, nb, sh, parity, n, [&](int j) -> int {
          if (keys[j] != kth || !part(j)) return -1;
          const uint32_t t = tie(j);
          if (pass > 0 && (t >> (shift + 8)) != hi) return -1;
          return (int)((t >> shift) & 255u);
        });
        find_bin(sh, need, false);
        tprefix |= sh.bin << shift;
        need -= sh.before;
        __syncthreads();
      }
      tstar = tprefix;
    }
    auto selected = [&](int j) -> bool {
      const uint32_t key = keys[j];
      return part(j) && (key > kth || (key == kth && tie(j) <= tstar));
    };

    // ---- the k selected triples go to block 0
    int c = 0;
    for (int j = tid; j < n; j += kThreads) c += selected(j);
    c = __reduce_add_sync(kFull, c);
    if (lane == 0 && c) atomicAdd(&sh.count, c);
    cluster.sync();
    if (warp == 0) {  // lane r < rank reads block r's count
      int b = lane < rank ? *cluster.map_shared_rank(&sh.count, lane) : 0;
      b = __reduce_add_sync(kFull, b);
      if (lane == 0) sh.base = b;
    }
    __syncthreads();
    for (int j = tid; j < n; j += kThreads) {
      if (selected(j)) {
        const int s = sh.base + atomicAdd(&sh.slot, 1);  // the slot order does not matter: block 0 ranks by value
        if (s < a.k) {
          lsel[s] = make_uint2(keys[j], tie(j));
          lidx[s] = lo + j;
        }
      }
    }
  }
  cluster.sync();  // block 0 holds every triple; no block's shared memory is read after this
  if (rank != 0) return;

  // ---- block 0: rank by (key desc, tie asc), then the tail. With P triples,
  // `split` threads rank one (P * split <= 1,024), each counting over P /
  // split of the others; ranks below k are the top-k.
  const int K = a.k;
  const int P = few ? sh.total : K;
  const uint2* sel = reinterpret_cast<const uint2*>(dyn + L.sel);
  float* tv = reinterpret_cast<float*>(dyn + L.tv);
  int* ti = reinterpret_cast<int*>(dyn + L.ti);
  float* tp = reinterpret_cast<float*>(dyn + L.tp);
  float* tc = reinterpret_cast<float*>(dyn + L.tc);
  {
    int split = 1;
    while (split < 32 && 2 * split * P <= kThreads) split <<= 1;
    const int p = tid / split, q = tid % split;
    const uint2 me = p < P ? sel[p] : make_uint2(0u, 0u);
    int r = 0;
#pragma unroll 4
    for (int j = q; j < P; j += split) {
      const uint2 o = sel[j];
      r += (int)((o.x > me.x) | ((o.x == me.x) & (o.y < me.y)));
    }
    for (int off = 1; off < split; off <<= 1) r += __shfl_xor_sync(kFull, r, off);
    if (p < P && q == 0 && r < K) {
      tv[r] = from_key(me.x);
      ti[r] = reinterpret_cast<const int*>(dyn + L.sel_idx)[p];
    }
  }
  __syncthreads();
  const float dyn_k = a.n_scalars > 7 ? a.scalars[7] : 0.0f;
  if (tid < K) {
    float v = tv[tid];
    if (!(dyn_k <= 0.0f || (float)tid < dyn_k)) v = kNegInf;
    tv[tid] = v;
    if (a.dbg_vals != nullptr) {
      a.dbg_vals[tid] = v;
      a.dbg_ids[tid] = ti[tid];
    }
  }
  const float temp = a.scalars[2];
  const bool greedy = temp <= 0.0f;
  if (greedy && a.dbg_probs == nullptr) {
    if (tid == 0) *a.out = ti[0];
    return;
  }
  __syncthreads();
  float g = 0.0f;  // the Gumbel noise of rank tid (ahead: it overlaps the softmax's barriers)
  if (!greedy && tid < K) {
    uint32_t key0, key1;
    rtca_threefry::fold_in(a.seed_hi, a.seed_lo, rtca_threefry::read_step(a.step_ptr, a.step_kind, a.step_host), key0,
                           key1);
    g = rtca_threefry::gumbel(rtca_threefry::uniform(key0, key1, (uint32_t)tid));
  }

  // softmax in the order of PyTorch's warp softmax for <= 1,024 columns: lane
  // l sums columns l, l + W, ... (W = min(next power of two >= K, 32)), then
  // an xor butterfly over the W lanes; exp(v - max) / sum
  const float vmax = tv[0];
  if (tid < K) tp[tid] = expf(__fsub_rn(tv[tid], vmax));
  __syncthreads();
  if (warp == 0) {
    int p2 = 1;
    while (p2 < K) p2 <<= 1;
    const int w = min(p2, 32);
    float s = 0.0f;
    if (lane < w)
      for (int e = lane; e < K; e += w) s = __fadd_rn(s, tp[e]);
    for (int off = w / 2; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
    if (lane == 0) sh.sum = s;
  }
  __syncthreads();
  if (tid < K) {
    const float p = __fdiv_rn(tp[tid], sh.sum);
    tp[tid] = p;
    if (a.dbg_probs != nullptr) a.dbg_probs[tid] = p;
  }
  __syncthreads();
  if (greedy) {
    if (tid == 0) *a.out = ti[0];
    return;
  }
  if (tid == 0) {  // the cumulative sum, sequential in rank order (8 loads in flight)
    float s = 0.0f;
    for (int e0 = 0; e0 < K; e0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = e0 + u < K ? tp[e0 + u] : 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (e0 + u < K) {
          s = __fadd_rn(s, v[u]);
          tc[e0 + u] = s;
        }
      }
    }
  }
  __syncthreads();
  const float top_p = a.scalars[0], min_p = a.scalars[1];
  float z = __uint_as_float(0xFF800000u);  // -inf: the threads past k never win
  int zi = 0x7FFFFFFF;
  if (tid < K) {
    const float p = tp[tid];
    const bool keep = tid == 0 || ((__fsub_rn(tc[tid], p) < top_p) && (p >= __fmul_rn(min_p, tp[0])));
    const float scaled = keep ? __fdiv_rn(tv[tid], fmaxf(temp, 1e-6f)) : kNegInf;
    z = __fadd_rn(scaled, g);
    zi = tid;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oz = __shfl_xor_sync(kFull, z, off);
    const int oi = __shfl_xor_sync(kFull, zi, off);
    if (oz > z || (oz == z && oi < zi)) {
      z = oz;
      zi = oi;
    }
  }
  if (lane == 0) {
    sh.red_z[warp] = z;
    sh.red_i[warp] = zi;
  }
  __syncthreads();
  if (warp == 0) {
    z = sh.red_z[lane];
    zi = sh.red_i[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float oz = __shfl_xor_sync(kFull, z, off);
      const int oi = __shfl_xor_sync(kFull, zi, off);
      if (oz > z || (oz == z && oi < zi)) {
        z = oz;
        zi = oi;
      }
    }
    if (lane == 0) *a.out = ti[zi];
  }
}

}  // namespace

// R draws in one launch, one cluster a row (grid (blocks, R)). ptrs:
// logits (R rows of V f32, row r at logits + r * row_stride), scalars (R,
// n_scalars) f32, bias_ids (R, n_bias) int64, bias_vals (R, n_bias) f32,
// window_ids (R, n_window) int64, window_mask (R, n_window) f32, the step
// (int32 / int64 on the device, or null), out (R,) int64, the optional debug
// outputs (R, k) f32 values, (R, k) int64 ids, (R, k) f32 probabilities
// (null: none), and row_keys ((R, key_cols) int64 on the device: (seed,
// step) or (k1, k2, step); or null: every row draws with the key below).
// ints: V, k, n_scalars, n_bias, n_window, two_stage, group, blocks, slice,
// seed_hi, seed_lo, step_kind, step_host, R, row_stride, key_cols (2 or 3).
extern "C" int rtca_sample_token_rows(void** ptrs, const long long* ints, void* stream) {
  Args a;
  a.logits = static_cast<const float*>(ptrs[0]);
  a.scalars = static_cast<const float*>(ptrs[1]);
  a.bias_ids = static_cast<const int64_t*>(ptrs[2]);
  a.bias_vals = static_cast<const float*>(ptrs[3]);
  a.window_ids = static_cast<const int64_t*>(ptrs[4]);
  a.window_mask = static_cast<const float*>(ptrs[5]);
  a.step_ptr = ptrs[6];
  a.out = static_cast<int64_t*>(ptrs[7]);
  a.dbg_vals = static_cast<float*>(ptrs[8]);
  a.dbg_ids = static_cast<int64_t*>(ptrs[9]);
  a.dbg_probs = static_cast<float*>(ptrs[10]);
  a.row_keys = static_cast<const int64_t*>(ptrs[11]);
  a.V = (int)ints[0];
  a.k = (int)ints[1];
  a.n_scalars = (int)ints[2];
  a.n_bias = (int)ints[3];
  a.n_window = (int)ints[4];
  a.two_stage = (int)ints[5];
  a.group = (int)ints[6];
  a.groups = a.group > 0 ? (a.V + a.group - 1) / a.group : 0;
  const int blocks = (int)ints[7];
  a.slice = (int)ints[8];
  a.seed_hi = (uint32_t)ints[9];
  a.seed_lo = (uint32_t)ints[10];
  a.step_kind = (int)ints[11];
  a.step_host = (uint32_t)ints[12];
  const long long n_rows = ints[13];
  a.row_stride = ints[14];
  a.key_cols = (int)ints[15];
  const Layout L(a.slice, a.group, a.groups, a.k);
  const size_t smem = (size_t)L.words * 4;
  const bool dbg_ok = (a.dbg_vals == nullptr) == (a.dbg_ids == nullptr);
  if (a.V < 1 || a.V >= (1 << 24) || a.k < 1 || a.k > kMaxK || a.k > a.V || a.n_scalars < 7 || a.n_bias < 0 ||
      a.n_window < 0 || a.n_bias + a.n_window > kMaxSpecial || blocks < 1 || blocks > kMaxBlocks ||
      a.slice % 256 != 0 || (long long)blocks * a.slice < a.V || (long long)(blocks - 1) * a.slice >= a.V ||
      (a.group > 0 && (256 % a.group != 0 || a.groups < a.k)) ||
      (a.two_stage && (a.group != 256 || a.V % 256 != 0)) || a.step_kind < 0 || a.step_kind > 2 ||
      (a.step_kind != 0 && a.step_ptr == nullptr) || !dbg_ok || smem > (size_t)kMaxSmem || n_rows < 1 ||
      n_rows > 65535 || (n_rows > 1 && a.row_stride < a.V) || (a.key_cols != 2 && a.key_cols != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t e = cudaFuncSetAttribute(sample_token_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(sample_token_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    attrs_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)n_rows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = blocks > 1 ? 1 : 0;  // one block a row: a plain launch (an implicit cluster of one)
  cudaLaunchKernelEx(&cfg, sample_token_kernel, a);
  return (int)cudaGetLastError();
}

// One draw: the rows entry at R = 1 (ints: the first 13 of rtca_sample_token_rows').
extern "C" int rtca_sample_token(void** ptrs, const long long* ints, void* stream) {
  void* p[12];
  for (int i = 0; i < 11; ++i) p[i] = ptrs[i];
  p[11] = nullptr;
  long long n[16];
  for (int i = 0; i < 13; ++i) n[i] = ints[i];
  n[13] = 1;
  n[14] = ints[0];
  n[15] = 2;
  return rtca_sample_token_rows(p, n, stream);
}
