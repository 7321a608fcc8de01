// Exact per-row top-k over the last dim: (values, int32 indices), value
// descending, then index ascending, for any 1 <= k <= n.
//
// Replaces the hand-shaped lax program leanyolo_tpu/ops/topk.py:69
// _topk_packed_bf16 (a blocked two-stage sort of packed s32 keys) and the
// blocked lax.top_k fp32 route of topk.py:146-167.
//
// Keys: every element becomes a unique unsigned key whose descending order
// is the wanted order: the value's order-preserving bits high and the
// complemented index low (32 bits for bf16 rows of at most 32768, else 64).
//
// Bound on an H100: bytes (each input read once, each output written once);
// at the decode shapes ([32,8400] and [32,24000] bf16, k = 300) that is
// 0.65 us for the pair, far below a launch. What holds a kernel back here
// is latency, so the design spreads each row over the card and keeps every
// pass on chip:
// - A thread-block cluster of CL CTAs (up to 8, so that rows * CL fills
//   the 132 SMs) takes one row; each CTA builds the keys of its chunk of the
//   row once, into shared memory (a chunk too large for it rebuilds its
//   keys from the row on each pass instead).
// - Radix select over the value bits only (the keys' high half: 2 passes
//   for 32-bit keys, 4 for 64-bit), 8 bits a pass from the top: each CTA
//   histograms the digit of its keys that still match the prefix found so
//   far into 256 bins, one atomic per distinct digit of a warp
//   (__match_any_sync: the first digit is the value's sign and exponent,
//   so a row's logits crowd a few bins); the cluster's histograms are
//   summed through distributed shared memory; one warp scans the bins (a
//   shuffle scan) for the digit of the k-th largest key. Every CTA computes
//   the same digit. The select stops as soon as that digit's bin is taken
//   whole.
// - The k winners are gathered into a scratch row in device memory: every
//   key above the threshold value, and of the keys at it (ties, which
//   rank by index), the first ones in index order, counted with ballots
//   over contiguous segments: no pass over the index bits.
// - Order: for k <= RANK_MAX_K each CTA copies the k winners to shared
//   memory and places a share of them by rank counting (the keys are
//   unique, so a key's rank is the number of larger keys: its output slot);
//   larger k is sorted by one CTA with a bitonic sort, in shared memory
//   where the next power of two of k fits, else in place in the scratch row.
#include <cooperative_groups.h>

#include "common.cuh"
#include "kernels.h"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;                       // threads a CTA
constexpr int NW = NT / 32;
constexpr int MAX_CLUSTER = 8;                // the portable cluster size
constexpr int RANK_MAX_K = 2048;              // k up to which winners are placed by rank counting
constexpr int KEYS_SMEM_MAX = 96 * 1024;      // a chunk's keys stay in shared memory up to this
constexpr int SORT_SMEM_MAX = 192 * 1024;     // the bitonic sort runs in shared memory up to this

template <typename T, typename K>
struct Key;

// bf16, n <= 32768: the s32 key of topk.py:37-66 with its sign bit flipped.
template <>
struct Key<__nv_bfloat16, uint32_t> {
  static __device__ __forceinline__ uint32_t make(const __nv_bfloat16* row, int i, bool canon) {
    uint32_t bits = reinterpret_cast<const uint16_t*>(row)[i];
    if (canon && bits == 0x8000u) bits = 0u;
    const uint32_t k16 = bits >= 0x8000u ? 0xFFFFu - bits : bits + 0x8000u;
    return (k16 << 16) | uint32_t(32767 - i);
  }
  static __device__ __forceinline__ void decode(uint32_t key, __nv_bfloat16* v, int32_t* idx) {
    const uint32_t k16 = key >> 16;
    *v = __ushort_as_bfloat16(static_cast<unsigned short>(k16 >= 0x8000u ? k16 - 0x8000u : 0xFFFFu - k16));
    *idx = 32767 - int32_t(key & 0xFFFFu);
  }
};

__device__ __forceinline__ uint64_t key64(uint32_t f, int i, bool canon) {
  if (canon && f == 0x80000000u) f = 0u;
  const uint32_t k = (f & 0x80000000u) ? ~f : (f | 0x80000000u);
  return (uint64_t(k) << 32) | uint32_t(0xFFFFFFFFu - uint32_t(i));
}

__device__ __forceinline__ uint32_t key64_bits(uint64_t key, int32_t* idx) {
  const uint32_t k = uint32_t(key >> 32);
  *idx = int32_t(0xFFFFFFFFu - uint32_t(key));
  return (k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k;
}

template <>
struct Key<__nv_bfloat16, uint64_t> {
  static __device__ __forceinline__ uint64_t make(const __nv_bfloat16* row, int i, bool canon) {
    return key64(uint32_t(reinterpret_cast<const uint16_t*>(row)[i]) << 16, i, canon);
  }
  static __device__ __forceinline__ void decode(uint64_t key, __nv_bfloat16* v, int32_t* idx) {
    *v = __ushort_as_bfloat16(static_cast<unsigned short>(key64_bits(key, idx) >> 16));
  }
};

template <>
struct Key<float, uint64_t> {
  static __device__ __forceinline__ uint64_t make(const float* row, int i, bool canon) {
    return key64(__float_as_uint(row[i]), i, canon);
  }
  static __device__ __forceinline__ void decode(uint64_t key, float* v, int32_t* idx) {
    *v = __uint_as_float(key64_bits(key, idx));
  }
};

// How a launch is laid out (host side).
struct Plan {
  int cl;          // CTAs a row (the cluster size)
  int chunk;       // keys a CTA
  bool keys_smem;  // the chunk's keys held in shared memory
  bool rank;       // winners placed by rank counting (else sorted by one CTA)
  bool sort_smem;  // the sort runs in shared memory (else in the scratch row)
  int P;           // the sort's length, the power of two at or above k
  long long cstride;  // scratch keys a row
  size_t smem;     // dynamic shared memory a CTA
};

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

Plan make_plan(int rows, int n, int k, size_t kb) {
  Plan p{};
  p.cl = 1;
  while (p.cl < MAX_CLUSTER && (long long)rows * p.cl * 2 <= sm_count() && (n + 2 * p.cl - 1) / (2 * p.cl) >= NT)
    p.cl *= 2;
  while (p.cl < MAX_CLUSTER && size_t((n + p.cl - 1) / p.cl) * kb > size_t(KEYS_SMEM_MAX)) p.cl *= 2;
  p.chunk = (n + p.cl - 1) / p.cl;
  p.keys_smem = size_t(p.chunk) * kb <= size_t(KEYS_SMEM_MAX);
  p.rank = k <= RANK_MAX_K;
  p.P = 1;
  while (p.P < k) p.P <<= 1;
  p.sort_smem = !p.rank && size_t(p.P) * kb <= size_t(SORT_SMEM_MAX);
  p.cstride = p.rank ? k : p.P;
  size_t smem = p.keys_smem ? size_t(p.chunk) * kb : 0;
  if (p.rank) smem = smem > size_t(k) * kb ? smem : size_t(k) * kb;
  if (p.sort_smem) smem = smem > size_t(p.P) * kb ? smem : size_t(p.P) * kb;
  p.smem = smem;
  return p;
}

template <typename T, typename K>
__global__ void __launch_bounds__(NT)
topk_kernel(const T* __restrict__ x, int n, int k, bool canon, int chunk, bool keys_smem, bool rank_route,
            bool sort_smem, int P, long long cstride, T* __restrict__ vals, int32_t* __restrict__ idx, K* cand) {
  using Ops = Key<T, K>;
  constexpr int KBITS = 8 * sizeof(K);
  __shared__ unsigned hist[2][256];
  __shared__ unsigned tot[256];
  __shared__ int w_gt[NW], w_eq[NW];
  __shared__ int s_digit, s_rem, s_done, s_gt, s_eq;
  extern __shared__ __align__(16) unsigned char dyn[];
  K* keys = reinterpret_cast<K*>(dyn);

  cg::cluster_group cluster = cg::this_cluster();
  const int cl = int(cluster.num_blocks()), me = int(cluster.block_rank());
  const int row = blockIdx.x / cl;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* xrow = x + size_t(row) * n;
  const int lo = min(n, me * chunk), cnt = min(n, lo + chunk) - lo;
  K* crow = cand + row * cstride;

  if (keys_smem)
    for (int i = tid; i < cnt; i += NT) keys[i] = Ops::make(xrow, lo + i, canon);
  auto key_at = [&](int i) -> K { return keys_smem ? keys[i] : Ops::make(xrow, lo + i, canon); };
  for (int i = tid; i < 256; i += NT) hist[0][i] = 0u;
  __syncthreads();

  // Radix select over the value bits (the keys' high half) of the digit,
  // from the top, that holds the k-th largest key; it stops early where
  // that digit's bin is taken whole.
  K prefix = 0, mask = 0;
  int rem = k, shift = KBITS - 8;
  for (int pass = 0;; ++pass, shift -= 8) {
    unsigned* h = hist[pass & 1];
    for (int base = warp * 32; base < cnt; base += NT) {
      const int i = base + lane;
      K key = 0;
      bool on = false;
      if (i < cnt) {
        key = key_at(i);
        on = (key & mask) == prefix;
      }
      const unsigned digit = unsigned(key >> shift) & 255u;
      const unsigned act = __ballot_sync(0xFFFFFFFFu, on);
      if (on) {
        const unsigned peers = __match_any_sync(act, digit);
        if (lane == __ffs(peers) - 1) atomicAdd(&h[digit], unsigned(__popc(peers)));
      }
    }
    cluster.sync();
    // The next pass's buffer: its remote readers (the pass before) are done.
    for (int i = tid; i < 256; i += NT) hist[(pass + 1) & 1][i] = 0u;
    for (int b = tid; b < 256; b += NT) {
      unsigned v[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) v[r] = r < cl ? cluster.map_shared_rank(h, r)[b] : 0u;
      unsigned s = 0;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) s += v[r];
      tot[b] = s;
    }
    __syncthreads();
    if (warp == 0) {
      // Lane l holds bins 255 - 8l down to 248 - 8l; the lane where the
      // count from the top first reaches rem holds the digit.
      unsigned c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += (c[j] = tot[255 - 8 * lane - j]);
      unsigned incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
        if (lane >= off) incl += v;
      }
      const unsigned before = incl - s;
      if (before < unsigned(rem) && incl >= unsigned(rem)) {
        unsigned r = unsigned(rem) - before;
        int d = 248 - 8 * lane;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (c[j] >= r) {
            d = 255 - 8 * lane - j;
            break;
          }
          r -= c[j];
        }
        s_digit = d;
        s_rem = int(r);
        s_done = tot[d] == r;  // the whole bin is in
      }
    }
    __syncthreads();
    prefix |= K(s_digit) << shift;
    mask |= K(255) << shift;
    rem = s_rem;
    if (s_done || shift == KBITS / 2) break;
  }

  // The k winners: every key above the digit's level D, and the first rem
  // keys at it. Below the value bits, keys at D hold one value, so their
  // order is their index's: the first rem in index order. (Where the bin
  // was taken whole, rem is all of them.) Each warp walks a contiguous
  // segment of the chunk, so index order is (CTA, warp, step, lane) order;
  // each CTA writes its winners at its offsets among the cluster's counts.
  const K D = prefix >> shift;
  const int seg = (cnt + NW - 1) / NW, a0 = min(cnt, warp * seg), a1 = min(cnt, a0 + seg);
  int n_gt = 0, n_eq = 0;
  for (int base = a0; base < a1; base += 32) {
    const int i = base + lane;
    const K lv = i < a1 ? key_at(i) >> shift : K(0);
    n_gt += __popc(__ballot_sync(0xFFFFFFFFu, i < a1 && lv > D));
    n_eq += __popc(__ballot_sync(0xFFFFFFFFu, i < a1 && lv == D));
  }
  if (lane == 0) {
    w_gt[warp] = n_gt;
    w_eq[warp] = n_eq;
  }
  __syncthreads();
  if (tid == 0) {
    int g = 0, e = 0;
    for (int w = 0; w < NW; ++w) g += w_gt[w], e += w_eq[w];
    s_gt = g;
    s_eq = e;
  }
  cluster.sync();
  int gt_before = 0, gt_total = 0, eq_before = 0;
  int g[MAX_CLUSTER], e[MAX_CLUSTER];  // every rank's counts, loaded together
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) {
    g[r] = r < cl ? *cluster.map_shared_rank(&s_gt, r) : 0;
    e[r] = r < cl ? *cluster.map_shared_rank(&s_eq, r) : 0;
  }
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) {
    gt_total += g[r];
    if (r < me) gt_before += g[r], eq_before += e[r];
  }
  const int quota = max(0, min(s_eq, rem - eq_before));  // this CTA's keys at D that are in
  const int eq_off = gt_total + min(eq_before, rem);
  int g_at = gt_before, e_ord = 0;
  for (int w = 0; w < warp; ++w) g_at += w_gt[w], e_ord += w_eq[w];
  const unsigned below = (1u << lane) - 1u;
  for (int base = a0; base < a1; base += 32) {
    const int i = base + lane;
    const K key = i < a1 ? key_at(i) : K(0);
    const K lv = key >> shift;
    const unsigned bg = __ballot_sync(0xFFFFFFFFu, i < a1 && lv > D);
    const unsigned be = __ballot_sync(0xFFFFFFFFu, i < a1 && lv == D);
    if (bg >> lane & 1u) crow[g_at + __popc(bg & below)] = key;
    if (be >> lane & 1u) {
      const int ord = e_ord + __popc(be & below);
      if (ord < quota) crow[eq_off + ord] = key;
    }
    g_at += __popc(bg);
    e_ord += __popc(be);
  }
  cluster.sync();  // the row's k winners are in the scratch row, for every CTA of the cluster

  T* vrow = vals + size_t(row) * k;
  int32_t* irow = idx + size_t(row) * k;
  if (rank_route) {
    for (int i = tid; i < k; i += NT) keys[i] = crow[i];
    __syncthreads();
    const int per = (k + cl - 1) / cl, j1 = min(k, (me + 1) * per);
    for (int j = me * per + warp; j < j1; j += NW) {
      const K c = keys[j];
      int r = 0;
      for (int i = lane; i < k; i += 32) r += keys[i] > c;
      r = __reduce_add_sync(0xFFFFFFFFu, r);
      if (lane == 0) Ops::decode(c, vrow + r, irow + r);
    }
    return;
  }
  if (me != 0) return;
  K* buf = sort_smem ? keys : crow;
  if (sort_smem)
    for (int i = tid; i < k; i += NT) buf[i] = crow[i];
  for (int i = k + tid; i < P; i += NT) buf[i] = K(0);
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P; i += NT) {
        const int j = i ^ stride;
        if (j > i) {
          const K a = buf[i], b = buf[j];
          const bool desc = (i & size) == 0;
          if (desc ? a < b : a > b) {
            buf[i] = b;
            buf[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < k; i += NT) Ops::decode(buf[i], vrow + i, irow + i);
}

template <typename T, typename K>
cudaError_t launch(const void* x, int rows, int n, int k, bool canon, void* vals, int32_t* idx, void* scratch,
                   cudaStream_t stream) {
  const Plan p = make_plan(rows, n, k, sizeof(K));
  auto kernel = topk_kernel<T, K>;
  static const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SORT_SMEM_MAX);
  if (set != cudaSuccess) return set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(rows) * unsigned(p.cl));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(p.cl);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), n, k, canon, p.chunk, p.keys_smem, p.rank,
                            p.sort_smem, p.P, p.cstride, static_cast<T*>(vals), idx, static_cast<K*>(scratch));
}

size_t key_bytes(int n, bool bf16) { return bf16 && n <= 32768 ? 4 : 8; }

}  // namespace

size_t topk_scratch_bytes(int rows, int n, int k, bool bf16) {
  const size_t kb = key_bytes(n, bf16);
  return size_t(rows) * size_t(make_plan(rows, n, k, kb).cstride) * kb;
}

cudaError_t launch_topk(const void* x, int rows, int n, int k, bool canon_zero, bool bf16, void* vals,
                        int32_t* idx, void* scratch, cudaStream_t stream) {
  if (k < 1 || k > n || rows < 1) return cudaErrorInvalidValue;
  if (bf16 && key_bytes(n, bf16) == 4)
    return launch<__nv_bfloat16, uint32_t>(x, rows, n, k, canon_zero, vals, idx, scratch, stream);
  if (bf16) return launch<__nv_bfloat16, uint64_t>(x, rows, n, k, canon_zero, vals, idx, scratch, stream);
  return launch<float, uint64_t>(x, rows, n, k, canon_zero, vals, idx, scratch, stream);
}
