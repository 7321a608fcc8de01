// Exact per-row top-k over the last dim: (values, int32 indices), value
// descending, then index ascending.
//
// Replaces the hand-shaped lax program leanyolo_tpu/ops/topk.py:69
// _topk_packed_bf16 (a blocked two-stage sort of packed s32 keys) and the
// blocked lax.top_k fp32 route of topk.py:146-167.
//
// Design: every element becomes a unique unsigned key whose descending order
// is the wanted order: the value's order-preserving bits high and the
// complemented index low (32 bits for bf16 rows of at most 32768, else 64).
// One CTA of 1024 threads per row runs a radix select: each pass histograms
// the next 8 key bits of the keys that still match the prefix found so far
// (256 bins in shared memory), and the k-th largest key's digit extends the
// prefix; the select stops as soon as that digit's bin is taken whole. A
// last pass gathers the k keys at or above the threshold into shared memory
// and a bitonic sort orders them. The row is read from L2 on each pass and
// never held in shared memory, so an fp32 row of 24000 needs no blocked
// second stage.
//
// Bound on an H100: bytes (each input read once). At the decode shapes
// ([32,8400] and [32,24000], k=300) one CTA per row fills only 32 of 132
// SMs; splitting a row over CTAs is later work.
#include "common.cuh"
#include "kernels.h"

namespace {

constexpr int NT = 1024;
constexpr int MAX_K = 1024;

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

template <typename T, typename K>
__global__ void __launch_bounds__(NT)
topk_kernel(const T* __restrict__ x, int n, int k, bool canon, T* __restrict__ vals, int32_t* __restrict__ idx) {
  using Ops = Key<T, K>;
  constexpr int KBITS = 8 * sizeof(K);
  __shared__ unsigned int hist[256];
  __shared__ K sel[MAX_K];
  __shared__ K s_prefix, s_mask;
  __shared__ int s_remaining, s_done, s_count;

  const T* row = x + size_t(blockIdx.x) * n;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_prefix = 0;
    s_mask = 0;
    s_remaining = k;
    s_done = 0;
    s_count = 0;
  }
  for (int shift = KBITS - 8; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += NT) hist[i] = 0u;
    __syncthreads();
    const K prefix = s_prefix, mask = s_mask;
    for (int i = tid; i < n; i += NT) {
      const K key = Ops::make(row, i, canon);
      if ((key & mask) == prefix) atomicAdd(&hist[unsigned(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      // The digit holding the k-th largest key: bins above it hold fewer
      // than `remaining` keys, bins from it down at least that many.
      int rem = s_remaining, d = 255;
      for (; d > 0; --d) {
        const int h = int(hist[d]);
        if (h >= rem) break;
        rem -= h;
      }
      s_prefix = prefix | (K(d) << shift);
      s_mask = mask | (K(255) << shift);
      s_remaining = rem;
      s_done = int(hist[d]) == rem;  // the whole bin is in: the prefix is the threshold
    }
    __syncthreads();
    if (s_done) break;
  }

  // Keys are unique, so exactly k keys are at or above the threshold.
  const K thr = s_prefix;
  for (int i = tid; i < n; i += NT) {
    const K key = Ops::make(row, i, canon);
    if (key >= thr) sel[atomicAdd(&s_count, 1)] = key;
  }
  int P = 1;
  while (P < k) P <<= 1;
  for (int i = k + tid; i < P; i += NT) sel[i] = K(0);
  __syncthreads();

  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P; i += NT) {
        const int j = i ^ stride;
        if (j > i) {
          const K a = sel[i], b = sel[j];
          const bool desc = (i & size) == 0;
          if (desc ? a < b : a > b) {
            sel[i] = b;
            sel[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  T* vrow = vals + size_t(blockIdx.x) * k;
  int32_t* irow = idx + size_t(blockIdx.x) * k;
  for (int i = tid; i < k; i += NT) Ops::decode(sel[i], vrow + i, irow + i);
}

template <typename T, typename K>
void launch(const void* x, int rows, int n, int k, bool canon, void* vals, int32_t* idx, cudaStream_t stream) {
  topk_kernel<T, K><<<rows, NT, 0, stream>>>(static_cast<const T*>(x), n, k, canon, static_cast<T*>(vals), idx);
}

}  // namespace

cudaError_t launch_topk(const void* x, int rows, int n, int k, bool canon_zero, bool bf16, void* vals,
                        int32_t* idx, cudaStream_t stream) {
  if (k < 1 || k > MAX_K || k > n) return cudaErrorInvalidValue;
  if (bf16 && n <= 32768)
    launch<__nv_bfloat16, uint32_t>(x, rows, n, k, canon_zero, vals, idx, stream);
  else if (bf16)
    launch<__nv_bfloat16, uint64_t>(x, rows, n, k, canon_zero, vals, idx, stream);
  else
    launch<float, uint64_t>(x, rows, n, k, canon_zero, vals, idx, stream);
  return cudaSuccess;
}
