// Fused per-row max and first argmax over the last dim (the best class of
// each anchor), for up to four levels in one launch; optionally the
// per-image flags of the maps' non-finite values, in the same launch.
//
// Replaces the JAX package's lax op leanyolo_tpu/ops/topk.py:90
// max_argmax_lastdim: on the TPU a packed (value, index) key made the pair
// one max-reduce. Here a row of 80 class logits (160 bytes in bf16) is read
// by a group of 4 lanes with 16-byte loads, eight rows a warp, and the pair
// is reduced by warp shuffles inside the group. The level arrays are read
// at constant indices only: a dynamic index into the kernel's parameters
// copies them to local memory, which made a first cut 4x slower.
//
// Rules (kernels/argmax.py): each value gets a 32-bit order key, its bits
// made order-preserving after -0.0 is mapped to +0.0 (lax's total order:
// -NaN below -inf, +NaN above +inf); on the two-reduce route (canon_zero
// false) every NaN takes the top key, so a NaN propagates and the first one
// wins, as jnp.max and jnp.argmax give it. A lane keeps the largest key,
// the first index holding it and that value's bits, and whether it saw a
// +0.0; lanes merge by key, then by the lower index. On finite values the
// keys order as the numbers do, so a lane whose values are all finite (a
// test of each 16-byte chunk's exponents) compares them as floats and keys
// only its max (keying every value cost a third more time at batch 32). The max is the
// winner's value, with a zero's sign settled by the route: canon_zero gives
// +0.0; else a zero max is +0.0 where the row holds a +0.0.
//
// Flags (FLAGS): the same 4 lanes also read the row's reg bins, a side a
// lane, and the row's non-finite values set words of the image's row of
// DecodeFlags (kernels.h; kernels/argmax.py flags_plain): for class column c the
// first and last such anchor (atomicMax of A - a and of a + 1) and the
// largest NaN bits with the quiet bit set; for box side s a 1 (atomicOr)
// where its 16 bins hold a NaN or +inf or are all -inf. Integer atomics on a
// buffer the launcher zeroes with a memset, so the flags are the same on
// every launch; a finite map takes no atomic at all.
//
// Bound on an H100: bytes. At yolov10s 640, batch 32, the three levels'
// [32, 8400, 80] bf16 logits are 43.0 MB, 12.8 us at 3.35 TB/s; the
// outputs add 2 MB; the flags' read of the [32, 8400, 64] bf16 reg maps
// adds 34.4 MB (10.3 us).
#include <cuda_bf16.h>

#include <climits>

#include "kernels.h"

namespace {

constexpr int GROUP = 4;  // lanes a row
constexpr int THREADS = 256;
constexpr int ROWS_PER_CTA = THREADS / GROUP;

struct Best {
  uint32_t key;  // the largest order key
  int i;         // the first index holding it (INT_MAX: none yet)
  float v;       // its value, bits as read
  bool pz;       // a +0.0 was seen

  static __device__ __forceinline__ uint32_t order_key(float x, bool canon) {
    uint32_t u = __float_as_uint(x);
    if (u == 0x80000000u) u = 0u;
    const uint32_t k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return !canon && x != x ? 0xFFFFFFFFu : k;  // two-reduce: any NaN on top
  }
  __device__ __forceinline__ void add(float x, int j, bool canon) {
    pz |= __float_as_uint(x) == 0u;
    const uint32_t k = order_key(x, canon);
    if (k > key || i == INT_MAX) key = k, i = j, v = x;
  }
  __device__ __forceinline__ void merge(uint32_t ok, int oi, float ov, bool opz) {
    if (ok > key || (ok == key && oi < i)) key = ok, i = oi, v = ov;
    pz |= opz;
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// The values of a 16-byte chunk, in order: 8 bf16 or 4 fp32.
__device__ __forceinline__ void chunk_values(const uint4& q, float* x, __nv_bfloat16) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) x[2 * k] = __uint_as_float(u[k] << 16), x[2 * k + 1] = __uint_as_float(u[k] & 0xFFFF0000u);
}
__device__ __forceinline__ void chunk_values(const uint4& q, float* x, float) {
  x[0] = __uint_as_float(q.x), x[1] = __uint_as_float(q.y), x[2] = __uint_as_float(q.z), x[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ bool finite(float x) { return (__float_as_uint(x) & 0x7F800000u) != 0x7F800000u; }

// Whether a 16-byte chunk holds a non-finite value: an exponent of all ones,
// tested a word at a time (in bf16 on both halves at once: a half of
// (w & 0x7F80) ^ 0x7F80 is zero exactly there, and no other half borrows).
__device__ __forceinline__ bool chunk_nonfinite(const uint4& q, __nv_bfloat16) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
  uint32_t any = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t x = (u[k] & 0x7F807F80u) ^ 0x7F807F80u;
    any |= (x - 0x00010001u) & 0x80008000u;
  }
  return any != 0u;
}
__device__ __forceinline__ bool chunk_nonfinite(const uint4& q, float) {
  return (q.x & 0x7F800000u) == 0x7F800000u || (q.y & 0x7F800000u) == 0x7F800000u ||
         (q.z & 0x7F800000u) == 0x7F800000u || (q.w & 0x7F800000u) == 0x7F800000u;
}

// A non-finite class logit x at anchor a, column j: the column's flags.
__device__ __noinline__ void flag_value(int32_t* row_flags, DecodeFlags fl, int A, int a, int j, float x) {
  atomicMax(row_flags + fl.lo(j), A - a);
  atomicMax(row_flags + fl.hi(j), a + 1);
  if (x != x) atomicMax(reinterpret_cast<unsigned*>(row_flags + fl.nan_bits(j)), __float_as_uint(x) | 0x00400000u);
}

// Whether a reg side's 16 bins make its DFL non-finite: a NaN or +inf bin,
// or all 16 -inf.
__device__ __forceinline__ bool side_bad(const float* v) {
  bool bad = false, all_minus_inf = true;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    bad |= v[i] != v[i] || v[i] == __int_as_float(0x7f800000);
    all_minus_inf &= v[i] == __int_as_float(0xff800000);
  }
  return bad || all_minus_inf;
}

template <typename T, bool VEC, bool FLAGS>
__global__ void __launch_bounds__(THREADS)
argmax_kernel(ArgmaxLevels lv, ArgmaxLevels reg, int A, int rows_total, int n, bool canon, void* vals, bool vals_bf16,
              int32_t* idx, int32_t* flags) {
  const int t = blockIdx.x * ROWS_PER_CTA + threadIdx.x / GROUP;  // global row: b * A + a
  const int g = threadIdx.x % GROUP;
  Best best{0u, INT_MAX, 0.0f, false};
  if (t < rows_total) {
    const int b = t / A, a = t % A;
    // The row's level, by constant indices (a dynamic index into the
    // parameters would copy them to local memory).
    const void* x = lv.x[0];
    const void* rx = reg.x[0];
    long long sb = lv.sb[0], ld = lv.ld[0], rsb = reg.sb[0], rld = reg.ld[0];
    int start = 0;
#pragma unroll
    for (int l = 1; l < ARGMAX_MAX_LEVELS; ++l) {
      if (l < lv.count && a >= lv.start[l]) {
        x = lv.x[l], sb = lv.sb[l], ld = lv.ld[l], start = lv.start[l];
        if (FLAGS) rx = reg.x[l], rsb = reg.sb[l], rld = reg.ld[l];
      }
    }
    const T* p = static_cast<const T*>(x) + b * sb + (a - start) * ld;
    const DecodeFlags fl{n};
    int32_t* row_flags = FLAGS ? fl.row(flags, b) : nullptr;
    // Lane g of the group also checks reg side g's 16 bins (FLAGS).
    const T* rp = FLAGS ? static_cast<const T*>(rx) + b * rsb + (a - start) * rld + g * 16 : nullptr;
    if (VEC) {
      // Every load of the lane issued before any value is used: the side's
      // bins, then up to MAXC chunks of the row (rows of up to 160 bf16 or
      // 80 fp32 classes; longer rows take a loop). Chunks that are all
      // finite, as a head's maps are, take the fast path: numeric compares
      // (NaN aside, they order as the keys do) and the +0.0 test only where
      // the lane's max is a zero. A non-finite value sends the lane's row to
      // the keys and the flags.
      constexpr int V = 16 / sizeof(T), MAXC = 5;
      const int chunks = n / V;
      const uint4* p4 = reinterpret_cast<const uint4*>(p);
      uint4 rq[16 / V];
      if (FLAGS) {
#pragma unroll
        for (int u = 0; u < 16 / V; ++u) rq[u] = __ldg(reinterpret_cast<const uint4*>(rp) + u);
      }
      const auto take = [&](const uint4& q, int c) {
        float xs[V];
        chunk_values(q, xs, T());
#pragma unroll
        for (int e = 0; e < V; ++e) {
          best.add(xs[e], c * V + e, canon);
          if (FLAGS && !finite(xs[e])) flag_value(row_flags, fl, A, a, c * V + e, xs[e]);
        }
      };
      if (chunks <= GROUP * MAXC) {
        uint4 q[MAXC];
        bool bad = false;
#pragma unroll
        for (int u = 0; u < MAXC; ++u) {
          if (g + u * GROUP < chunks) q[u] = __ldg(p4 + g + u * GROUP);
        }
#pragma unroll
        for (int u = 0; u < MAXC; ++u) {
          if (g + u * GROUP < chunks) bad |= chunk_nonfinite(q[u], T());
        }
        if (!bad) {
          float m = 0.0f;
          int mi = INT_MAX;
#pragma unroll
          for (int u = 0; u < MAXC; ++u) {
            if (g + u * GROUP < chunks) {
              float xs[V];
              chunk_values(q[u], xs, T());
#pragma unroll
              for (int e = 0; e < V; ++e) {
                if (mi == INT_MAX || xs[e] > m) m = xs[e], mi = (g + u * GROUP) * V + e;
              }
            }
          }
          if (mi != INT_MAX) {
            best = Best{Best::order_key(m, canon), mi, m, false};
            if (m == 0.0f) {
#pragma unroll
              for (int u = 0; u < MAXC; ++u) {
                if (g + u * GROUP < chunks) {
                  float xs[V];
                  chunk_values(q[u], xs, T());
#pragma unroll
                  for (int e = 0; e < V; ++e) best.pz |= __float_as_uint(xs[e]) == 0u;
                }
              }
            }
          }
        } else {
#pragma unroll
          for (int u = 0; u < MAXC; ++u) {
            if (g + u * GROUP < chunks) take(q[u], g + u * GROUP);
          }
        }
      } else {
        for (int c = g; c < chunks; c += GROUP) take(__ldg(p4 + c), c);
      }
      if (FLAGS) {
        bool bad = false;
#pragma unroll
        for (int u = 0; u < 16 / V; ++u) bad |= chunk_nonfinite(rq[u], T());
        if (bad) {
          float v[16];
#pragma unroll
          for (int u = 0; u < 16 / V; ++u) chunk_values(rq[u], v + u * V, T());
          if (side_bad(v)) atomicOr(row_flags + fl.side(g), 1);
        }
      }
    } else {
      for (int j = g; j < n; j += GROUP) {
        const float xv = to_f(p[j]);
        best.add(xv, j, canon);
        if (FLAGS && !finite(xv)) flag_value(row_flags, fl, A, a, j, xv);
      }
      if (FLAGS) {
        float v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = to_f(rp[i]);
        if (side_bad(v)) atomicOr(row_flags + fl.side(g), 1);
      }
    }
  }
#pragma unroll
  for (int off = GROUP / 2; off > 0; off /= 2) {
    const uint32_t ok = __shfl_xor_sync(0xFFFFFFFFu, best.key, off);
    const int oi = __shfl_xor_sync(0xFFFFFFFFu, best.i, off);
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, best.v, off);
    const bool opz = __shfl_xor_sync(0xFFFFFFFFu, int(best.pz), off);
    best.merge(ok, oi, ov, opz);
  }
  if (t < rows_total && g == 0) {
    const float v = best.v == 0.0f ? ((canon || best.pz) ? 0.0f : -0.0f) : best.v;
    if (vals_bf16) {  // bits: v came from a bf16 (a NaN keeps its own)
      static_cast<__nv_bfloat16*>(vals)[t] = __ushort_as_bfloat16(static_cast<unsigned short>(__float_as_uint(v) >> 16));
    } else {
      static_cast<float*>(vals)[t] = v;
    }
    idx[t] = best.i;
  }
}

template <typename T>
cudaError_t launch(const ArgmaxLevels& lv, const ArgmaxLevels* reg, int B, int n, bool canon, void* vals,
                   bool vals_bf16, int32_t* idx, int32_t* flags, cudaStream_t stream) {
  const auto aligned = [](const ArgmaxLevels& l, int row) {
    bool ok = (row * sizeof(T)) % 16 == 0;
    for (int i = 0; i < l.count; ++i) {
      ok = ok && reinterpret_cast<uintptr_t>(l.x[i]) % 16 == 0 && (l.ld[i] * sizeof(T)) % 16 == 0 &&
           (l.sb[i] * sizeof(T)) % 16 == 0;
    }
    return ok;
  };
  const bool vec = aligned(lv, n) && (!reg || aligned(*reg, 64));
  const int A = lv.start[lv.count], rows_total = B * A;
  const int blocks = (rows_total + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  if (reg) {
    const cudaError_t e = cudaMemsetAsync(flags, 0, size_t(B) * size_t(DecodeFlags{n}.width()) * sizeof(int32_t), stream);
    if (e != cudaSuccess) return e;
    if (vec) {
      argmax_kernel<T, true, true><<<blocks, THREADS, 0, stream>>>(lv, *reg, A, rows_total, n, canon, vals, vals_bf16,
                                                                    idx, flags);
    } else {
      argmax_kernel<T, false, true><<<blocks, THREADS, 0, stream>>>(lv, *reg, A, rows_total, n, canon, vals,
                                                                     vals_bf16, idx, flags);
    }
  } else if (vec) {
    argmax_kernel<T, true, false><<<blocks, THREADS, 0, stream>>>(lv, lv, A, rows_total, n, canon, vals, vals_bf16,
                                                                   idx, nullptr);
  } else {
    argmax_kernel<T, false, false><<<blocks, THREADS, 0, stream>>>(lv, lv, A, rows_total, n, canon, vals, vals_bf16,
                                                                    idx, nullptr);
  }
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_argmax(const ArgmaxLevels& lv, const ArgmaxLevels* reg, int B, int n, bool bf16, bool canon_zero,
                          void* vals, bool vals_bf16, int32_t* idx, int32_t* flags, cudaStream_t stream) {
  if (lv.count < 1 || lv.count > ARGMAX_MAX_LEVELS || (reg && (reg->count != lv.count || !flags)))
    return cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16>(lv, reg, B, n, canon_zero, vals, vals_bf16, idx, flags, stream)
              : launch<float>(lv, reg, B, n, canon_zero, vals, vals_bf16, idx, flags, stream);
}
