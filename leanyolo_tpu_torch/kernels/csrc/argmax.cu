// Fused per-row max and first argmax over the last dim (the best class of
// each anchor), for up to four levels in one launch.
//
// Replaces the JAX package's lax op leanyolo_tpu/ops/topk.py:90
// max_argmax_lastdim: on the TPU a packed (value, index) key made the pair
// one max-reduce. Here a row of 80 class logits (160 bytes in bf16) is read
// by a group of 4 lanes with 16-byte loads, eight rows a warp, and the pair
// is reduced by warp shuffles inside the group. The level arrays are read
// at constant indices only: a dynamic index into the kernel's parameters
// copies them to local memory, which made a first cut 4x slower.
//
// Rules (kernels/argmax.py): a lane keeps the largest value as a number
// (-0.0 == +0.0) and the first index holding it (a strictly larger value
// replaces it, and a lane's indices ascend), and whether it saw a +0.0;
// lanes merge by value, then by the lower index. The max is that value,
// with its zero's sign settled by the route: canon_zero gives +0.0; else a
// zero max is +0.0 where the row holds a +0.0 (-0.0 ranks below +0.0).
// NaN is outside the contract.
//
// Bound on an H100: bytes. At yolov10s 640, batch 32, the three levels'
// [32, 8400, 80] bf16 logits are 43.0 MB, 12.8 us at 3.35 TB/s; the
// outputs add 2 MB.
#include <cuda_bf16.h>

#include <climits>

#include "kernels.h"

namespace {

constexpr int GROUP = 4;  // lanes a row
constexpr int THREADS = 256;
constexpr int ROWS_PER_CTA = THREADS / GROUP;

struct Best {
  float v;   // the largest value as a number
  int i;     // the first index holding it (INT_MAX: none yet)
  bool pz;   // a +0.0 was seen

  __device__ __forceinline__ void add(float x, int j) {
    if (x > v || i == INT_MAX) v = x, i = j;
    pz |= __float_as_uint(x) == 0u;
  }
  __device__ __forceinline__ void merge(float ov, int oi, bool opz) {
    if (ov > v || (ov == v && oi < i)) v = ov, i = oi;
    pz |= opz;
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// The values of a 16-byte chunk, in order: 8 bf16 or 4 fp32.
__device__ __forceinline__ void add_chunk(Best& best, const uint4& q, int j, __nv_bfloat16) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    best.add(__uint_as_float(u[k] << 16), j + 2 * k);
    best.add(__uint_as_float(u[k] & 0xFFFF0000u), j + 2 * k + 1);
  }
}
__device__ __forceinline__ void add_chunk(Best& best, const uint4& q, int j, float) {
  best.add(__uint_as_float(q.x), j);
  best.add(__uint_as_float(q.y), j + 1);
  best.add(__uint_as_float(q.z), j + 2);
  best.add(__uint_as_float(q.w), j + 3);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
argmax_kernel(ArgmaxLevels lv, int A, int rows_total, int n, bool canon, void* vals, bool vals_bf16, int32_t* idx) {
  const int t = blockIdx.x * ROWS_PER_CTA + threadIdx.x / GROUP;  // global row: b * A + a
  const int g = threadIdx.x % GROUP;
  Best best{__int_as_float(0xff800000), INT_MAX, false};  // -inf
  if (t < rows_total) {
    const int b = t / A, a = t % A;
    // The row's level, by constant indices (a dynamic index into the
    // parameters would copy them to local memory).
    const void* x = lv.x[0];
    long long sb = lv.sb[0], ld = lv.ld[0];
    int start = 0;
#pragma unroll
    for (int l = 1; l < ARGMAX_MAX_LEVELS; ++l) {
      if (l < lv.count && a >= lv.start[l]) x = lv.x[l], sb = lv.sb[l], ld = lv.ld[l], start = lv.start[l];
    }
    const T* p = static_cast<const T*>(x) + b * sb + (a - start) * ld;
    if (VEC) {
      constexpr int V = 16 / sizeof(T);
      const int chunks = n / V;
      for (int c = g; c < chunks; c += GROUP) add_chunk(best, __ldg(reinterpret_cast<const uint4*>(p) + c), c * V, T());
    } else {
      for (int j = g; j < n; j += GROUP) best.add(to_f(p[j]), j);
    }
  }
#pragma unroll
  for (int off = GROUP / 2; off > 0; off /= 2) {
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, best.v, off);
    const int oi = __shfl_xor_sync(0xFFFFFFFFu, best.i, off);
    const bool opz = __shfl_xor_sync(0xFFFFFFFFu, int(best.pz), off);
    best.merge(ov, oi, opz);
  }
  if (t < rows_total && g == 0) {
    const float v = best.v == 0.0f ? ((canon || best.pz) ? 0.0f : -0.0f) : best.v;
    if (vals_bf16) {
      static_cast<__nv_bfloat16*>(vals)[t] = __float2bfloat16_rn(v);  // exact: v came from a bf16
    } else {
      static_cast<float*>(vals)[t] = v;
    }
    idx[t] = best.i;
  }
}

template <typename T>
cudaError_t launch(const ArgmaxLevels& lv, int B, int n, bool canon, void* vals, bool vals_bf16, int32_t* idx,
                   cudaStream_t stream) {
  bool vec = (n * sizeof(T)) % 16 == 0;
  for (int l = 0; l < lv.count; ++l) {
    vec = vec && reinterpret_cast<uintptr_t>(lv.x[l]) % 16 == 0 && (lv.ld[l] * sizeof(T)) % 16 == 0 &&
          (lv.sb[l] * sizeof(T)) % 16 == 0;
  }
  const int A = lv.start[lv.count], rows_total = B * A;
  const int blocks = (rows_total + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  if (vec) {
    argmax_kernel<T, true><<<blocks, THREADS, 0, stream>>>(lv, A, rows_total, n, canon, vals, vals_bf16, idx);
  } else {
    argmax_kernel<T, false><<<blocks, THREADS, 0, stream>>>(lv, A, rows_total, n, canon, vals, vals_bf16, idx);
  }
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_argmax(const ArgmaxLevels& lv, int B, int n, bool bf16, bool canon_zero, void* vals,
                          bool vals_bf16, int32_t* idx, cudaStream_t stream) {
  if (lv.count < 1 || lv.count > ARGMAX_MAX_LEVELS) return cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16>(lv, B, n, canon_zero, vals, vals_bf16, idx, stream)
              : launch<float>(lv, B, n, canon_zero, vals, vals_bf16, idx, stream);
}
