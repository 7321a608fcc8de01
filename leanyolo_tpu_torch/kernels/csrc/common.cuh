// Shared device helpers: activation-type conversions, 16-byte cp.async
// copies and the folded conv epilogue with the JAX forward's rounding
// points.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

template <typename T>
struct Act;

template <>
struct Act<float> {
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
  static __device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Act<__nv_bfloat16> {
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

__device__ __forceinline__ float in_to_float(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float in_to_float(float v) { return v; }
__device__ __forceinline__ float in_to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Rounds v to T and back (the identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Act<T>::to_float(Act<T>::from_float(v));
}

// Folded conv epilogue as the JAX forward computes it in T: the fp32 sum is
// rounded to T, the bias is added in T, SiLU is applied in T.
template <typename T>
__device__ __forceinline__ float bias_silu(float acc, float bias) {
  const float y = round_to<T>(round_to<T>(acc) + bias);
  return round_to<T>(y / (1.0f + expf(-y)));
}

// The same rounding points with the bias and the SiLU each optional (the
// folded 1x1 convs: bias + SiLU, bias alone, or neither).
template <typename T>
__device__ __forceinline__ float conv_epilogue(float acc, float bias, bool has_bias, bool act) {
  float y = round_to<T>(acc);
  if (has_bias) y = round_to<T>(y + bias);
  if (act) y = round_to<T>(y / (1.0f + expf(-y)));
  return y;
}

// 16 bytes global -> shared, asynchronously; a copy of 0 source bytes
// (valid false) zero-fills, so halos and ragged edges cost no branch.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }
