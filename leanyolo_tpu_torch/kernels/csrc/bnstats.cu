// The training BatchNorm's one-pass batch moments (K8), forward and backward.
//
// Replaces the hand-shaped lax program of the JAX package's
// leanyolo_tpu/models/yolov10/layers.py:189 _bn_act, train branch (:200-205):
// s1 = sum y and s2 = sum y^2 in fp32 over (N, H, W) in one read of the conv
// output, 99 times a yolov10s training step (kernels/bnstats.py).
//
// Forward (bn_moments_kernel): y [N, C, H, W] -> s1, s2 fp32 [C]. The order
// of the additions is fixed by the shape alone (the module doc of
// kernels/bnstats.py, whose plain version spells it in torch operations):
// the N*H*W rows, row r = pixel (n, h, w), are cut into blocks of 32 R rows,
// one CTA (blockIdx.x) each, R = rows_per_lane(rows, C) from the wrapper. In
// a block, row lane l adds rows l, l + 32, ..., l + 32 (R - 1) in that order,
// from +0.0, with __fmul_rn / __fadd_rn (no fused multiply-add, so the plain
// version's separate roundings match); the 32 lane sums meet in a tree in
// shared memory, a[l] += a[l + h] for h = 16, 8, 4, 2, 1. Each CTA writes its
// block's partial sums of its channels; the last CTA of a channel tile to
// take the tile's ticket (atomicInc on an integer that wraps back to 0, so
// the counter needs no reset) sums the tile's partials the same way, with
// the same threads on the same channels: lane l adds partials l, l + 32,
// ..., then the tree. No floating-point atomics: the same input gives the
// same bits on every launch. A row past the end is loaded as 0, which adds
// nothing (a sum started at +0.0 is never -0.0).
//
// Channels: blockIdx.y takes a tile of up to 8 vector lanes. The 16-byte
// route (y in channels_last memory, C a multiple of 8 bf16 or 4 fp32 values,
// 16-byte aligned) gives a thread one 16-byte vector of channels of a row,
// neighbouring threads neighbouring vectors of a row; the general route (any
// strides and C) one value, neighbouring threads neighbouring rows.
//
// Backward (bn_moments_bwd_kernel): dy = g_s1[c] + (2 y) g_s2[c], rounded
// after the product and after the sum, then cast once to y's type: one read
// of y and one write of dy.
//
// Bound on an H100: bytes. Forward: y read once (at the step's largest BN,
// [32, 32, 320, 320] bf16, 210 MB: 63 us at 3.35 TB/s), the partials (at
// most 16,384 of each moment where R allows, 128 KB) are noise; backward: y
// read and dy written. A tile's last CTA sums its partials, the forward's
// serial tail; the tiles' tails run in parallel.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "kernels.h"

namespace {

constexpr int kLanes = 32;     // row lanes of a CTA
constexpr int kVecLanes = 8;   // most vector lanes (channel vectors) of a CTA
constexpr int kCols = 64;      // shared-memory columns: the most channels of a tile (8 vectors of 8 bf16)
constexpr int kBatch = 16;     // rows a lane loads before it adds them
constexpr int kSteps = 4;      // the last CTA: partials of each lane it loads before it adds them

// V values of T of a row: one 16-byte load (V > 1) or one value, kept as
// loaded (`Raw`) until `at` converts value j to float.
template <typename T, int V>
struct Vec;

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  static __device__ __forceinline__ Raw zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ float at(const Raw& r, int j) {
    const unsigned w = j < 2 ? r.x : j < 4 ? r.y : j < 6 ? r.z : r.w;
    return __uint_as_float((j & 1 ? w >> 16 : w & 0xffffu) << 16);  // bf16 -> fp32 is exact
  }
};

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  static __device__ __forceinline__ Raw zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  static __device__ __forceinline__ float at(const Raw& r, int j) { return j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w; }
};

template <typename T>
struct Vec<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ Raw zero() { return Act<T>::from_float(0.0f); }
  static __device__ __forceinline__ float at(const Raw& r, int) { return Act<T>::to_float(r); }
};

// The shape and strides (elements) of y; rows = N * H * W.
struct Shape {
  int N, C, H, W;
  long long sN, sC, sH, sW;
};

__device__ __forceinline__ long long row_offset(const Shape& s, long long r) {
  const long long hw = static_cast<long long>(s.H) * s.W;
  const long long n = r / hw, rem = r - n * hw;
  const long long h = rem / s.W, w = rem - h * s.W;
  return n * s.sN + h * s.sH + w * s.sW;
}

// The tree over the 32 row lanes of sm1 and sm2 [kLanes][kCols], columns
// [col, col + V) of lane l; every thread of the CTA calls it. Leaves the
// sums in row 0.
template <int V>
__device__ __forceinline__ void lane_tree(float (*sm1)[kCols], float (*sm2)[kCols], int l, int col) {
  __syncthreads();
#pragma unroll
  for (int h = kLanes / 2; h > 0; h /= 2) {
    if (l < h) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sm1[l][col + j] = __fadd_rn(sm1[l][col + j], sm1[l + h][col + j]);
        sm2[l][col + j] = __fadd_rn(sm2[l][col + j], sm2[l + h][col + j]);
      }
    }
    __syncthreads();
  }
}

// V partial sums at p (16-byte loads where V allows: p is then 16-byte
// aligned), from L2, where another CTA wrote them; zeros where !in.
template <int V>
__device__ __forceinline__ void load_partials(const float* p, bool in, float* out) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 f = in ? __ldcg(reinterpret_cast<const float4*>(p) + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      out[4 * q] = f.x;
      out[4 * q + 1] = f.y;
      out[4 * q + 2] = f.z;
      out[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = in ? __ldcg(p + j) : 0.0f;
  }
}

// VEC: the 16-byte route (V values a thread, channels fastest); else the
// general route (V = 1, rows fastest).
template <typename T, int V, bool VEC>
__global__ void __launch_bounds__(kLanes* kVecLanes)
    bn_moments_kernel(const T* __restrict__ y, Shape s, long long rows, int R, float* __restrict__ part,
                      unsigned* tickets, float* __restrict__ s1, float* __restrict__ s2) {
  using L = Vec<T, V>;
  __shared__ float sm1[kLanes][kCols];
  __shared__ float sm2[kLanes][kCols];
  __shared__ bool last;
  const int vt_n = blockDim.x / kLanes;  // vector lanes of this CTA
  const int l = VEC ? threadIdx.x / vt_n : threadIdx.x % kLanes;
  const int vt = VEC ? threadIdx.x % vt_n : threadIdx.x / kLanes;
  const int C = s.C;
  const int c0 = (blockIdx.y * vt_n + vt) * V;  // this thread's first channel; C % V == 0
  const bool active = c0 < C;
  const long long base = static_cast<long long>(blockIdx.x) * kLanes * R + l;

  float a1[V], a2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.0f;
  for (int k0 = 0; k0 < R; k0 += kBatch) {
    typename L::Raw v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long r = base + static_cast<long long>(k0 + b) * kLanes;
      v[b] = L::zero();
      if (active && k0 + b < R && r < rows) v[b] = L::load(y + (VEC ? r * C + c0 : row_offset(s, r) + c0 * s.sC));
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float x = L::at(v[b], j);
        a1[j] = __fadd_rn(a1[j], x);
        a2[j] = __fadd_rn(a2[j], __fmul_rn(x, x));
      }
    }
  }
  const int col = vt * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sm1[l][col + j] = a1[j];
    sm2[l][col + j] = a2[j];
  }
  lane_tree<V>(sm1, sm2, l, col);  // a thread past C holds zeros
  const long long blocks = gridDim.x;
  float* p1 = part + c0;  // partial b of a moment: [b * C, (b + 1) * C); s2's after s1's
  float* p2 = part + blocks * C + c0;
  if (l == 0 && active) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      p1[blockIdx.x * static_cast<long long>(C) + j] = sm1[0][col + j];
      p2[blockIdx.x * static_cast<long long>(C) + j] = sm2[0][col + j];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(tickets + blockIdx.y, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The tile's last CTA: lane l adds partials l, l + 32, ... of its
  // thread's channels (read from L2: other CTAs wrote them), kSteps at a
  // time, then the tree.
#pragma unroll
  for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.0f;
  for (long long i0 = l; i0 < blocks; i0 += kSteps * kLanes) {
    float v1[kSteps][V], v2[kSteps][V];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const long long i = i0 + k * kLanes;
      const bool in = active && i < blocks;
      load_partials<V>(p1 + i * C, in, v1[k]);
      load_partials<V>(p2 + i * C, in, v2[k]);
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a1[j] = __fadd_rn(a1[j], v1[k][j]);
        a2[j] = __fadd_rn(a2[j], v2[k][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sm1[l][col + j] = a1[j];
    sm2[l][col + j] = a2[j];
  }
  lane_tree<V>(sm1, sm2, l, col);
  if (l == 0 && active) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1[c0 + j] = sm1[0][col + j];
      s2[c0 + j] = sm2[0][col + j];
    }
  }
}

// dy = g1[c] + (2 y) g2[c] in fp32, cast to T, one vector (VEC: V values
// of a dense channels_last [rows, C], C % V == 0) or one value (y and dy
// each by its own strides, i in logical NCHW order) a thread.
template <typename T, int V, bool VEC>
__global__ void __launch_bounds__(256)
    bn_moments_bwd_kernel(const T* __restrict__ y, const float* __restrict__ g1, const float* __restrict__ g2,
                          T* __restrict__ dy, Shape s, Shape d, long long count) {
  using L = Vec<T, V>;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= count) return;
  long long at_y, at_dy;
  int c;
  if constexpr (VEC) {
    at_y = at_dy = i * V;
    c = static_cast<int>(at_y % s.C);
  } else {
    const long long hw = static_cast<long long>(s.H) * s.W, chw = hw * s.C;
    const long long n = i / chw, rem = i - n * chw;
    c = static_cast<int>(rem / hw);
    const long long p = rem - c * hw, h = p / s.W, w = p - h * s.W;
    at_y = n * s.sN + c * s.sC + h * s.sH + w * s.sW;
    at_dy = n * d.sN + c * d.sC + h * d.sH + w * d.sW;
  }
  const typename L::Raw v = L::load(y + at_y);
  alignas(16) T out[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    out[j] = Act<T>::from_float(__fadd_rn(__ldg(g1 + c + j), __fmul_rn(__fmul_rn(2.0f, L::at(v, j)), __ldg(g2 + c + j))));
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(dy + at_dy) = *reinterpret_cast<const uint4*>(out);
  } else {
    dy[at_dy] = out[0];
  }
}

template <typename T, int V, bool VEC>
cudaError_t launch_fwd(const void* y, const Shape& s, int R, float* part, unsigned* tickets, int n_tickets, float* s1,
                       float* s2, cudaStream_t stream) {
  const long long rows = static_cast<long long>(s.N) * s.H * s.W;
  const long long blocks = (rows + static_cast<long long>(kLanes) * R - 1) / (static_cast<long long>(kLanes) * R);
  const int nv = (s.C + V - 1) / V;
  const int vt = nv < kVecLanes ? nv : kVecLanes;
  const int tiles = (nv + vt - 1) / vt;
  if (blocks > 0x7fffffffLL || tiles > 65535 || tiles > n_tickets) return cudaErrorInvalidValue;
  bn_moments_kernel<T, V, VEC><<<dim3(static_cast<unsigned>(blocks), tiles), kLanes * vt, 0, stream>>>(
      static_cast<const T*>(y), s, rows, R, part, tickets, s1, s2);
  return cudaGetLastError();
}

template <typename T, int V, bool VEC>
cudaError_t launch_bwd(const void* y, const float* g1, const float* g2, void* dy, const Shape& s, const Shape& d,
                       cudaStream_t stream) {
  const long long count = static_cast<long long>(s.N) * s.C * s.H * s.W / V;
  const long long grid = (count + 255) / 256;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  bn_moments_bwd_kernel<T, V, VEC><<<static_cast<unsigned>(grid), 256, 0, stream>>>(
      static_cast<const T*>(y), g1, g2, static_cast<T*>(dy), s, d, count);
  return cudaGetLastError();
}

Shape shape_of(const int* size, const long long* stride) {
  return Shape{size[0], size[1], size[2], size[3], stride[0], stride[1], stride[2], stride[3]};
}

}  // namespace

cudaError_t launch_bn_moments(const void* y, const int* size, const long long* stride, int rows_per_lane, bool bf16,
                              bool vec, float* partials, unsigned* tickets, int n_tickets, float* s1, float* s2,
                              cudaStream_t stream) {
  if (rows_per_lane < 1) return cudaErrorInvalidValue;
  const Shape s = shape_of(size, stride);
  if (vec)
    return bf16 ? launch_fwd<__nv_bfloat16, 8, true>(y, s, rows_per_lane, partials, tickets, n_tickets, s1, s2, stream)
                : launch_fwd<float, 4, true>(y, s, rows_per_lane, partials, tickets, n_tickets, s1, s2, stream);
  return bf16 ? launch_fwd<__nv_bfloat16, 1, false>(y, s, rows_per_lane, partials, tickets, n_tickets, s1, s2, stream)
              : launch_fwd<float, 1, false>(y, s, rows_per_lane, partials, tickets, n_tickets, s1, s2, stream);
}

cudaError_t launch_bn_moments_bwd(const void* y, const float* g_s1, const float* g_s2, void* dy, const int* size,
                                  const long long* y_stride, const long long* dy_stride, bool bf16, bool vec,
                                  cudaStream_t stream) {
  const Shape s = shape_of(size, y_stride), d = shape_of(size, dy_stride);
  if (vec)
    return bf16 ? launch_bwd<__nv_bfloat16, 8, true>(y, g_s1, g_s2, dy, s, d, stream)
                : launch_bwd<float, 4, true>(y, g_s1, g_s2, dy, s, d, stream);
  return bf16 ? launch_bwd<__nv_bfloat16, 1, false>(y, g_s1, g_s2, dy, s, d, stream)
              : launch_bwd<float, 1, false>(y, g_s1, g_s2, dy, s, d, stream);
}
