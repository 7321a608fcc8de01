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
// G = slots(rows, C) slots of 32 lanes each; lane l of slot g adds rows
// (k G + g) 32 + l for k = 0, 1, ... in that order, from +0.0, with
// __fmul_rn / __fadd_rn (no fused multiply-add, so the plain version's
// separate roundings match); a slot's 32 lane sums meet in a pairwise tree
// (a[l] += a[l + h] for l a multiple of 2h, h = 1, 2, 4, 8, 16), and the G
// slot sums in the same pairwise tree. A row past the end is loaded as 0,
// which adds nothing (a sum started at +0.0 is never -0.0). No
// floating-point atomics, and nothing of the order is read from the device:
// the same input gives the same bits on every launch.
//
// How the CTAs run that order (constants and the shape only):
// - A CTA is one slot of a channel tile: 32 lanes x vt channel vectors (up to
//   8; 256 threads). The 16-byte route gives a thread one 16-byte vector of
//   channels of a row, neighbouring threads neighbouring vectors of a row,
//   so a warp reads whole 128-byte spans of 32 / vt rows; the general route
//   (any strides and C) one value, a warp the 32 lanes of one channel. The
//   row steps are a grid stride: every CTA loads the same count of rows, 16
//   steps in flight a thread (kBatch).
// - The slot's tree: its levels inside a warp by __shfl_xor_sync (the two
//   partners of a level add the same two values, so both hold the same
//   bits), the rest through shared memory in one barrier.
// - The slot's sums go to the partials [G, C] of each moment; the last CTA
//   of the tile to take its ticket (atomicInc on an integer that wraps back
//   to 0, so the counter needs no reset) reads them, warp w the sums of
//   vector w, lane j the G / 32 adjacent slots from j G / 32, 16-byte loads
//   in one round where G <= 128 (two where G is 256: maps of more than 2^18
//   rows only), and finishes the tree.
//   Only the threads that wrote fence before the ticket.
// At the training path's BNs: G * C = 16,384 where C >= 128, G = 256 at its
// three maps above 2^18 rows (C = 64 and 32), G = 128 at its smaller maps
// of C = 64. So 128 to 256 CTAs of 256 threads in bf16 (of 128 where C is
// 32): one to two CTAs an SM on 132 SMs, all resident at once, each
// loading the same count of rows.
//
// Backward (bn_moments_bwd_kernel): dy = g_s1[c] + (2 y) g_s2[c], rounded
// after the product and after the sum, then cast once to y's type: one read
// of y and one write of dy.
//
// Bound on an H100: bytes. Forward: y read once (at the step's largest BN,
// [32, 32, 320, 320] bf16, 210 MB: 63 us at 3.35 TB/s), the partials (at
// most 16,384 of each moment) are noise; backward: y read and dy written.
// The serial tail of a launch is a slot's tree, a fence, the ticket and one
// or two rounds of L2 reads.
#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "kernels.h"

namespace {

constexpr int kLanes = 32;      // row lanes of a slot
constexpr int kMaxVt = 8;       // most channel vectors of a tile (a CTA is one slot: 32 x vt threads)
constexpr int kBatch = 16;      // row steps a thread loads before it adds them
constexpr int kRound = 4;       // the last CTA: slots of a lane loaded at once
constexpr int kMaxSlots = 256;  // bnstats.py MAX_SLOTS: at most two rounds of kRound a lane

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

// V sums at p (16-byte loads where V allows: p is then 16-byte aligned),
// read from L2, where another CTA wrote them; zeros where !in.
template <int V>
__device__ __forceinline__ void load_sums(const float* p, bool in, float* out) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in) f = __ldcg(reinterpret_cast<const float4*>(p) + q);
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

// The pairwise tree over the lanes of a warp whose offsets are below `n`
// (a power of two): levels h = 1, 2, ..., n / 2 by __shfl_xor_sync; the two
// partners of a level add the same two values, so both hold the same bits.
template <int V>
__device__ __forceinline__ void lane_tree(float* a1, float* a2, int n, int step) {
  for (int h = 1; h < n; h <<= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a1[j] = __fadd_rn(a1[j], __shfl_xor_sync(0xFFFFFFFFu, a1[j], h * step));
      a2[j] = __fadd_rn(a2[j], __shfl_xor_sync(0xFFFFFFFFu, a2[j], h * step));
    }
  }
}

// VEC: the 16-byte route (V values a thread, channels fastest); else the
// general route (V = 1, rows fastest). A CTA is slot blockIdx.x (32 lanes x
// vt vectors) of channel tile blockIdx.y. Threads: 32 * vt.
template <typename T, int V, bool VEC>
__global__ void __launch_bounds__(kLanes* kMaxVt)
    bn_moments_kernel(const T* __restrict__ y, Shape s, long long rows, int G, int vt, float* __restrict__ part,
                      unsigned* tickets, float* __restrict__ s1, float* __restrict__ s2) {
  using L = Vec<T, V>;
  __shared__ __align__(16) float wsum[2][kMaxVt][kMaxVt * V];  // the slot's warp sums: [moment][warp][vt V]
  __shared__ bool last;
  const int t = threadIdx.x;
  const int l = VEC ? t / vt : t % kLanes;
  const int v = VEC ? t % vt : t / kLanes;
  const int C = s.C;
  const int c0 = (blockIdx.y * vt + v) * V;  // this thread's first channel; C % V == 0
  const bool active = c0 < C;
  const long long g = blockIdx.x;                                // this CTA's slot
  const long long stride = static_cast<long long>(G) * kLanes;  // rows a step

  float a1[V], a2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.0f;
  for (long long r0 = g * kLanes + l; r0 < rows; r0 += kBatch * stride) {
    typename L::Raw x[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long r = r0 + b * stride;
      x[b] = L::zero();
      if (active && r < rows) x[b] = L::load(y + (VEC ? r * C + c0 : row_offset(s, r) + c0 * s.sC));
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = L::at(x[b], j);
        a1[j] = __fadd_rn(a1[j], f);
        a2[j] = __fadd_rn(a2[j], __fmul_rn(f, f));
      }
    }
  }

  // The slot's tree: its levels inside a warp, then, where the slot spans
  // vt warps (16-byte route), the pairwise tree over the warps' sums by the
  // thread of lane 0.
  const int lw = VEC ? kLanes / vt : kLanes;  // lanes of the slot in a warp
  lane_tree<V>(a1, a2, lw, VEC ? vt : 1);
  if (VEC && vt > 1) {
    if (l % lw == 0) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        wsum[0][l / lw][v * V + j] = a1[j];
        wsum[1][l / lw][v * V + j] = a2[j];
      }
    }
    __syncthreads();
    if (l == 0) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float b1[kMaxVt], b2[kMaxVt];
#pragma unroll
        for (int q = 0; q < kMaxVt; ++q) {
          b1[q] = q < vt ? wsum[0][q][v * V + j] : 0.0f;
          b2[q] = q < vt ? wsum[1][q][v * V + j] : 0.0f;
        }
#pragma unroll
        for (int h = 1; h < kMaxVt; h <<= 1) {
#pragma unroll
          for (int q = 0; q + h < kMaxVt; q += 2 * h) {
            if (q + h < vt) {
              b1[q] = __fadd_rn(b1[q], b1[q + h]);
              b2[q] = __fadd_rn(b2[q], b2[q + h]);
            }
          }
        }
        a1[j] = b1[0];
        a2[j] = b2[0];
      }
    }
  }

  // The slot's sums to the partials, then the ticket: the last CTA of the
  // tile (atomicInc on an integer that wraps back to 0) finishes the slots'
  // tree. Only the writing threads fence before the barrier, and only the
  // thread that finds itself last after the ticket.
  if (l == 0 && active) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      part[g * C + c0 + j] = a1[j];
      part[(G + g) * C + c0 + j] = a2[j];
    }
    __threadfence();
  }
  __syncthreads();
  if (t == 0) {
    last = atomicInc(tickets + blockIdx.y, G - 1) == static_cast<unsigned>(G - 1);
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;

  // Warp w takes vector w of the tile; lane j reads the adjacent slots [j m,
  // j m + m), m = G / 32 (at least 1), kRound of them at a time, and adds
  // them in a pairwise tree; the lanes' pairwise tree then gives the result.
  const int warp = t / kLanes, lane = t % kLanes;
  const int c = (blockIdx.y * vt + warp) * V;
  const int m = G > kLanes ? G / kLanes : 1;
  float b1[V], b2[V];
  for (int e0 = 0; e0 < m; e0 += kRound) {
    float p1[kRound][V], p2[kRound][V];
#pragma unroll
    for (int e = 0; e < kRound; ++e) {
      const int i = lane * m + e0 + e;
      const bool in = e0 + e < m && i < G && c < C;
      load_sums<V>(in ? part + static_cast<long long>(i) * C + c : nullptr, in, p1[e]);
      load_sums<V>(in ? part + static_cast<long long>(G + i) * C + c : nullptr, in, p2[e]);
    }
#pragma unroll
    for (int h = 1; h < kRound; h <<= 1) {
#pragma unroll
      for (int e = 0; e + h < kRound; e += 2 * h) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          p1[e][j] = __fadd_rn(p1[e][j], p1[e + h][j]);
          p2[e][j] = __fadd_rn(p2[e][j], p2[e + h][j]);
        }
      }
    }
    // p[0] is the round's pairwise sum (zeros past m add nothing); m <= 2
    // kRound, so two rounds at most, and their sums meet last.
#pragma unroll
    for (int j = 0; j < V; ++j) {
      b1[j] = e0 == 0 ? p1[0][j] : __fadd_rn(b1[j], p1[0][j]);
      b2[j] = e0 == 0 ? p2[0][j] : __fadd_rn(b2[j], p2[0][j]);
    }
  }
  lane_tree<V>(b1, b2, kLanes, 1);
  if (lane == 0 && c < C) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1[c + j] = b1[j];
      s2[c + j] = b2[j];
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

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

template <typename T, int V, bool VEC>
cudaError_t launch_fwd(const void* y, const Shape& s, int G, float* part, unsigned* tickets, int n_tickets, float* s1,
                       float* s2, cudaStream_t stream) {
  const long long rows = static_cast<long long>(s.N) * s.H * s.W;
  if (G < 1 || G > kMaxSlots || (G & (G - 1)) != 0) return cudaErrorInvalidValue;
  const int nv = (s.C + V - 1) / V;
  const int vt = std::min(kMaxVt, pow2_at_least(nv));
  const int tiles = (nv + vt - 1) / vt;
  if (tiles > 65535 || tiles > n_tickets) return cudaErrorInvalidValue;
  bn_moments_kernel<T, V, VEC><<<dim3(static_cast<unsigned>(G), static_cast<unsigned>(tiles)), kLanes * vt, 0, stream>>>(
      static_cast<const T*>(y), s, rows, G, vt, part, tickets, s1, s2);
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

cudaError_t launch_bn_moments(const void* y, const int* size, const long long* stride, int slots, bool bf16, bool vec,
                              float* partials, unsigned* tickets, int n_tickets, float* s1, float* s2,
                              cudaStream_t stream) {
  const Shape s = shape_of(size, stride);
  if (vec)
    return bf16 ? launch_fwd<__nv_bfloat16, 8, true>(y, s, slots, partials, tickets, n_tickets, s1, s2, stream)
                : launch_fwd<float, 4, true>(y, s, slots, partials, tickets, n_tickets, s1, s2, stream);
  return bf16 ? launch_fwd<__nv_bfloat16, 1, false>(y, s, slots, partials, tickets, n_tickets, s1, s2, stream)
              : launch_fwd<float, 1, false>(y, s, slots, partials, tickets, n_tickets, s1, s2, stream);
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
