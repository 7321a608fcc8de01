// Backward of the k x k, stride-1, "same" max pool (SPPF), NHWC, any B, H,
// W, C and odd k <= 15.
//
// Replaces the Pallas kernel experiments/exp_sppf_bwd.py:83 mpbwd_pallas
// (body :45-80), which runs on every SPPF pool of the train step
// ([B,20,20,256] in yolov10s at 640 px, three pools chained).
//
// Semantics, bit for bit: the dy of window o (centred on o, padded with
// -inf) goes to the FIRST position of the window, in row-major window order
// d = (dh, dw), whose value equals the window max (a window holding a NaN
// routes nowhere: NaN equals nothing). Each dx[p] sums, in f32 from +0.0,
// the dy of every window routed to p in ascending d, and rounds once to the
// activation type. That is the Pallas body's order (its 25 shifted masked
// adds), so the kernels reproduce it exactly; skipping the masked-out +0.0
// terms changes no bit, since a sum started at +0.0 is never -0.0.
//
// SPPF's k = 5 gets instances with the window loops unrolled; any other
// odd k runs the same code with runtime loops.
//
// Bound on an H100: bytes (x and dy read, dx written: 19.7 MB at
// [32,20,20,256] bf16, 5.9 us at 3.35 TB/s).
//
// Two routes, chosen by shape in the wrapper (kernels/mpbwd.py route):
//
// 16-byte route (mpbwd_vec_kernel; C a multiple of 8 bf16 or 4 fp32
// values, 16-byte aligned tensors; every pool of the train step). One CTA
// of 256 threads holds a whole map where it fits two CTAs an SM (the 20x20
// SPPF map at k = 5: 103 KB), else tiles of one as even as the map allows,
// for 4 vectors of channels (32 bf16 or 16 fp32 channels) of one image;
// 10x10 tiles (four waves of CTAs, halo windows routed twice) ran slower
// than whole maps in one wave at [32,20,20,256]. A thread owns one 16-byte vector of
// channels of a pixel, so every copy is one 16-byte load or store and a
// warp's accesses are 8 neighbouring pixels' 64 contiguous bytes. Phase 0
// stages x with its halo of 2*pad (-inf outside the image) and dy of every
// window the outputs gather from in shared memory, in their own type (the
// max and the == of bf16 values are exact in bf16); phase 1 computes each
// window's max on bf16 pairs (NaN-propagating) and the offset d of its
// first max, one byte a channel (four route bytes compared at once in
// phase 2); phase 2 gathers, per output, the dy of the windows routed to it
// from shared memory. At 20x20 a map is one tile: each x and dy is read
// once and each route computed once. What holds it: instructions (25 max
// and 25 compare steps a window, 25 route tests an output) at 16 warps an
// SM, not bytes.
//
// General route (mpbwd_kernel; any C and alignment): one CTA of 256
// threads per (spatial tile of at most 10 x 10 outputs, 32 channels,
// image); a lane owns a channel. Phase 0 stages the x tile with a halo of
// 2*pad as f32; phase 1 writes each window's first-max offset as one byte;
// phase 2 gathers dy from device memory. Halo windows are routed again by
// the neighbouring tile and halo x is read again from L2; both are the
// price of needing no second pass.
#include <cmath>

#include "common.cuh"
#include "kernels.h"

namespace {

constexpr int CB = 32;  // channels per CTA, one per lane
constexpr int WARPS = 8;
constexpr int NO_ROUTE = 255;  // window outside the image, or holding a NaN

__host__ __device__ inline size_t smem_bytes(int TH, int TW, int pad) {
  const size_t xs = size_t(TH + 4 * pad) * (TW + 4 * pad) * CB * sizeof(float);
  const size_t route = size_t(TH + 2 * pad) * (TW + 2 * pad) * CB;
  return xs + route;
}

template <typename T, int KT>
__global__ void __launch_bounds__(CB * WARPS)
mpbwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx, int H, int W, int C, int k_rt,
             int TH, int TW, int tiles_w) {
  // KT > 0: the window size is known at compile time and every loop over the
  // window unrolls; KT == 0 takes it from k_rt.
  const int k = KT > 0 ? KT : k_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pad = k / 2;
  const int XH = TH + 4 * pad, XW = TW + 4 * pad;  // x tile + halo
  const int RW = TW + 2 * pad;                      // route tile width
  const int RN = (TH + 2 * pad) * RW;
  float* xs = reinterpret_cast<float*>(smem);                      // [XH*XW][CB]
  uint8_t* route = reinterpret_cast<uint8_t*>(xs + XH * XW * CB);  // [RN][CB]

  const int lane = threadIdx.x % CB, warp = threadIdx.x / CB;
  const int oy0 = (blockIdx.x / tiles_w) * TH, ox0 = (blockIdx.x % tiles_w) * TW;
  const int c = blockIdx.y * CB + lane;
  const bool cok = c < C;
  const size_t img = size_t(blockIdx.z) * H * W;

  // Phase 0: x tile with a 2*pad halo; -inf outside the image (the pool's pad).
  for (int p = warp; p < XH * XW; p += WARPS) {
    const int gy = oy0 - 2 * pad + p / XW, gx = ox0 - 2 * pad + p % XW;
    float v = -INFINITY;
    if (cok && gy >= 0 && gy < H && gx >= 0 && gx < W) v = Act<T>::to_float(x[(img + size_t(gy) * W + gx) * C + c]);
    xs[p * CB + lane] = v;
  }
  __syncthreads();

  // Phase 1: route(o) = first d whose x equals the window max, for the windows
  // o = (oy0 - pad + i, ox0 - pad + j) the tile's outputs gather from.
  for (int r = warp; r < RN; r += WARPS) {
    const int i = r / RW, j = r % RW;
    const int gy = oy0 - pad + i, gx = ox0 - pad + j;
    int best = NO_ROUTE;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float* w0 = xs + (i * XW + j) * CB + lane;
      float m = -INFINITY;
      bool nan = false;
#pragma unroll
      for (int dh = 0; dh < k; ++dh)
#pragma unroll
        for (int dw = 0; dw < k; ++dw) {
          const float v = w0[(dh * XW + dw) * CB];
          nan |= v != v;
          m = fmaxf(m, v);
        }
      if (!nan) {
        // The last write of a descending scan is the first d in row-major order.
#pragma unroll
        for (int dh = k - 1; dh >= 0; --dh)
#pragma unroll
          for (int dw = k - 1; dw >= 0; --dw)
            if (w0[(dh * XW + dw) * CB] == m) best = dh * k + dw;
      }
    }
    route[r * CB + lane] = static_cast<uint8_t>(best);
  }
  __syncthreads();
  if (!cok) return;

  // Phase 2: dx[p] = sum over d ascending of dy[o = p + pad - d] where route(o) == d.
  for (int q = warp; q < TH * TW; q += WARPS) {
    const int a = q / TW, b = q % TW;
    const int py = oy0 + a, px = ox0 + b;
    if (py >= H || px >= W) continue;
    const uint8_t* r0 = route + ((a + 2 * pad) * RW + (b + 2 * pad)) * CB + lane;
    const T* dy0 = dy + (img + size_t(py + pad) * W + (px + pad)) * C + c;
    float acc = 0.f;
#pragma unroll
    for (int dh = 0; dh < k; ++dh)
#pragma unroll
      for (int dw = 0; dw < k; ++dw)
        if (r0[-(dh * RW + dw) * CB] == dh * k + dw)
          acc += Act<T>::to_float(dy0[-(ptrdiff_t(dh) * W + dw) * C]);
    dx[(img + size_t(py) * W + px) * C + c] = Act<T>::from_float(acc);
  }
}

// Tiles of at most 10 x 10 outputs, as even as the map allows (20 -> 10+10,
// 13 -> 7+6): k = 5 then needs 47.8 KB of shared memory, four CTAs an SM.
constexpr int TILE_MAX = 10;

template <typename T, int KT>
cudaError_t launch_k(const void* x, const void* dy, void* dx, int B, int H, int W, int C, int k,
                     cudaStream_t stream) {
  const int nth = (H + TILE_MAX - 1) / TILE_MAX, ntw = (W + TILE_MAX - 1) / TILE_MAX;
  const int TH = (H + nth - 1) / nth, TW = (W + ntw - 1) / ntw;
  const size_t smem = smem_bytes(TH, TW, k / 2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(mpbwd_kernel<T, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(nth * ntw, (C + CB - 1) / CB, B);
  mpbwd_kernel<T, KT><<<grid, CB * WARPS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                                                          static_cast<T*>(dx), H, W, C, k, TH, TW, ntw);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, void* dx, int B, int H, int W, int C, int k, cudaStream_t stream) {
  return k == 5 ? launch_k<T, 5>(x, dy, dx, B, H, W, C, k, stream) : launch_k<T, 0>(x, dy, dx, B, H, W, C, k, stream);
}

// ------------------------------------------------------------ 16-byte route

constexpr int VT = 256;  // threads a CTA
constexpr int CV = 4;    // 16-byte channel vectors a CTA
constexpr int VP = VT / CV;  // pixels a CTA handles at once
constexpr int VEC_SMEM_MAX = 112 * 1024;  // two CTAs an SM (228 KB, 1 KB of it reserved a CTA)

template <typename T>
struct Vec;

// A route state: four 32-bit words whose lanes hold each channel's first
// max offset so far (255: none). Routes leave it packed one byte a channel.

// 8 bf16 channels as 4 bf16 pairs; a state word holds a pair's two routes
// in its 16-bit halves.
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static constexpr int RW = 2;  // route words a vector (one byte a channel)
  static constexpr unsigned NONE = 0x00FF00FFu;
  static __device__ __forceinline__ uint4 neg_inf() { return make_uint4(0xFF80FF80u, 0xFF80FF80u, 0xFF80FF80u, 0xFF80FF80u); }
  static __device__ __forceinline__ unsigned max2(unsigned a, unsigned b) {
    const __nv_bfloat162 r = __hmax2_nan(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                         *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<const unsigned*>(&r);
  }
  static __device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
    return make_uint4(max2(a.x, b.x), max2(a.y, b.y), max2(a.z, b.z), max2(a.w, b.w));
  }
  // Where a pair of a equals the pair of m (IEEE ==: +0 == -0, NaN equals
  // nothing), that half of the state word takes d.
  static __device__ __forceinline__ void take2(unsigned& st, unsigned a, unsigned m, unsigned d2) {
    const __nv_bfloat162 e = __heq2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                    *reinterpret_cast<const __nv_bfloat162*>(&m));  // 1.0 (0x3F80) or 0 a half
    const unsigned hit = (*reinterpret_cast<const unsigned*>(&e) >> 7 & 0x00010001u) * 0xFFFFu;
    st = (st & ~hit) | (d2 & hit);
  }
  static __device__ __forceinline__ void take(unsigned (&st)[4], uint4 a, uint4 m, unsigned d) {
    const unsigned d2 = d * 0x00010001u;
    take2(st[0], a.x, m.x, d2);
    take2(st[1], a.y, m.y, d2);
    take2(st[2], a.z, m.z, d2);
    take2(st[3], a.w, m.w, d2);
  }
  static __device__ __forceinline__ void pack(const unsigned (&st)[4], unsigned (&r)[RW]) {
    r[0] = __byte_perm(st[0], st[1], 0x6420);
    r[1] = __byte_perm(st[2], st[3], 0x6420);
  }
  static __device__ __forceinline__ float get(uint4 v, int c) {
    const unsigned w = c < 2 ? v.x : c < 4 ? v.y : c < 6 ? v.z : v.w;
    return __uint_as_float((c % 2 ? w >> 16 : w & 0xFFFFu) << 16);
  }
  static __device__ __forceinline__ uint4 round(const float (&a)[N]) {
    uint4 r;
    unsigned* u = reinterpret_cast<unsigned*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(a[2 * j], a[2 * j + 1]);
      u[j] = *reinterpret_cast<const unsigned*>(&p);
    }
    return r;
  }
};

// 4 fp32 channels; a state word holds one channel's route.
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static constexpr int RW = 1;
  static constexpr unsigned NONE = 0xFFu;
  static __device__ __forceinline__ uint4 neg_inf() { return make_uint4(0xFF800000u, 0xFF800000u, 0xFF800000u, 0xFF800000u); }
  static __device__ __forceinline__ unsigned max1(unsigned a, unsigned b) {
    const float fa = __uint_as_float(a), fb = __uint_as_float(b);
    return fa != fa ? a : fb != fb ? b : __float_as_uint(fmaxf(fa, fb));
  }
  static __device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
    return make_uint4(max1(a.x, b.x), max1(a.y, b.y), max1(a.z, b.z), max1(a.w, b.w));
  }
  static __device__ __forceinline__ void take1(unsigned& st, unsigned a, unsigned m, unsigned d) {
    if (__uint_as_float(a) == __uint_as_float(m)) st = d;
  }
  static __device__ __forceinline__ void take(unsigned (&st)[4], uint4 a, uint4 m, unsigned d) {
    take1(st[0], a.x, m.x, d);
    take1(st[1], a.y, m.y, d);
    take1(st[2], a.z, m.z, d);
    take1(st[3], a.w, m.w, d);
  }
  static __device__ __forceinline__ void pack(const unsigned (&st)[4], unsigned (&r)[RW]) {
    r[0] = __byte_perm(__byte_perm(st[0], st[1], 0x0040), __byte_perm(st[2], st[3], 0x0040), 0x5410);
  }
  static __device__ __forceinline__ float get(uint4 v, int c) {
    return __uint_as_float(c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w);
  }
  static __device__ __forceinline__ uint4 round(const float (&a)[N]) {
    return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]), __float_as_uint(a[3]));
  }
};

template <typename T>
__host__ __device__ inline size_t vec_smem_bytes(int TH, int TW, int pad) {
  const size_t x = size_t(TH + 4 * pad) * (TW + 4 * pad) * CV * 16;
  const size_t win = size_t(TH + 2 * pad) * (TW + 2 * pad) * CV;
  return x + win * 16 + win * 4 * Vec<T>::RW;
}

template <typename T, int KT>
__global__ void __launch_bounds__(VT)
mpbwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx, int H, int W, int C, int k_rt,
                 int TH, int TW, int tiles_w) {
  using V = Vec<T>;
  const int k = KT > 0 ? KT : k_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pad = k / 2;
  const int XH = TH + 4 * pad, XW = TW + 4 * pad;  // x tile + halo
  const int RH = TH + 2 * pad, RW = TW + 2 * pad;  // the windows the outputs gather from
  uint4* xs = reinterpret_cast<uint4*>(smem);                  // [XH*XW][CV]
  uint4* dys = xs + XH * XW * CV;                              // [RH*RW][CV]
  unsigned* route = reinterpret_cast<unsigned*>(dys + RH * RW * CV);  // [RH*RW][CV][V::RW], a byte a channel

  const int v = threadIdx.x % CV, p0 = threadIdx.x / CV;
  const int oy0 = (blockIdx.x / tiles_w) * TH, ox0 = (blockIdx.x % tiles_w) * TW;
  const bool vok = (blockIdx.y * CV + v) * V::N < C;
  const size_t img = size_t(blockIdx.z) * H * W;
  const int c0 = (blockIdx.y * CV + v) * V::N;
  auto at = [&](int gy, int gx) { return (img + size_t(gy) * W + gx) * C + c0; };

  // Phase 0: x with its 2*pad halo (-inf outside the image, the pool's
  // pad); dy of the windows (zero outside the image: such a window routes
  // nowhere).
  for (int p = p0; p < XH * XW; p += VP) {
    const int gy = oy0 - 2 * pad + p / XW, gx = ox0 - 2 * pad + p % XW;
    uint4 val = V::neg_inf();
    if (vok && gy >= 0 && gy < H && gx >= 0 && gx < W) val = *reinterpret_cast<const uint4*>(x + at(gy, gx));
    xs[p * CV + v] = val;
  }
  for (int p = p0; p < RH * RW; p += VP) {
    const int gy = oy0 - pad + p / RW, gx = ox0 - pad + p % RW;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (vok && gy >= 0 && gy < H && gx >= 0 && gx < W) val = *reinterpret_cast<const uint4*>(dy + at(gy, gx));
    dys[p * CV + v] = val;
  }
  __syncthreads();

  // Phase 1: route(o) = first d whose x equals the window max, a byte a
  // channel, for the windows o = (oy0 - pad + i, ox0 - pad + j): the max on
  // packed pairs (NaN-propagating), then a descending scan whose last hit
  // is the first d in row-major order.
  for (int r = p0; r < RH * RW; r += VP) {
    const int i = r / RW, j = r % RW;
    const int gy = oy0 - pad + i, gx = ox0 - pad + j;
    unsigned st[4] = {V::NONE, V::NONE, V::NONE, V::NONE};
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const uint4* w0 = xs + (i * XW + j) * CV + v;
      uint4 m = V::neg_inf();
#pragma unroll
      for (int dh = 0; dh < k; ++dh)
#pragma unroll
        for (int dw = 0; dw < k; ++dw) m = V::vmax(m, w0[(dh * XW + dw) * CV]);
#pragma unroll
      for (int dh = k - 1; dh >= 0; --dh)
#pragma unroll
        for (int dw = k - 1; dw >= 0; --dw) V::take(st, w0[(dh * XW + dw) * CV], m, unsigned(dh * k + dw));
    }
    unsigned packed[V::RW];
    V::pack(st, packed);
#pragma unroll
    for (int w = 0; w < V::RW; ++w) route[(r * CV + v) * V::RW + w] = packed[w];
  }
  __syncthreads();
  if (!vok) return;

  // Phase 2: dx[p] = sum over d ascending of dy[o = p + pad - d] where
  // route(o) == d, the route bytes compared four at a time.
  for (int q = p0; q < TH * TW; q += VP) {
    const int a = q / TW, b = q % TW;
    const int py = oy0 + a, px = ox0 + b;
    if (py >= H || px >= W) continue;
    float acc[V::N];
#pragma unroll
    for (int c = 0; c < V::N; ++c) acc[c] = 0.f;
#pragma unroll
    for (int dh = 0; dh < k; ++dh)
#pragma unroll
      for (int dw = 0; dw < k; ++dw) {
        const int o = ((a + 2 * pad - dh) * RW + (b + 2 * pad - dw)) * CV + v;
        const unsigned dd = unsigned(dh * k + dw) * 0x01010101u;
        unsigned hit[V::RW], any = 0u;
#pragma unroll
        for (int w = 0; w < V::RW; ++w) any |= hit[w] = __vcmpeq4(route[o * V::RW + w], dd);
        if (any) {
          const uint4 g = dys[o];
#pragma unroll
          for (int c = 0; c < V::N; ++c)
            if (hit[c / 4] >> (8 * (c % 4)) & 1u) acc[c] += V::get(g, c);
        }
      }
    *reinterpret_cast<uint4*>(dx + at(py, px)) = V::round(acc);
  }
}

template <typename T, int KT>
cudaError_t launch_vec_k(const void* x, const void* dy, void* dx, int B, int H, int W, int C, int k,
                         cudaStream_t stream) {
  // The largest tile side (whole maps up to 32) whose plan fits two CTAs an
  // SM, the map split as evenly as it allows.
  int tmax = 32;
  while (tmax > 1 && vec_smem_bytes<T>(tmax < H ? tmax : H, tmax < W ? tmax : W, k / 2) > VEC_SMEM_MAX) tmax /= 2;
  const int nth = (H + tmax - 1) / tmax, ntw = (W + tmax - 1) / tmax;
  const int TH = (H + nth - 1) / nth, TW = (W + ntw - 1) / ntw;
  const size_t smem = vec_smem_bytes<T>(TH, TW, k / 2);
  auto kernel = mpbwd_vec_kernel<T, KT>;
  static const cudaError_t set = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  if (set != cudaSuccess) return set;
  const int per_cta = CV * Vec<T>::N;
  const dim3 grid(nth * ntw, (C + per_cta - 1) / per_cta, B);
  kernel<<<grid, VT, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), H, W,
                                     C, k, TH, TW, ntw);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_vec(const void* x, const void* dy, void* dx, int B, int H, int W, int C, int k,
                       cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (C % Vec<T>::N || misaligned(x) || misaligned(dy) || misaligned(dx)) return cudaErrorInvalidValue;
  return k == 5 ? launch_vec_k<T, 5>(x, dy, dx, B, H, W, C, k, stream)
                : launch_vec_k<T, 0>(x, dy, dx, B, H, W, C, k, stream);
}

}  // namespace

cudaError_t launch_mpbwd(const void* x, const void* dy, void* dx, int B, int H, int W, int C, int k, bool bf16,
                         bool vec, cudaStream_t stream) {
  if (vec)
    return bf16 ? launch_vec<__nv_bfloat16>(x, dy, dx, B, H, W, C, k, stream)
                : launch_vec<float>(x, dy, dx, B, H, W, C, k, stream);
  return bf16 ? launch<__nv_bfloat16>(x, dy, dx, B, H, W, C, k, stream)
              : launch<float>(x, dy, dx, B, H, W, C, k, stream);
}
