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
// adds), so the kernel reproduces it exactly; skipping the masked-out +0.0
// terms changes no bit, since a sum started at +0.0 is never -0.0.
//
// SPPF's k = 5 gets an instance with the window loops unrolled; any other
// odd k runs the same code with runtime loops.
//
// Design: one CTA of 256 threads per (spatial tile of TH x TW outputs, 32
// channels, image); a lane owns a channel, so every global and shared access
// of a warp is 32 consecutive channels. Phase 0 stages the x tile with a
// halo of 2*pad (-inf outside the image) in shared memory as f32; phase 1
// writes, for every window the tile's outputs can receive from (the tile
// plus a halo of pad), the offset d of its first max into shared memory as
// one byte; phase 2 gives each thread output positions p and gathers
// dy[p + pad - d] over d where route(p + pad - d) == d. A gather, not a
// scatter: no atomics, deterministic, each dy read at most once per tile.
//
// Bound on an H100: bytes (x and dy read, dx written: 19.7 MB at
// [32,20,20,256] bf16, 5.9 us at 3.35 TB/s). Halo windows are routed again
// by the neighbouring tile (1.96x the route work at 10x10 tiles of a 20x20
// map) and halo x is read again from L2; both are the price of needing no
// second pass.
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

}  // namespace

cudaError_t launch_mpbwd(const void* x, const void* dy, void* dx, int B, int H, int W, int C, int k, bool bf16,
                         cudaStream_t stream) {
  return bf16 ? launch<__nv_bfloat16>(x, dy, dx, B, H, W, C, k, stream)
              : launch<float>(x, dy, dx, B, H, W, C, k, stream);
}
