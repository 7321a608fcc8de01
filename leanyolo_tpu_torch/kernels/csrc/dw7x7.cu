// Depthwise 7x7 conv, pad 3, stride 1, + bias + SiLU, NHWC, any B, H, W, C.
//
// Replaces the Pallas kernel experiments/exp_dw_pallas.py:75 dw_pallas (the
// folded RepVGGDW of yolov10s's backbone c8 and neck p4_p5, [B,20,20,512]
// on the serving path), without its hard-coded 20x20x512 shape.
//
// Design: the Pallas kernel's own idea, one image's map held on chip, cut
// for an SM. A CTA of 8 warps takes a whole map (or a band of rows, and of
// columns where a row is too wide, of a larger one) for 64 channels: it
// copies the map with its 3-pixel zero halo into shared memory in the
// activation type with 16-byte cp.async copies (26x26x64 bf16 = 86.5 KB at
// 20x20, two CTAs per SM), and the 49 taps of its channels as fp32. A lane
// owns a channel pair (paired loads, fp32 FMAs); a warp computes a strip
// of 4 outputs of one row at a time, reading each input pair once per
// kernel row for the whole strip, conflict-free (a warp reads one pixel's
// 64 consecutive channels). The epilogue rounds as the folded JAX forward
// does (common.cuh bias_silu), stages the strip in shared memory and
// writes it in 16-byte stores. Channel counts that are not a multiple of 16
// bytes (an odd C) take scalar copies and stores, masked.
//
// Bound on an H100: bytes (at [32,20,20,512] bf16, 26 MB in and out against
// 0.64 GFLOP). Each input byte is read from device memory once (the halo
// lies outside the map), each output written once.
#include "common.cuh"
#include "kernels.h"

namespace {

constexpr int K = 7, PAD = 3;
constexpr int CG = 64;          // channels per CTA: 32 lanes x a pair
constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int SX = 4;           // outputs per warp task along W
constexpr int BUDGET = 110 * 1024;  // shared memory per CTA: two fit on an SM

template <typename T>
struct Plan {
  int th, tw;  // output rows and columns per CTA
  static constexpr int PIX = CG * sizeof(T);  // bytes of a pixel's channel group
  static constexpr int FIXED = K * K * CG * 4 + WARPS * SX * PIX;  // taps + output staging
  __host__ __device__ static int twp(int tw) { return (tw + SX - 1) / SX * SX; }
  __host__ __device__ static int bytes(int th, int tw) { return (th + K - 1) * (twp(tw) + K - 1) * PIX + FIXED; }

  Plan(int H, int W) {
    const int per_row = (twp(W) + K - 1) * PIX;
    if (bytes(H < 8 ? H : 8, W) <= BUDGET) {  // whole rows: bands of rows
      tw = W;
      th = (BUDGET - FIXED) / per_row - (K - 1);
      if (th >= H) {
        th = H;
      } else {
        const int bands = (H + th - 1) / th;
        th = (H + bands - 1) / bands;  // even bands
      }
    } else {  // rows too wide: 8-row bands of column blocks
      th = H < 8 ? H : 8;
      tw = ((BUDGET - FIXED) / ((th + K - 1) * PIX) - (K - 1)) / SX * SX;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
dw7x7_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias, T* __restrict__ out,
             int H, int W, int C, int TH, int TW, int bands_w, bool vec) {
  constexpr int V = 16 / sizeof(T), CPP = CG / V;  // elements per 16 bytes; 16-byte chunks per pixel
  extern __shared__ __align__(16) unsigned char smem[];
  const int TWP = Plan<T>::twp(TW), SWD = TWP + K - 1, SHT = TH + K - 1;
  T* tile = reinterpret_cast<T*>(smem);
  float* wsm = reinterpret_cast<float*>(smem + size_t(SHT) * SWD * Plan<T>::PIX);
  T* stage = reinterpret_cast<T*>(wsm + K * K * CG);

  const int b = blockIdx.z, c0 = blockIdx.y * CG;
  const int oy0 = blockIdx.x / bands_w * TH, ox0 = blockIdx.x % bands_w * TW;
  const size_t img = size_t(b) * H * W;

  // The input tile with its halo, zero outside the map and past C.
  if (vec) {
    for (int i = threadIdx.x; i < SHT * SWD * CPP; i += THREADS) {
      const int p = i / CPP, ch = i % CPP * V;
      const int gy = oy0 - PAD + p / SWD, gx = ox0 - PAD + p % SWD;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + ch < C;
      cp_async16(tile + size_t(p) * CG + ch, ok ? x + (img + size_t(gy) * W + gx) * C + c0 + ch : x, ok);
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < SHT * SWD * CG; i += THREADS) {
      const int p = i / CG, ch = i % CG;
      const int gy = oy0 - PAD + p / SWD, gx = ox0 - PAD + p % SWD;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + ch < C;
      tile[i] = ok ? x[(img + size_t(gy) * W + gx) * C + c0 + ch] : Act<T>::from_float(0.f);
    }
  }
  for (int i = threadIdx.x; i < K * K * CG; i += THREADS) {
    const int t = i / CG, ch = i % CG;
    wsm[i] = c0 + ch < C ? Act<T>::to_float(w[size_t(t) * C + c0 + ch]) : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, ch = 2 * lane;
  const bool ok0 = c0 + ch < C, ok1 = c0 + ch + 1 < C;
  const float2 bi = make_float2(ok0 ? Act<T>::to_float(bias[c0 + ch]) : 0.f,
                                ok1 ? Act<T>::to_float(bias[c0 + ch + 1]) : 0.f);
  T* st = stage + warp * SX * CG;
  const int strips = TWP / SX;
  for (int task = warp; task < TH * strips; task += WARPS) {
    const int ty = task / strips, tx0 = task % strips * SX, oy = oy0 + ty;
    if (oy >= H) break;  // rows only grow with the task index
    float2 acc[SX];
#pragma unroll
    for (int s = 0; s < SX; ++s) acc[s] = make_float2(0.f, 0.f);
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      const T* row = tile + (size_t(ty + kh) * SWD + tx0) * CG + ch;
      float2 in[SX + K - 1];
#pragma unroll
      for (int j = 0; j < SX + K - 1; ++j) in[j] = Act<T>::load2(row + j * CG);
#pragma unroll
      for (int kw = 0; kw < K; ++kw) {
        const float2 wv = *reinterpret_cast<const float2*>(wsm + (kh * K + kw) * CG + ch);
#pragma unroll
        for (int s = 0; s < SX; ++s) {
          acc[s].x = fmaf(in[s + kw].x, wv.x, acc[s].x);
          acc[s].y = fmaf(in[s + kw].y, wv.y, acc[s].y);
        }
      }
    }
    T* orow = out + (img + size_t(oy) * W + ox0 + tx0) * C + c0;
    if (vec) {
#pragma unroll
      for (int s = 0; s < SX; ++s)
        Act<T>::store2(st + s * CG + ch, bias_silu<T>(acc[s].x, bi.x), bias_silu<T>(acc[s].y, bi.y));
      __syncwarp();
      for (int i = lane; i < SX * CPP; i += 32) {
        const int s = i / CPP, cc = i % CPP * V;
        if (tx0 + s < TW && ox0 + tx0 + s < W && c0 + cc < C)
          *reinterpret_cast<uint4*>(orow + size_t(s) * C + cc) = *reinterpret_cast<const uint4*>(st + s * CG + cc);
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int s = 0; s < SX; ++s) {
        if (tx0 + s >= TW || ox0 + tx0 + s >= W) continue;
        if (ok0) orow[size_t(s) * C + ch] = Act<T>::from_float(bias_silu<T>(acc[s].x, bi.x));
        if (ok1) orow[size_t(s) * C + ch + 1] = Act<T>::from_float(bias_silu<T>(acc[s].y, bi.y));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* out, int B, int H, int W, int C,
                   cudaStream_t stream) {
  const Plan<T> plan(H, W);
  if (plan.th < 1 || plan.tw < 1) return cudaErrorInvalidValue;
  static const cudaError_t set =
      cudaFuncSetAttribute(dw7x7_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, BUDGET);
  if (set != cudaSuccess) return set;
  constexpr int V = 16 / sizeof(T);
  const bool vec = C % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int bands_w = (W + plan.tw - 1) / plan.tw, bands_h = (H + plan.th - 1) / plan.th;
  const dim3 grid(bands_w * bands_h, (C + CG - 1) / CG, B);
  dw7x7_kernel<T><<<grid, THREADS, Plan<T>::bytes(plan.th, plan.tw), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(out), H, W, C,
      plan.th, plan.tw, bands_w, vec);
  return cudaSuccess;
}

}  // namespace

cudaError_t launch_dw7x7(const void* x, const void* w, const void* b, void* out, int B, int H, int W, int C,
                         bool bf16, cudaStream_t stream) {
  return bf16 ? launch<__nv_bfloat16>(x, w, b, out, B, H, W, C, stream)
              : launch<float>(x, w, b, out, B, H, W, C, stream);
}
