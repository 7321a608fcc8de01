// Depthwise 7x7 conv, pad 3, stride 1, + bias + SiLU, NHWC, any B, H, W, C.
//
// Replaces the Pallas kernel experiments/exp_dw_pallas.py:75 dw_pallas (the
// folded RepVGGDW of yolov10s's backbone c8 and neck p4_p5, [B,20,20,512]
// on the serving path), without its hard-coded 20x20x512 shape.
//
// Design: one CTA of 256 threads per (8x8 output tile, 32 channels, image).
// The CTA stages the 14x14x32 input patch (zero outside the image) in shared
// memory as fp32; a lane owns one channel, holds its 49 taps and bias in
// registers, and a warp owns one output row of the tile. For each kernel
// row a thread reads 14 patch values once and feeds them to 8 outputs x 7
// taps, so shared-memory reads are 1/4 of the FMAs, all conflict-free (a
// warp reads 32 consecutive channels). fp32 accumulation; the epilogue
// rounds as the folded JAX forward does.
//
// Bound on an H100: bytes (at [32,20,20,512] bf16, 26 MB in and out against
// 0.64 GFLOP). Partial tiles (20 = 8 + 8 + 4) leave 44% of the lanes idle
// on the last tile row and column; larger tiles are later work.
#include "common.cuh"
#include "kernels.h"

namespace {

constexpr int K = 7, PAD = 3;
constexpr int TH = 8, TW = 8, CB = 32;
constexpr int SH = TH + K - 1, SW = TW + K - 1;

template <typename T>
__global__ void __launch_bounds__(TH * CB)
dw7x7_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias, T* __restrict__ out,
             int H, int W, int C, int tiles_w) {
  __shared__ float s[SH * SW * CB];
  const int lane = threadIdx.x % CB, ty = threadIdx.x / CB;
  const int ox0 = (blockIdx.x % tiles_w) * TW, oy0 = (blockIdx.x / tiles_w) * TH;
  const int c = blockIdx.y * CB + lane, b = blockIdx.z;
  const bool cok = c < C;

  for (int p = ty; p < SH * SW; p += TH) {
    const int gy = oy0 - PAD + p / SW, gx = ox0 - PAD + p % SW;
    float v = 0.f;
    if (cok && gy >= 0 && gy < H && gx >= 0 && gx < W) v = Act<T>::to_float(x[((size_t(b) * H + gy) * W + gx) * C + c]);
    s[p * CB + lane] = v;
  }
  float wr[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wr[t] = cok ? Act<T>::to_float(w[t * C + c]) : 0.f;
  const float bi = cok ? Act<T>::to_float(bias[c]) : 0.f;
  __syncthreads();

  float acc[TW];
#pragma unroll
  for (int tx = 0; tx < TW; ++tx) acc[tx] = 0.f;
#pragma unroll
  for (int kh = 0; kh < K; ++kh) {
    float row[SW];
#pragma unroll
    for (int j = 0; j < SW; ++j) row[j] = s[((ty + kh) * SW + j) * CB + lane];
#pragma unroll
    for (int tx = 0; tx < TW; ++tx)
#pragma unroll
      for (int kw = 0; kw < K; ++kw) acc[tx] = fmaf(row[tx + kw], wr[kh * K + kw], acc[tx]);
  }

  const int oy = oy0 + ty;
  if (!cok || oy >= H) return;
#pragma unroll
  for (int tx = 0; tx < TW; ++tx) {
    const int ox = ox0 + tx;
    if (ox < W) out[((size_t(b) * H + oy) * W + ox) * C + c] = Act<T>::from_float(bias_silu<T>(acc[tx], bi));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* out, int B, int H, int W, int C,
                   cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, (C + CB - 1) / CB, B);
  dw7x7_kernel<T><<<grid, TH * CB, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                static_cast<const T*>(b), static_cast<T*>(out), H, W, C, tiles_w);
  return cudaSuccess;
}

}  // namespace

cudaError_t launch_dw7x7(const void* x, const void* w, const void* b, void* out, int B, int H, int W, int C,
                         bool bf16, cudaStream_t stream) {
  return bf16 ? launch<__nv_bfloat16>(x, w, b, out, B, H, W, C, stream)
              : launch<float>(x, w, b, out, B, H, W, C, stream);
}
