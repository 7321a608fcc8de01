// Fused stem: conv0 3x3 s2 + bias + SiLU, then conv1 3x3 s2 + bias + SiLU,
// on raw NHWC images, with the input normalization folded into conv0.
//
// Replaces the Pallas kernels experiments/stem_pallas.py:254 fused_stem and
// :204 fused_stem_v2 (one function in two TPU layouts). Neither layout is
// carried over: no space-to-depth block weights, no row-strip tiling.
//
// Design: one CTA of 256 threads per 8x8 tile of conv1 outputs, all c1
// channels. The CTA stages its 35x35x3 input patch (zero outside the image)
// and both convs' weights in shared memory, computes the 17x17xc0 conv0
// activations it needs into shared memory, rounded to the activation type
// as the JAX forward rounds them, and from there the 8x8xc1 outputs. The
// conv0 activations never go to device memory; the halo rows and columns
// are recomputed by neighbouring CTAs (13% more conv0 work).
//
// Bound on an H100: bytes at yolov10s 640 (raw uint8 in, bf16 stride-4
// features out, ~144 MB at batch 32) against ~36 GFLOP, which the tensor
// cores could do in less time than the bytes take. This first version uses
// scalar fp32 FMAs from shared memory: per thread 2 output channels x 8
// pixels, so each bf16x2 load of activations feeds 4 FMAs and the weights
// are read as channel pairs, conflict-free. wgmma and TMA are later work.
#include "common.cuh"
#include "kernels.h"

namespace {

constexpr int TO = 8;           // conv1 outputs per tile side
constexpr int T0 = 2 * TO + 1;  // conv0 activations per tile side
constexpr int TI = 2 * T0 + 1;  // input pixels per tile side
constexpr int NTHREADS = 256;

constexpr int align16(int b) { return (b + 15) / 16 * 16; }

template <int C0, int C1, typename T>
struct Smem {  // byte offsets into dynamic shared memory
  static constexpr int xs = 0;                                              // float [TI][TI][3]
  static constexpr int w0 = align16(xs + TI * TI * 3 * 4);                  // float [3][3][3][C0]
  static constexpr int b0 = w0 + 27 * C0 * 4;                               // float [C0]
  static constexpr int b1 = b0 + C0 * 4;                                    // float [C1]
  static constexpr int act = align16(b1 + C1 * 4);                          // T [T0][T0][C0]
  static constexpr int w1 = align16(act + T0 * T0 * C0 * (int)sizeof(T));   // T [3][3][C0][C1]
  static constexpr int total = align16(w1 + 9 * C0 * C1 * (int)sizeof(T));
};

template <int C0, int C1, typename T, typename Tin>
__global__ void __launch_bounds__(NTHREADS)
stem_kernel(const Tin* __restrict__ x, const T* __restrict__ w0, const T* __restrict__ b0,
            const T* __restrict__ w1, const T* __restrict__ b1, T* __restrict__ out, int H, int W) {
  static_assert(C0 % 2 == 0 && C1 % 2 == 0, "channel pairs");
  using S = Smem<C0, C1, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + S::xs);
  float* w0s = reinterpret_cast<float*>(smem + S::w0);
  float* b0s = reinterpret_cast<float*>(smem + S::b0);
  float* b1s = reinterpret_cast<float*>(smem + S::b1);
  T* act = reinterpret_cast<T*>(smem + S::act);
  T* w1s = reinterpret_cast<T*>(smem + S::w1);

  const int tid = threadIdx.x;
  const int ox0 = blockIdx.x * TO, oy0 = blockIdx.y * TO, b = blockIdx.z;
  const int H1 = H / 4, W1 = W / 4;

  for (int i = tid; i < 27 * C0; i += NTHREADS) w0s[i] = Act<T>::to_float(w0[i]);
  for (int i = tid; i < C0; i += NTHREADS) b0s[i] = Act<T>::to_float(b0[i]);
  for (int i = tid; i < C1; i += NTHREADS) b1s[i] = Act<T>::to_float(b1[i]);
  for (int i = tid; i < 9 * C0 * C1; i += NTHREADS) w1s[i] = w1[i];

  // Input patch: conv0 row r of the tile (global 2*oy0-1+r) reads input rows
  // 2r..2r+2 of the patch, whose row 0 is global row 4*oy0-3.
  const int gy0 = 4 * oy0 - 3, gx0 = 4 * ox0 - 3;
  for (int i = tid; i < TI * TI * 3; i += NTHREADS) {
    const int c = i % 3, p = i / 3, ix = p % TI, iy = p / TI;
    const int gy = gy0 + iy, gx = gx0 + ix;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = in_to_float(x[((size_t(b) * H + gy) * W + gx) * 3 + c]);
    xs[i] = v;
  }
  __syncthreads();

  // conv0: a warp per activation pixel, a lane per channel. The input reads
  // are broadcasts; the weight reads are consecutive.
  const int warp = tid / 32, lane = tid % 32;
  for (int p = warp; p < T0 * T0; p += NTHREADS / 32) {
    const int r = p / T0, c = p % T0;
    // Row/column -1 is conv1's zero padding (the tile never reaches H/2, W/2).
    const bool pad = (2 * oy0 - 1 + r) < 0 || (2 * ox0 - 1 + c) < 0;
    for (int co = lane; co < C0; co += 32) {
      float acc = 0.f;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci)
            acc = fmaf(xs[((2 * r + kh) * TI + 2 * c + kw) * 3 + ci], w0s[((kh * 3 + kw) * 3 + ci) * C0 + co], acc);
      act[p * C0 + co] = Act<T>::from_float(pad ? 0.f : bias_silu<T>(acc, b0s[co]));
    }
  }
  __syncthreads();

  // conv1: an item is (channel pair, output row): 8 pixels x 2 channels.
  constexpr int NP = C1 / 2;
  for (int item = tid; item < NP * TO; item += NTHREADS) {
    const int co = 2 * (item % NP), ty = item / NP;
    float acc0[TO], acc1[TO];
#pragma unroll
    for (int tx = 0; tx < TO; ++tx) acc0[tx] = acc1[tx] = 0.f;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const T* arow = act + ((2 * ty + kh) * T0 + kw) * C0;  // activation (2ty+kh, 2tx+kw)
        const T* wt = w1s + (kh * 3 + kw) * C0 * C1 + co;
#pragma unroll 4
        for (int ci = 0; ci < C0; ci += 2) {
          const float2 wa = Act<T>::load2(wt + ci * C1);
          const float2 wb = Act<T>::load2(wt + (ci + 1) * C1);
#pragma unroll
          for (int tx = 0; tx < TO; ++tx) {
            const float2 a = Act<T>::load2(arow + 2 * tx * C0 + ci);
            acc0[tx] = fmaf(a.y, wb.x, fmaf(a.x, wa.x, acc0[tx]));
            acc1[tx] = fmaf(a.y, wb.y, fmaf(a.x, wa.y, acc1[tx]));
          }
        }
      }
    }
    T* orow = out + ((size_t(b) * H1 + oy0 + ty) * W1 + ox0) * C1 + co;
#pragma unroll
    for (int tx = 0; tx < TO; ++tx)
      Act<T>::store2(orow + tx * C1, bias_silu<T>(acc0[tx], b1s[co]), bias_silu<T>(acc1[tx], b1s[co + 1]));
  }
}

template <int C0, int C1, typename T, typename Tin>
cudaError_t launch(const void* x, const void* w0, const void* b0, const void* w1, const void* b1, void* out,
                   int B, int H, int W, cudaStream_t stream) {
  constexpr int smem = Smem<C0, C1, T>::total;
  auto kernel = stem_kernel<C0, C1, T, Tin>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(W / 4 / TO, H / 4 / TO, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(static_cast<const Tin*>(x), static_cast<const T*>(w0),
                                           static_cast<const T*>(b0), static_cast<const T*>(w1),
                                           static_cast<const T*>(b1), static_cast<T*>(out), H, W);
  return cudaSuccess;
}

template <int C0, int C1, typename T>
cudaError_t launch_in(const void* x, bool x_u8, const void* w0, const void* b0, const void* w1, const void* b1,
                      void* out, int B, int H, int W, cudaStream_t stream) {
  return x_u8 ? launch<C0, C1, T, uint8_t>(x, w0, b0, w1, b1, out, B, H, W, stream)
              : launch<C0, C1, T, T>(x, w0, b0, w1, b1, out, B, H, W, stream);
}

template <typename T>
cudaError_t launch_widths(const void* x, bool x_u8, const void* w0, const void* b0, const void* w1,
                          const void* b1, void* out, int B, int H, int W, int c0, int c1, cudaStream_t stream) {
  if (c0 == 32 && c1 == 64) return launch_in<32, 64, T>(x, x_u8, w0, b0, w1, b1, out, B, H, W, stream);
  if (c0 == 16 && c1 == 32) return launch_in<16, 32, T>(x, x_u8, w0, b0, w1, b1, out, B, H, W, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t launch_stem(const void* x, bool x_u8, const void* w0, const void* b0, const void* w1,
                        const void* b1, void* out, int B, int H, int W, int c0, int c1, bool bf16,
                        cudaStream_t stream) {
  if (H % 32 || W % 32) return cudaErrorInvalidValue;
  return bf16 ? launch_widths<__nv_bfloat16>(x, x_u8, w0, b0, w1, b1, out, B, H, W, c0, c1, stream)
              : launch_widths<float>(x, x_u8, w0, b0, w1, b1, out, B, H, W, c0, c1, stream);
}
