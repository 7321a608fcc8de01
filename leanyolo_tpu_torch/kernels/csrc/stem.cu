// Fused stem: conv0 3x3 s2 + bias + SiLU, then conv1 3x3 s2 + bias + SiLU,
// on raw NHWC images, with the input normalization folded into conv0.
//
// Replaces the Pallas kernels experiments/stem_pallas.py:254 fused_stem and
// :204 fused_stem_v2 (one function in two TPU layouts). Neither layout is
// carried over: no space-to-depth block weights, no row-strip tiling. What
// is kept is what the Pallas kernel keeps out of device memory: the conv0
// activations never leave the SM.
//
// Two routes, chosen by the activation type in the wrapper (kernels/stem.py),
// each compiled for every (c0, c1) of STEM_WIDTHS (kernels.h), the widths of
// the six YOLOv10 sizes:
// - bf16, the tensor-core route (stem_tc.cu; every call of the serving
//   path);
// - fp32 (this file, stem_kernel): one CTA of 256 threads per 8x8 tile of
//   conv1 outputs, scalar fp32 FMAs (the first port's kernel), so that fp32
//   stays fp32. Input patch, conv0's weights and its activations sit in
//   shared memory; conv1's weights too where they fit beside them (yolov10n
//   and s), else they are read from device memory through the read-only
//   cache (m/b/l/x: 9 c0 c1 fp32 values are 166-450 KB), each warp reading
//   a tap's output channels contiguously.
//
// Bound (both routes) on an H100: bytes, the uint8 images in and the
// [B,H/4,W/4,c1] outputs out (chip_smoke.py prints it per width).
#include "common.cuh"
#include "kernels.h"

namespace {

constexpr int TO = 8;           // conv1 outputs per tile side
constexpr int T0 = 2 * TO + 1;  // conv0 activations per tile side
constexpr int TI = 2 * T0 + 1;  // input pixels per tile side
constexpr int NTHREADS = 256;
constexpr int SMEM_LIMIT = 227 * 1024;  // dynamic shared memory a CTA can have

constexpr int align16(int b) { return (b + 15) / 16 * 16; }

template <int C0, int C1>
struct Smem {  // byte offsets into dynamic shared memory
  static constexpr int xs = 0;                                  // float [TI][TI][3]
  static constexpr int w0 = align16(xs + TI * TI * 3 * 4);      // float [3][3][3][C0]
  static constexpr int b0 = w0 + 27 * C0 * 4;                   // float [C0]
  static constexpr int b1 = b0 + C0 * 4;                        // float [C1]
  static constexpr int act = align16(b1 + C1 * 4);              // float [T0][T0][C0]
  static constexpr int w1 = align16(act + T0 * T0 * C0 * 4);    // float [3][3][C0][C1], where it fits
  static constexpr bool W1_SMEM = w1 + 9 * C0 * C1 * 4 <= SMEM_LIMIT;
  static constexpr int total = align16(w1 + (W1_SMEM ? 9 * C0 * C1 * 4 : 0));
};

template <bool SMEM>
__device__ __forceinline__ float2 weight_pair(const float* p) {
  if constexpr (SMEM)
    return *reinterpret_cast<const float2*>(p);
  else
    return __ldg(reinterpret_cast<const float2*>(p));
}

template <int C0, int C1, typename Tin>
__global__ void __launch_bounds__(NTHREADS)
stem_kernel(const Tin* __restrict__ x, const float* __restrict__ w0, const float* __restrict__ b0,
            const float* __restrict__ w1, const float* __restrict__ b1, float* __restrict__ out, int H, int W) {
  static_assert(C0 % 2 == 0 && C1 % 2 == 0, "channel pairs");
  using S = Smem<C0, C1>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + S::xs);
  float* w0s = reinterpret_cast<float*>(smem + S::w0);
  float* b0s = reinterpret_cast<float*>(smem + S::b0);
  float* b1s = reinterpret_cast<float*>(smem + S::b1);
  float* act = reinterpret_cast<float*>(smem + S::act);
  const float* w1s = S::W1_SMEM ? reinterpret_cast<const float*>(smem + S::w1) : w1;

  const int tid = threadIdx.x;
  const int ox0 = blockIdx.x * TO, oy0 = blockIdx.y * TO, b = blockIdx.z;
  const int H1 = H / 4, W1 = W / 4;

  for (int i = tid; i < 27 * C0; i += NTHREADS) w0s[i] = w0[i];
  for (int i = tid; i < C0; i += NTHREADS) b0s[i] = b0[i];
  for (int i = tid; i < C1; i += NTHREADS) b1s[i] = b1[i];
  if constexpr (S::W1_SMEM)
    for (int i = tid; i < 9 * C0 * C1; i += NTHREADS) reinterpret_cast<float*>(smem + S::w1)[i] = w1[i];

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
      act[p * C0 + co] = pad ? 0.f : bias_silu<float>(acc, b0s[co]);
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
        const float* arow = act + ((2 * ty + kh) * T0 + kw) * C0;  // activation (2ty+kh, 2tx+kw)
        const float* wt = w1s + (kh * 3 + kw) * C0 * C1 + co;
#pragma unroll 4
        for (int ci = 0; ci < C0; ci += 2) {
          const float2 wa = weight_pair<S::W1_SMEM>(wt + ci * C1);
          const float2 wb = weight_pair<S::W1_SMEM>(wt + (ci + 1) * C1);
#pragma unroll
          for (int tx = 0; tx < TO; ++tx) {
            const float2 a = Act<float>::load2(arow + 2 * tx * C0 + ci);
            acc0[tx] = fmaf(a.y, wb.x, fmaf(a.x, wa.x, acc0[tx]));
            acc1[tx] = fmaf(a.y, wb.y, fmaf(a.x, wa.y, acc1[tx]));
          }
        }
      }
    }
    float* orow = out + ((size_t(b) * H1 + oy0 + ty) * W1 + ox0) * C1 + co;
#pragma unroll
    for (int tx = 0; tx < TO; ++tx)
      Act<float>::store2(orow + tx * C1, bias_silu<float>(acc0[tx], b1s[co]), bias_silu<float>(acc1[tx], b1s[co + 1]));
  }
}

template <int C0, int C1, typename Tin>
cudaError_t launch_f32(const void* x, const void* w0, const void* b0, const void* w1, const void* b1, void* out,
                       int B, int H, int W, cudaStream_t stream) {
  constexpr int smem = Smem<C0, C1>::total;
  auto kernel = stem_kernel<C0, C1, Tin>;
  static const cudaError_t set = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid(W / 4 / TO, H / 4 / TO, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(static_cast<const Tin*>(x), static_cast<const float*>(w0),
                                           static_cast<const float*>(b0), static_cast<const float*>(w1),
                                           static_cast<const float*>(b1), static_cast<float*>(out), H, W);
  return cudaSuccess;
}

template <int C0, int C1>
cudaError_t launch_f32_in(const void* x, bool x_u8, const void* w0, const void* b0, const void* w1, const void* b1,
                          void* out, int B, int H, int W, cudaStream_t stream) {
  return x_u8 ? launch_f32<C0, C1, uint8_t>(x, w0, b0, w1, b1, out, B, H, W, stream)
              : launch_f32<C0, C1, float>(x, w0, b0, w1, b1, out, B, H, W, stream);
}

}  // namespace

cudaError_t launch_stem(const void* x, bool x_u8, const void* w0, const void* b0, const void* w1,
                        const void* b1, void* out, int B, int H, int W, int c0, int c1, cudaStream_t stream) {
  if (H % 32 || W % 32) return cudaErrorInvalidValue;
#define STEM_F32(C0, C1) \
  if (c0 == C0 && c1 == C1) return launch_f32_in<C0, C1>(x, x_u8, w0, b0, w1, b1, out, B, H, W, stream);
  STEM_WIDTHS(STEM_F32)
#undef STEM_F32
  return cudaErrorInvalidValue;
}
