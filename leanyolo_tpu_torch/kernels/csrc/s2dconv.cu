// Dense 3x3 stride-1 SAME conv, 32 -> 32 channels, + bias + SiLU, computed
// as the 2x2 VALID conv over the space-to-depth (S2D) form of the padded map.
//
// Replaces the Pallas kernels experiments/exp_pallas_k2.py:40 pallas_k2 and
// the bodies of experiments/exp_pallas_k2b.py:44 build (k_v0..k_v4): per
// image, out[I, J] = sum over 4 taps (di, dj) of xs[I+di, J+dj, :] @ w[tap],
// xs = s2d(pad(x, 1)) [H/2+1, W/2+1, 128], w [4, 128, 128], fp32 sum. The
// tap table is an argument (4 offsets in {0, 1}^2), so k_v1's all-(0, 0)
// table is the same kernel. On the serving path: yolov10s backbone
// c2.m[0].cv1 and .cv2, [B,160,160,32], two launches a request.
//
// Design: an implicit GEMM (gemm.cuh) with rows = S2D cells (B*H/2*W/2),
// K = 4 taps x 4 phases x 32 channels = 512, N = 4 phases x 32 = 128. Each
// K tile of 32 is one input pixel's 32 channels, so the kernel gathers the
// S2D cells straight from the NHWC map (a channel slice read in place): no
// pass materializes s2d(pad(x)) or un-S2Ds the output. The pad row and
// column, and a pixel past an odd edge, are zero-filled copies. The epilogue
// adds the bias and applies SiLU at the folded JAX forward's rounding points
// (common.cuh bias_silu) and writes each output phase to its pixel. All 16
// weight blocks of each tap are multiplied, the 7 that w_s2d_k3 leaves zero
// too, so any tap table and any weights give the function of the TPU kernel.
//
// Bound on an H100: bytes (at [32,160,160,32] bf16, 104.9 MB in and out
// against 26.8 GFLOP in the S2D form, 15.1 dense). One 128-wide column tile
// covers all N, so each x pixel is gathered by up to 4 cells, from L2 after
// the first read.
#include <type_traits>

#include "gemm.cuh"
#include "kernels.h"

namespace {

constexpr int C = 32;

template <typename T>
struct S2DProblem {
  const T* x;
  const T* w;
  const T* bias;
  T* out;
  int H, W, Ws, cells, rows, taps;
  long long sb, sp;
  static constexpr int K = 16 * C, N = 4 * C;

  struct Row {
    const T* img;  // nullptr past the last cell
    int y0, x0;    // input pixel of the cell's padded-grid corner
  };
  struct ORow {
    T* p;          // out at (b, 2I, 2J, 0)
    bool y1, x1;   // whether the odd phases lie inside the map
  };

  __device__ int di(int t) const { return (taps >> (2 * t)) & 1; }
  __device__ int dj(int t) const { return (taps >> (2 * t + 1)) & 1; }

  __device__ Row row(int r) const {
    if (r >= rows) return {nullptr, 0, 0};
    const int b = r / cells, c = r - b * cells, i = c / Ws, j = c - i * Ws;
    return {x + b * sb, 2 * i - 1, 2 * j - 1};
  }
  // A[cell, k], k = (tap * 4 + qi * 2 + qj) * 32 + ci: input pixel
  // (2 (I + di) + qi - 1, 2 (J + dj) + qj - 1), channel ci.
  __device__ const T* a(const Row& rw, int k) const {
    if (!rw.img) return nullptr;
    const int t = k >> 7, q = (k >> 5) & 3;
    const int y = rw.y0 + 2 * di(t) + (q >> 1), xx = rw.x0 + 2 * dj(t) + (q & 1);
    if (y < 0 || y >= H || xx < 0 || xx >= W) return nullptr;
    return rw.img + ((long long)y * W + xx) * sp + (k & (C - 1));
  }
  __device__ const T* b(int k, int n) const { return w + k * N + n; }
  __device__ const T* any() const { return x; }

  __device__ ORow orow(int r) const {
    const int b = r / cells, c = r - b * cells, i = c / Ws, j = c - i * Ws;
    return {out + (((long long)b * H + 2 * i) * W + 2 * j) * C, 2 * i + 1 < H, 2 * j + 1 < W};
  }
  // Output column n = (pi * 2 + pj) * 32 + co is pixel (2I + pi, 2J + pj);
  // columns n .. n+7 are 8 channels of one pixel.
  __device__ void store8(const ORow& o, int n, const float* v) const {
    const int pi = n >> 6, pj = (n >> 5) & 1, co = n & (C - 1);
    if ((pi && !o.y1) || (pj && !o.x1)) return;
    float y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = bias_silu<T>(v[j], Act<T>::to_float(bias[co + j]));
    gemm::store8v(o.p + ((long long)pi * W + pj) * C + co, y);
  }
};

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W, long long sb,
                   long long sp, int taps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (sp % V || sb % V || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;  // the wrapper hands over 16-byte aligned pixels
  const int hs = (H + 1) / 2, ws = (W + 1) / 2;
  S2DProblem<T> p{static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
                  static_cast<T*>(out), H, W, ws, hs * ws, B * hs * ws, taps, sb, sp};
  using TL = std::conditional_t<sizeof(T) == 4, gemm::F32Tile, gemm::BigTile>;
  const dim3 grid((p.rows + TL::BM - 1) / TL::BM, S2DProblem<T>::N / TL::BN);
  return gemm::launch<T, TL, S2DProblem<T>, true>(p, grid, stream);
}

}  // namespace

cudaError_t launch_s2dconv(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                           long long sb, long long sp, int taps, bool bf16, cudaStream_t stream) {
  return bf16 ? launch<__nv_bfloat16>(x, w, bias, out, B, H, W, sb, sp, taps, stream)
              : launch<float>(x, w, bias, out, B, H, W, sb, sp, taps, stream);
}
