// Matrix product out[R, N] = x[R, K] @ w[K, N], fp32 accumulator, rounded
// once to the activation type at the store. x rows are `lda` elements apart
// (a channel slice of an NHWC map is read in place); w and out are dense.
//
// Replaces the Pallas kernel experiments/exp_pallas_mm.py:40 pallas_mm
// ([B,M,K] x [K,N] per image, fp32 sum, output in x's dtype). On the serving
// path R = B*H*W: every dense 1x1 conv of the folded yolov10s, 45 a request.
// The TPU kernel holds one image's [M,K] block in VMEM per grid step; here
// the B*M rows are one GEMM cut into 128x128 output tiles (128x64 where
// N < 128), each CTA stepping over K (gemm.cuh), so small maps (M = 400 at
// 20x20) still fill the card.
//
// Bound on an H100: bytes, summed over the serving step's 1x1 shapes (2.57
// GB against 271.5 GFLOP at batch 32). The design reads each x tile once
// per 128 output columns (from L2 after the first) and writes each output
// once, 16 bytes at a time. No bias or SiLU here: the folded conv's
// epilogue runs after it, as pallas_mm leaves it outside.
#include "gemm.cuh"
#include "kernels.h"

namespace {

template <typename T>
struct MatmulProblem {
  const T* x;
  const T* w;
  T* out;
  int rows, K, N;
  long long lda;

  struct Row {
    const T* p;  // nullptr past the last row
  };
  bool vout;  // 16-byte output stores (N % 8 == 0)
  using ORow = int;

  __device__ Row row(int r) const { return {r < rows ? x + r * lda : nullptr}; }
  __device__ const T* a(const Row& rw, int k) const { return (rw.p && k < K) ? rw.p + k : nullptr; }
  __device__ const T* b(int k, int n) const { return (k < K && n < N) ? w + (long long)k * N + n : nullptr; }
  __device__ const T* any() const { return x; }
  __device__ ORow orow(int r) const { return r; }
  __device__ void store8(ORow r, int n, const float* v) const {
    T* o = out + (long long)r * N + n;
    if (vout && n + 8 <= N) {
      gemm::store8v(o, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (n + j < N) o[j] = Act<T>::from_float(v[j]);
    }
  }
};

template <typename T, class TL>
cudaError_t launch_tile(const MatmulProblem<T>& p, bool vec, cudaStream_t stream) {
  const dim3 grid((p.rows + TL::BM - 1) / TL::BM, (p.N + TL::BN - 1) / TL::BN);
  return vec ? gemm::launch<T, TL, MatmulProblem<T>, true>(p, grid, stream)
             : gemm::launch<T, TL, MatmulProblem<T>, false>(p, grid, stream);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int K, int N, long long lda,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const MatmulProblem<T> p{static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), rows, K, N, lda,
                           N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0};
  // 16-byte copies need every row start of x and w on a 16-byte boundary.
  const bool vec = K % V == 0 && N % V == 0 && lda % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if constexpr (sizeof(T) == 4)
    return launch_tile<T, gemm::F32Tile>(p, vec, stream);
  else
    return N >= 128 ? launch_tile<T, gemm::BigTile>(p, vec, stream) : launch_tile<T, gemm::NarrowTile>(p, vec, stream);
}

}  // namespace

cudaError_t launch_bmm(const void* x, const void* w, void* out, int rows, int K, int N, long long lda, bool bf16,
                       cudaStream_t stream) {
  return bf16 ? launch<__nv_bfloat16>(x, w, out, rows, K, N, lda, stream)
              : launch<float>(x, w, out, rows, K, N, lda, stream);
}
