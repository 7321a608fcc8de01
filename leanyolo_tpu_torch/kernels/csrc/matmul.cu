// Matrix product out[R, N] = x[R, K] @ w[K, N], fp32 accumulator, then the
// folded conv's epilogue: the sum rounded to the activation type, + bias
// rounded, SiLU rounded (each of bias and SiLU optional). x rows are `lda`
// elements apart (a channel slice of an NHWC map is read in place); out is
// dense.
//
// Replaces the Pallas kernel experiments/exp_pallas_mm.py:40 pallas_mm
// ([B,M,K] x [K,N] per image, fp32 sum, output in x's dtype), with the
// bias and SiLU that pallas_mm leaves outside fused in. On the serving path
// R = B*H*W: every dense 1x1 conv of the folded yolov10s, 45 a request.
// The TPU kernel holds one image's [M,K] block in VMEM per grid step; here
// the B*M rows are one GEMM, so small maps (M = 400 at 20x20) still fill
// the card.
//
// Two routes, chosen by shape in the wrapper (kernels/matmul.py):
// - wgmma (gemm_sm90.cuh): bf16 with K, N, lda and ldb multiples of 8 and
//   16-byte aligned x and w; w K-major ([N, K] rows `ldb` apart); the tile
//   width and the number of consumer pairs come from the wrapper. TMA
//   descriptors are encoded here per call, through cuTensorMapEncodeTiled
//   reached with cudaGetDriverEntryPoint (nothing extra is linked). Every
//   call of the serving path takes it.
// - mma.sync (gemm.cuh): fp32 (CUDA cores), and bf16 shapes TMA cannot
//   describe; w row-major [K, N].
//
// Bound on an H100: bytes, summed over the serving step's 1x1 shapes
// (arithmetic intensity 32-332 against the card's ~295 operations per
// byte). Each x row is read from device memory once where one column tile
// covers N (N <= 128; wider outputs reread x from L2), and the fused
// epilogue writes each output once in place of up to three elementwise
// passes over it.
#include <cuda.h>

#include "gemm.cuh"
#include "gemm_sm90.cuh"
#include "kernels.h"

namespace {

template <typename T>
struct MatmulProblem {
  const T* x;
  const T* w;
  const T* bias;  // nullptr: no bias
  T* out;
  int rows, K, N;
  long long lda;
  bool act;

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
    float y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      y[j] = conv_epilogue<T>(v[j], (bias && n + j < N) ? Act<T>::to_float(bias[n + j]) : 0.f, bias != nullptr, act);
    T* o = out + (long long)r * N + n;
    if (vout && n + 8 <= N) {
      gemm::store8v(o, y);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (n + j < N) o[j] = Act<T>::from_float(y[j]);
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
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int rows, int K, int N, long long lda,
                   bool act, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const MatmulProblem<T> p{static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
                           static_cast<T*>(out), rows, K, N, lda, act,
                           N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0};
  // 16-byte copies need every row start of x and w on a 16-byte boundary.
  const bool vec = K % V == 0 && N % V == 0 && lda % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if constexpr (sizeof(T) == 4)
    return launch_tile<T, gemm::F32Tile>(p, vec, stream);
  else
    return N >= 128 ? launch_tile<T, gemm::BigTile>(p, vec, stream) : launch_tile<T, gemm::NarrowTile>(p, vec, stream);
}

// --- the wgmma route ---

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess) p = nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 2D bf16 map of `outer` rows of `inner` elements, rows `stride` elements
// apart, read or written in boxes of box_inner x box_outer, 128B-swizzled.
bool make_map(CUtensorMap* map, const void* ptr, long long inner, long long outer, long long stride, int box_inner,
              int box_outer) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(inner), cuuint64_t(outer)};
  const cuuint64_t strides[1] = {cuuint64_t(stride) * 2};
  const cuuint32_t box[2] = {cuuint32_t(box_inner), cuuint32_t(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int EPI, int PAIRS>
cudaError_t launch_tiles(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tc, const void* bias,
                         int rows, int K, int N, cudaStream_t stream) {
  using Cfg = sm90::Config<BN, PAIRS>;
  static const cudaError_t set = cudaFuncSetAttribute(sm90::gemm_kernel<BN, EPI, PAIRS>,
                                                      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (set != cudaSuccess) return set;
  const int tiles = (rows + sm90::BM - 1) / sm90::BM * ((N + BN - 1) / BN);
  const int grid = tiles < sm90::sm_count() ? tiles : sm90::sm_count();
  sm90::gemm_kernel<BN, EPI, PAIRS><<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(
      ta, tb, tc, static_cast<const __nv_bfloat16*>(bias), rows, K, N);
  return cudaSuccess;
}

template <int BN, int PAIRS>
cudaError_t launch_sm90(const void* x, const void* w, long long ldb, const void* bias, void* out, int rows, int K,
                        int N, long long lda, bool act, cudaStream_t stream) {
  CUtensorMap ta, tb, tc;
  if (!make_map(&ta, x, K, rows, lda, sm90::BK, sm90::BM) || !make_map(&tb, w, K, N, ldb, sm90::BK, BN) ||
      !make_map(&tc, out, N, rows, N, 64, 64))
    return cudaErrorInvalidValue;
  if (bias == nullptr) return launch_tiles<BN, sm90::PLAIN, PAIRS>(ta, tb, tc, bias, rows, K, N, stream);
  return act ? launch_tiles<BN, sm90::BIAS_SILU, PAIRS>(ta, tb, tc, bias, rows, K, N, stream)
             : launch_tiles<BN, sm90::BIAS, PAIRS>(ta, tb, tc, bias, rows, K, N, stream);
}

template <int BN>
cudaError_t launch_sm90(const void* x, const void* w, long long ldb, const void* bias, void* out, int rows, int K,
                        int N, long long lda, bool act, int pairs, cudaStream_t stream) {
  switch (pairs) {
    case 1: return launch_sm90<BN, 1>(x, w, ldb, bias, out, rows, K, N, lda, act, stream);
    case 2: return launch_sm90<BN, 2>(x, w, ldb, bias, out, rows, K, N, lda, act, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_bmm(const void* x, const void* w, const void* bias, void* out, int rows, int K, int N,
                       long long lda, bool act, bool bf16, cudaStream_t stream) {
  return bf16 ? launch<__nv_bfloat16>(x, w, bias, out, rows, K, N, lda, act, stream)
              : launch<float>(x, w, bias, out, rows, K, N, lda, act, stream);
}

cudaError_t launch_bmm_wgmma(const void* x, const void* w, long long ldb, const void* bias, void* out, int rows,
                             int K, int N, long long lda, bool act, int bn, int pairs, cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (K % 8 || N % 8 || lda % 8 || ldb % 8 || misaligned(x) || misaligned(w) || misaligned(out) ||
      (bias && reinterpret_cast<uintptr_t>(bias) % 4) || (act && bias == nullptr))
    return cudaErrorInvalidValue;  // SiLU comes with a bias (the wrapper passes zeros)
  switch (bn) {
    case 64: return launch_sm90<64>(x, w, ldb, bias, out, rows, K, N, lda, act, pairs, stream);
    case 80: return N <= 80 ? launch_sm90<80>(x, w, ldb, bias, out, rows, K, N, lda, act, pairs, stream)
                            : cudaErrorInvalidValue;  // a 64-wide store box would cross into the next tile
    case 128: return launch_sm90<128>(x, w, ldb, bias, out, rows, K, N, lda, act, pairs, stream);
    default: return cudaErrorInvalidValue;
  }
}
