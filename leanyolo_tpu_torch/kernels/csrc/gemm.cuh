// Block GEMM core shared by the matmul and s2dconv kernels: C = A x B with
// an fp32 accumulator, where a "problem" struct says where row r of A
// (possibly gathered, possibly zero), row k of B and the outputs live.
//
// A CTA computes a BM x BN output tile, stepping over K in tiles of 32. A
// and B tiles are staged in shared memory, STAGES buffers deep, with 16-byte
// cp.async copies (a copy of 0 source bytes zero-fills: halos and ragged
// edges cost no branch in the main loop) when the problem's rows and strides
// are 16-byte aligned, else with plain loads. bf16 runs on the tensor cores
// (ldmatrix + mma.sync m16n8k16, fp32 accumulate; 128x128 tiles of 8 warps,
// or 128x64 of 4 for narrow outputs, each warp 64x32); the TMA + wgmma
// GEMM is gemm_sm90.cuh. fp32 runs on the CUDA cores (64x64
// tiles, each thread 4x8 outputs) so that fp32 stays fp32. Outputs leave
// in runs of 8 columns through the problem's epilogue (`store8`), which
// rounds once (or at the folded conv's rounding points) and writes them
// with its own layout, 16 bytes at a time where it can.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

#include "common.cuh"

namespace gemm {

constexpr int BK = 32;

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, STAGES = STAGES_;
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
};
using BigTile = Tile<128, 128, 2, 4, 3>;   // bf16, N >= 128
using NarrowTile = Tile<128, 64, 2, 2, 3>; // bf16, N < 128
using F32Tile = Tile<64, 64, 2, 2, 2>;     // fp32 (MmaF32 assumes this shape)

template <typename T, class TL>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int LDA = BK + VEC, LDB = TL::BN + VEC;  // 16 bytes of row padding against bank conflicts
  static constexpr int A_CPR = BK / VEC, B_CPR = TL::BN / VEC;  // 16-byte chunks per tile row
  static constexpr int A_ITERS = TL::BM * A_CPR / TL::THREADS, B_ITERS = BK * B_CPR / TL::THREADS;
  static constexpr int A_STAGE = TL::BM * LDA, B_STAGE = BK * LDB;  // elements
  static constexpr int SMEM = (A_STAGE + B_STAGE) * TL::STAGES * int(sizeof(T));
  static_assert(A_ITERS * TL::THREADS == TL::BM * A_CPR && B_ITERS * TL::THREADS == BK * B_CPR, "tile split");
};

// 8 consecutive outputs, rounded to T, as one 16-byte store (bf16) or two (fp32).
__device__ __forceinline__ void store8v(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}
__device__ __forceinline__ void store8v(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Stages K tile `kt` of A (rows m0..) and B (columns n0..) into stage `s`.
// P supplies: Row row(int r), const T* a(const Row&, int k), const T* b(int
// k, int n) (nullptr = zero), and a valid base pointer any().
template <typename T, class TL, class P, bool VEC>
__device__ __forceinline__ void load_tile(const P& p, const typename P::Row (&rows)[Layout<T, TL>::A_ITERS],
                                          T* sa, T* sb, int s, int kt, int m0, int n0) {
  using L = Layout<T, TL>;
  const int tid = threadIdx.x, k0 = kt * BK;
  T* a = sa + s * L::A_STAGE;
  T* b = sb + s * L::B_STAGE;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < L::A_ITERS; ++i) {
      const int ci = tid + i * TL::THREADS, rr = ci / L::A_CPR, cc = (ci % L::A_CPR) * L::VEC;
      const T* src = p.a(rows[i], k0 + cc);
      cp_async16(a + rr * L::LDA + cc, src ? src : p.any(), src != nullptr);
    }
#pragma unroll
    for (int i = 0; i < L::B_ITERS; ++i) {
      const int ci = tid + i * TL::THREADS, kr = ci / L::B_CPR, nc = (ci % L::B_CPR) * L::VEC;
      const T* src = p.b(k0 + kr, n0 + nc);
      cp_async16(b + kr * L::LDB + nc, src ? src : p.any(), src != nullptr);
    }
  } else {
    for (int e = tid; e < TL::BM * BK; e += TL::THREADS) {
      const int rr = e / BK, kk = e % BK;
      const T* src = p.a(p.row(m0 + rr), k0 + kk);
      a[rr * L::LDA + kk] = src ? *src : Act<T>::from_float(0.f);
    }
    for (int e = tid; e < BK * TL::BN; e += TL::THREADS) {
      const int kr = e / TL::BN, nc = e % TL::BN;
      const T* src = p.b(k0 + kr, n0 + nc);
      b[kr * L::LDB + nc] = src ? *src : Act<T>::from_float(0.f);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
// d += a (16x16, row) x b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tensor-core path: warp w owns a (BM / WARPS_M) x (BN / WARPS_N)
// block, as FM x FN tiles of 16x8 (mma.sync m16n8k16). A fragments come
// from the row-major A tile, B fragments from the row-major [k][n] B tile
// transposed, both by ldmatrix; the 16 bytes of row padding keep the 8
// rows of each 8x8 load on distinct banks.
template <class TL>
struct MmaBf16 {
  using L = Layout<__nv_bfloat16, TL>;
  static constexpr int WM = TL::BM / TL::WARPS_M, WN = TL::BN / TL::WARPS_N, FM = WM / 16, FN = WN / 8;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile");
  float acc[FM][FN][4];

  __device__ int wm() const { return (threadIdx.x / 32) / TL::WARPS_N * WM; }
  __device__ int wn() const { return (threadIdx.x / 32) % TL::WARPS_N * WN; }

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  __device__ void step(const __nv_bfloat16* a, const __nv_bfloat16* b) {
    const int lane = threadIdx.x % 32, m = wm(), n = wn();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned fa[FM][4], fb[FN / 2][4];
#pragma unroll
      for (int i = 0; i < FM; ++i) ldsm_x4(fa[i], a + (m + i * 16 + lane % 16) * L::LDA + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < FN / 2; ++j)
        ldsm_x4_trans(fb[j], b + (kk + lane % 16) * L::LDB + n + j * 16 + (lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_16816(acc[i][j], fa[i], fb[j / 2][(j % 2) * 2], fb[j / 2][(j % 2) * 2 + 1]);
    }
  }
  // Each warp stages 16 rows x WN columns at a time in its own slice of
  // shared memory, then writes runs of 8 columns.
  template <class P>
  __device__ void store(const P& p, unsigned char* smem, int m0, int n0) {
    constexpr int LD = WN + 4;  // floats; rows 16-byte aligned
    constexpr int RUNS = 16 * WN / 8 / 32;  // runs of 8 per lane
    float* buf = reinterpret_cast<float*>(smem) + (threadIdx.x / 32) * 16 * LD;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < FM; ++i) {
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int r = lane / 4, c = j * 8 + (lane % 4) * 2;
        buf[r * LD + c] = acc[i][j][0];
        buf[r * LD + c + 1] = acc[i][j][1];
        buf[(r + 8) * LD + c] = acc[i][j][2];
        buf[(r + 8) * LD + c + 1] = acc[i][j][3];
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < RUNS; ++h) {
        const int run = lane + h * 32, row = run / (WN / 8), col = (run % (WN / 8)) * 8;
        const int r = m0 + wm() + i * 16 + row;
        if (r < p.rows) p.store8(p.orow(r), n0 + wn() + col, buf + row * LD + col);
      }
      __syncwarp();
    }
  }
};

// The fp32 path (F32Tile): thread t owns rows (t / 8) * 4 .. +3 and columns
// (t % 8) * 8 .. +7.
struct MmaF32 {
  using L = Layout<float, F32Tile>;
  float acc[4][8];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  __device__ void step(const float* a, const float* b) {
    const int r0 = (threadIdx.x / 8) * 4, c0 = (threadIdx.x % 8) * 8;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[(r0 + i) * L::LDA + k];
      const float4 b0 = *reinterpret_cast<const float4*>(b + k * L::LDB + c0);
      const float4 b1 = *reinterpret_cast<const float4*>(b + k * L::LDB + c0 + 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  template <class P>
  __device__ void store(const P& p, unsigned char*, int m0, int n0) {
    const int r0 = m0 + (threadIdx.x / 8) * 4, c0 = n0 + (threadIdx.x % 8) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + i < p.rows) p.store8(p.orow(r0 + i), c0, acc[i]);
  }
};

template <typename T, class TL>
struct MmaFor {
  using type = MmaBf16<TL>;
};
template <>
struct MmaFor<float, F32Tile> {
  using type = MmaF32;
};

// grid (ceil(rows / BM), ceil(N / BN)); block TL::THREADS; dynamic shared
// memory Layout<T, TL>::SMEM. P also supplies rows, K, ORow orow(int r) and
// store8(const ORow&, int n, const float* v) for columns n .. n+7.
template <typename T, class TL, class P, bool VEC>
__global__ void __launch_bounds__(TL::THREADS) gemm_kernel(const P p) {
  using L = Layout<T, TL>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + TL::STAGES * L::A_STAGE;
  const int m0 = blockIdx.x * TL::BM, n0 = blockIdx.y * TL::BN;

  typename P::Row rows[L::A_ITERS];
#pragma unroll
  for (int i = 0; i < L::A_ITERS; ++i) rows[i] = p.row(m0 + (threadIdx.x + i * TL::THREADS) / L::A_CPR);

  typename MmaFor<T, TL>::type mma;
  mma.zero();
  const int KT = (p.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < TL::STAGES - 1; ++s) {
    if (s < KT) load_tile<T, TL, P, VEC>(p, rows, sa, sb, s, s, m0, n0);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<TL::STAGES - 2>();  // tile kt has landed
    __syncthreads();                  // ... for every thread, and tile kt-1's slot is free
    const int next = kt + TL::STAGES - 1;
    if (next < KT) load_tile<T, TL, P, VEC>(p, rows, sa, sb, next % TL::STAGES, next, m0, n0);
    cp_async_commit();
    const int s = kt % TL::STAGES;
    mma.step(sa + s * L::A_STAGE, sb + s * L::B_STAGE);
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles are done with: the epilogue may stage in their memory
  mma.store(p, smem, m0, n0);
}

// Launches gemm_kernel on `grid`, raising the dynamic shared memory limit
// once per instantiation where the tile needs more than 48 KB.
template <typename T, class TL, class P, bool VEC>
cudaError_t launch(const P& p, dim3 grid, cudaStream_t stream) {
  constexpr int smem = Layout<T, TL>::SMEM;
  if constexpr (smem > 48 * 1024) {
    static const cudaError_t set = cudaFuncSetAttribute(gemm_kernel<T, TL, P, VEC>,
                                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return set;
  }
  gemm_kernel<T, TL, P, VEC><<<grid, TL::THREADS, smem, stream>>>(p);
  return cudaSuccess;
}

}  // namespace gemm
