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
// Both routes are an implicit GEMM with rows = S2D cells (B*H/2*W/2),
// K = 4 taps x 4 phases x 32 channels = 512, N = 4 phases x 32 = 128,
// gathered straight from the NHWC map (a channel slice read in place): no
// pass materializes s2d(pad(x)) or un-S2Ds the output. The pad row and
// column, and a pixel past an odd edge, are zero-filled copies. All 16
// weight blocks of each tap are multiplied, the 7 that w_s2d_k3 leaves zero
// too, so any tap table and any weights give the function of the TPU kernel.
// The epilogue adds the bias and applies SiLU at the folded JAX forward's
// rounding points and writes each output phase to its pixel.
//
// Bound on an H100: bytes (at [32,160,160,32] bf16, 104.9 MB in and out:
// 0.031 ms, against 26.8 GFLOP in the S2D form, 0.027 ms, 15.1 dense), and
// the SiLU's special-function floor: 26.2 M SiLUs, two operations each at
// 16 a clock per SM: ~0.013 ms. Each x pixel is gathered by 4 cells (one
// per tap), so 210 MB cross L2 to the SMs.
//
// bf16, the wgmma route (s2d_wgmma_kernel; every call of the serving path):
// - Persistent CTAs, one per SM. The [4,128,128] weights, packed once
//   K-major ([128 N, 512 K], kernels/s2dconv.py pack_weights), are copied
//   once per CTA into shared memory (128 KB) in wgmma's 128B-swizzled
//   K-major layout, and stay there.
// - A producer warpgroup fills rings of A stages, 64 cells x 64 K each:
//   for one tap and one row phase qi, the two column phases qj are adjacent
//   pixels, 2 x 64 bytes, copied with 16-byte cp.async into the swizzled
//   layout; each thread's copies arrive on the stage's mbarrier
//   (cp.async.mbarrier.arrive.noinc).
// - Two consumer warpgroups take alternate tiles of 64 cells, each from a
//   ring of its own, so that one's epilogue overlaps the other's products:
//   wgmma m64n128k16 (fp32 accumulate), 8 stages a tile; a stage is freed
//   through its "empty" mbarrier.
// - Epilogue: gemm_sm90.cuh's rounding points and fast SiLU (bias_silu2),
//   written from the registers, 16 bytes of a pixel by 4 lanes (staging
//   the tile in shared memory for 16-byte stores measured slower). The
//   kernel is held by the gather's latency more than by its products or
//   its epilogue: fewer ring stages made it slower, and cutting out the
//   products barely made it faster (PERF.md section 6).
//
// fp32 (gemm.cuh, CUDA cores): 64x64 tiles, K in steps of 32 = one input
// pixel's 32 channels, the exact SiLU, so that fp32 stays fp32.
#include "gemm.cuh"
#include "gemm_sm90.cuh"
#include "kernels.h"

namespace {

constexpr int C = 32;

// ------------------------------------------------------------ fp32 route

struct S2DProblem {
  const float* x;
  const float* w;
  const float* bias;
  float* out;
  int H, W, Ws, cells, rows, taps;
  long long sb, sp;
  static constexpr int K = 16 * C, N = 4 * C;

  struct Row {
    const float* img;  // nullptr past the last cell
    int y0, x0;        // input pixel of the cell's padded-grid corner
  };
  struct ORow {
    float* p;          // out at (b, 2I, 2J, 0)
    bool y1, x1;       // whether the odd phases lie inside the map
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
  __device__ const float* a(const Row& rw, int k) const {
    if (!rw.img) return nullptr;
    const int t = k >> 7, q = (k >> 5) & 3;
    const int y = rw.y0 + 2 * di(t) + (q >> 1), xx = rw.x0 + 2 * dj(t) + (q & 1);
    if (y < 0 || y >= H || xx < 0 || xx >= W) return nullptr;
    return rw.img + ((long long)y * W + xx) * sp + (k & (C - 1));
  }
  __device__ const float* b(int k, int n) const { return w + k * N + n; }
  __device__ const float* any() const { return x; }

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
    for (int j = 0; j < 8; ++j) y[j] = bias_silu<float>(v[j], bias[co + j]);
    gemm::store8v(o.p + ((long long)pi * W + pj) * C + co, y);
  }
};

// ------------------------------------------------------------ wgmma route

namespace wg {

constexpr int BM = 64, KB = 8;                  // cells a tile; K blocks of 64 (tap, qi)
constexpr int RING = 4;                         // stages of each consumer's ring
constexpr int THREADS = 3 * 128;                // producer warpgroup + 2 consumer warpgroups
constexpr int W_BYTES = KB * 128 * 128;         // 8 blocks of [128 n][64 k] bf16
constexpr int A_BYTES = BM * 128;               // one stage: 64 cells x 64 k
constexpr int SMEM = 1024 + W_BYTES + 2 * RING * A_BYTES + 256;
static_assert(SMEM <= sm90::SMEM_LIMIT && 2 * 2 * RING * 8 <= 256, "shared memory plan");

// 16-byte chunk c of a 128-byte row r lands at chunk c ^ (r % 8): the
// layout TMA's 128B swizzle writes and wgmma's descriptors read.
__device__ __forceinline__ uint32_t swz128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void cp_async16_u32(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Consumer warpgroup h takes the CTA's tiles i = h, h + 2, ... from ring h,
// so that one warpgroup's epilogue overlaps the other's products. Its j-th
// tile's K block kb is use k = 8 j + kb of ring h: slot h * RING + k % RING,
// phase parity (k / RING) % 2.
__global__ void __launch_bounds__(THREADS, 1)
s2d_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wk,
                 const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H, int W, int Ws,
                 int cells, int rows, int taps, long long sb, long long sp) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sW = base, sA = sW + W_BYTES, sBar = sA + 2 * RING * A_BYTES;
  auto full = [&](int s) { return sBar + 8 * s; };
  auto empty = [&](int s) { return sBar + 8 * (2 * RING + s); };
  auto slot = [](int h, int k) { return h * RING + k % RING; };
  auto parity = [](int k) { return uint32_t(k / RING) & 1; };
  const int tiles = (rows + BM - 1) / BM;
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;

  // The weights, once: row n of K block kb holds k = kb * 64 .. +63 of
  // output column n (wk is [128, 512], K contiguous).
  for (int i = threadIdx.x; i < W_BYTES / 16; i += THREADS) {
    const int kb = i / 1024, n = (i / 8) % 128, c = i % 8;
    cp_async16_u32(sW + kb * 16384 + swz128(n, c), wk + n * 512 + kb * 64 + c * 8, true);
  }
  cp_async_commit();
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * RING; ++s) {
      sm90::mbar_init(full(s), 128);  // one arrival per producer thread, when its copies have landed
      sm90::mbar_init(empty(s), 4);   // one arrival per warp of the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_wait<0>();
  fence_async_shared();  // the weights, written by cp.async, are read by wgmma
  __syncthreads();

  if (wgi == 0) {
    // Producer: thread tid copies chunk tid % 8 of rows tid / 8 + 16 q,
    // q = 0..3 (8 lanes a row: 128 contiguous bytes of a stage), for every
    // (tap, qi) block of every tile of this CTA, in tile order.
    const int c = tid % 8, qj = c / 4, ch = (c % 4) * 8;
    for (int i = 0, t = blockIdx.x; t < tiles; ++i, t += gridDim.x) {
      const int h = i % 2;
      const __nv_bfloat16* img[4];
      int y0[4], x0[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = t * BM + tid / 8 + 16 * q;
        const int b = r / cells, cc = r - b * cells, I = cc / Ws, J = cc - I * Ws;
        img[q] = r < rows ? x + b * sb : nullptr;
        y0[q] = 2 * I - 1;
        x0[q] = 2 * J - 1 + qj;
      }
      for (int kb = 0; kb < KB; ++kb) {
        const int k = i / 2 * KB + kb, s = slot(h, k), tap = kb / 2, qi = kb % 2;
        const int dy = 2 * ((taps >> (2 * tap)) & 1) + qi, dx = 2 * ((taps >> (2 * tap + 1)) & 1);
        sm90::mbar_wait(empty(s), parity(k) ^ 1);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int y = y0[q] + dy, xx = x0[q] + dx;
          const bool ok = img[q] != nullptr && y >= 0 && y < H && xx >= 0 && xx < W;
          cp_async16_u32(sA + s * A_BYTES + swz128(tid / 8 + 16 * q, c),
                         ok ? img[q] + ((long long)y * W + xx) * sp + ch : x, ok);
        }
        cp_async_arrive(full(s));
      }
    }
    cp_async_wait<0>();
  } else {
    const int h = wgi - 1, warp = tid / 32, lane = tid % 32;
    const int r = warp * 16 + lane / 4;  // rows r and r + 8 of the tile's 64
    __nv_bfloat162 bv[4];                // bias of channels 8 j + 2 (lane % 4) + {0, 1}
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const __nv_bfloat162*>(bias + 8 * j + 2 * (lane % 4));
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int j = 0, t = blockIdx.x + h * gridDim.x; t < tiles; ++j, t += 2 * gridDim.x) {
      for (int kb = 0; kb < KB; ++kb) {
        const int k = j * KB + kb, s = slot(h, k);
        sm90::mbar_wait(full(s), parity(k));
        fence_async_shared();  // the stage, written by cp.async, is read by wgmma
        const uint64_t da = sm90::desc(sA + s * A_BYTES), db = sm90::desc(sW + kb * 16384);
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) sm90::wgmma<128>(acc, da + 2 * kk, db + 2 * kk, kb > 0 || kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait();
        sm90::fence_regs(acc);
        if (lane == 0) sm90::mbar_arrive(empty(s));
      }

      // Epilogue: column n = (pi * 2 + pj) * 32 + co of a cell is pixel
      // (2I + pi, 2J + pj), channel co; 4 lanes write 8 channels (16 bytes)
      // of a pixel.
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cell = t * BM + r + 8 * e;
        if (cell >= rows) continue;
        const int b = cell / cells, cc = cell - b * cells, I = cc / Ws, J = cc - I * Ws;
        __nv_bfloat16* o = out + (((long long)b * H + 2 * I) * W + 2 * J) * C + 2 * (lane % 4);
        const bool y1 = 2 * I + 1 < H, x1 = 2 * J + 1 < W;
#pragma unroll
        for (int jn = 0; jn < 16; ++jn) {
          const int pi = jn / 8, pj = (jn / 4) % 2, co = (jn % 4) * 8;
          if ((pi && !y1) || (pj && !x1)) continue;
          *reinterpret_cast<__nv_bfloat162*>(o + ((long long)pi * W + pj) * C + co) =
              sm90::bias_silu2(acc[4 * jn + 2 * e], acc[4 * jn + 2 * e + 1], bv[jn % 4]);
        }
      }
    }
  }
}

}  // namespace wg

}  // namespace

cudaError_t launch_s2dconv(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                           long long sb, long long sp, int taps, cudaStream_t stream) {
  if (sp % 4 || sb % 4 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;  // the wrapper hands over 16-byte aligned pixels
  const int hs = (H + 1) / 2, ws = (W + 1) / 2;
  S2DProblem p{static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
               static_cast<float*>(out), H, W, ws, hs * ws, B * hs * ws, taps, sb, sp};
  const dim3 grid((p.rows + gemm::F32Tile::BM - 1) / gemm::F32Tile::BM, S2DProblem::N / gemm::F32Tile::BN);
  return gemm::launch<float, gemm::F32Tile, S2DProblem, true>(p, grid, stream);
}

cudaError_t launch_s2dconv_wgmma(const void* x, const void* wk, const void* bias, void* out, int B, int H, int W,
                                 long long sb, long long sp, int taps, cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (sp % 8 || sb % 8 || misaligned(x) || misaligned(wk) || misaligned(out) ||
      reinterpret_cast<uintptr_t>(bias) % 4)
    return cudaErrorInvalidValue;  // 16-byte copies of pixels and weights, 16-byte stores
  static const cudaError_t set =
      cudaFuncSetAttribute(wg::s2d_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM);
  if (set != cudaSuccess) return set;
  const int hs = (H + 1) / 2, ws = (W + 1) / 2, rows = B * hs * ws;
  const int tiles = (rows + wg::BM - 1) / wg::BM, grid = tiles < sm90::sm_count() ? tiles : sm90::sm_count();
  wg::s2d_wgmma_kernel<<<grid, wg::THREADS, wg::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wk),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), H, W, ws, hs * ws, rows, taps, sb,
      sp);
  return cudaSuccess;
}
