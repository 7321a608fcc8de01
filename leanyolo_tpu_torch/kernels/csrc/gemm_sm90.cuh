// Hopper GEMM for bf16: out[R, N] = x[R, K] @ w[K, N], fp32 sum, then the
// folded conv's epilogue (rounding, bias, SiLU) as the JAX forward applies it.
//
// Design (sm_90a):
// - TMA loads A (x, rows `lda` apart: a channel slice of an NHWC map is read
//   in place) and B (w held K-major, [N, K] with rows `ldb` apart) in boxes
//   of 64 bf16 along K (128 bytes, 128B-swizzled) into a ring of STAGES
//   stages, each signalled by a "full" mbarrier; out-of-range rows and K
//   columns arrive as zeros, so ragged edges cost no branch.
// - One producer thread issues the loads; a pair of consumer warpgroups
//   runs wgmma m64nBNk16 (fp32 accumulate), each on 64 rows of a 128 x BN
//   tile (BN 64, 80 or 128), and frees a stage through its "empty" mbarrier.
// - Persistent CTAs, one per SM, walk the tile list (columns fastest, so
//   neighbouring CTAs share A rows through L2). The ring runs across tile
//   boundaries: the producer loads the next tiles while the consumers run
//   the epilogue of this one.
// - Where a CTA has many tiles (the wrapper picks), two consumer pairs take
//   alternate tiles, each from a ring of its own, so that one pair's
//   epilogue (SiLU is bound by the special-function unit) overlaps the
//   other's products and the loads.
// - Epilogue: registers -> bf16 in shared memory (the 128B-swizzled layout,
//   conflict-free) -> TMA stores of 64 x 64 boxes, which clip the ragged
//   edge. The store of one tile drains while the next tile computes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "common.cuh"

namespace sm90 {

constexpr int BM = 128, BK = 64;       // tile rows; K per stage (128 bytes of bf16)
constexpr int SMEM_LIMIT = 232448;     // bytes a block may use on an H100
constexpr int A_BYTES = BM * BK * 2;
constexpr int BOX_BYTES = BM * 64 * 2;  // one 64-column box of the output tile

// PAIRS pairs of consumer warpgroups; each pair computes every PAIRS-th
// tile, its two warpgroups 64 rows each, from a ring of its own (RING
// stages), so that each ring is consumed in order.
template <int BN, int PAIRS>
struct Config {
  static constexpr int THREADS = 128 * (1 + 2 * PAIRS);
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BOXES = (BN + 63) / 64;
  static constexpr int BUF_BYTES = BOXES * BOX_BYTES;  // one output tile's staging, per pair
  static constexpr int C_BYTES = PAIRS * BUF_BYTES;
  static constexpr int BAR_BYTES = 256;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - C_BYTES - BAR_BYTES) / STAGE_BYTES / PAIRS;
  // As many stages as fit, at most 7 for one pair and 4 each for two.
  static constexpr int RING = FIT > 6 / PAIRS + 1 ? 6 / PAIRS + 1 : FIT;
  static constexpr int STAGES = RING * PAIRS;
  // 1024 bytes of slack to align the ring: 128B swizzle repeats every 1024.
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + C_BYTES + BAR_BYTES;
  static_assert(STAGES >= 2 && B_BYTES % 1024 == 0 && 16 * STAGES <= BAR_BYTES, "shared memory plan");
};

// What the epilogue applies after rounding the sum: nothing, the bias, or
// the bias and SiLU.
enum Epilogue { PLAIN = 0, BIAS = 1, BIAS_SILU = 3 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// Returns once the phase of parity `parity` has completed. A phase that
// has not completed after 4 seconds (a load that was never issued) traps
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t since = 0;
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries % 1024 == 0) {
      const uint64_t now = global_ns();
      if (since == 0) since = now;
      if (now - since > 4000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Waits until the committed stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma operand descriptor of a K-major, 128B-swizzled tile whose rows are
// 128 bytes apart (8-row atoms 1024 bytes apart).
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (the registers change behind its back).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int BN>
__device__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma<80>(float (&d)[40], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 "
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
// SMs of the current device (persistent kernels launch one CTA or two per SM).
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// SiLU as y / (1 + 2^(-y log2 e)) with the hardware's approximate exp2 and
// reciprocal: two special-function operations an element, no branch.
__device__ __forceinline__ float silu_fast(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return y * r;
}

// The epilogue's rounding points for a bf16 output, as the folded JAX
// forward has them: the fp32 sum rounded, + bias rounded, SiLU rounded.
// SiLU is the fast form: it can part from an exact fp32 SiLU by a few fp32
// ulps, which moves the bf16 result by one ulp where that lies on a
// rounding boundary.
template <int EPI>
__device__ __forceinline__ float epilogue(float acc, float b) {
  float y = round_bf16(acc);
  if constexpr (EPI & BIAS) y = round_bf16(y + b);
  if constexpr (EPI == BIAS_SILU) y = round_bf16(silu_fast(y));
  return y;
}

// The BIAS_SILU epilogue of two neighbouring outputs, in bf16x2 where the
// rounding points allow: the pair of sums rounded at once, the bias added
// by a bf16 add (correctly rounded: the fp32 sum of two bf16 values,
// rounded, as the folded forward computes it), SiLU in fp32 (silu_fast),
// rounded as a pair. Bit-equal to epilogue<BIAS_SILU> on each element.
__device__ __forceinline__ __nv_bfloat162 bias_silu2(float a0, float a1, __nv_bfloat162 b) {
  const float2 y = __bfloat1622float2(__hadd2(__floats2bfloat162_rn(a0, a1), b));
  return __floats2bfloat162_rn(silu_fast(y.x), silu_fast(y.y));
}

template <int BN, int EPI, int PAIRS>
__global__ void __launch_bounds__(Config<BN, PAIRS>::THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tc, const __nv_bfloat16* __restrict__ bias, int rows, int K,
                int N) {
  using Cfg = Config<BN, PAIRS>;
  constexpr int S = Cfg::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sA = base, sB = sA + S * A_BYTES, sC = sB + S * Cfg::B_BYTES, sBar = sC + Cfg::C_BYTES;
  auto full = [&](int s) { return sBar + 8 * s; };
  auto empty = [&](int s) { return sBar + 8 * (S + s); };

  const int n_tiles = (N + BN - 1) / BN, tiles = (rows + BM - 1) / BM * n_tiles, kblocks = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per warp of the pair that consumes the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The k-th stage use of ring p: its stage and the parity of its phase.
  constexpr int R = Cfg::RING;
  auto slot = [&](int p, int k) { return p * R + k % R; };
  auto parity = [&](int k) { return uint32_t(k / R) & 1; };

  if (wg == 0) {
    // Producer: one thread keeps the rings full, tile after tile.
    if constexpr (PAIRS == 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    if (tid == 0) {
      for (int i = 0, t = blockIdx.x; t < tiles; ++i, t += gridDim.x) {
        const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
        for (int kb = 0; kb < kblocks; ++kb) {
          const int k = i / PAIRS * kblocks + kb, s = slot(i % PAIRS, k);
          mbar_wait(empty(s), parity(k) ^ 1);
          mbar_expect_tx(full(s), Cfg::STAGE_BYTES);
          tma_load(sA + s * A_BYTES, &ta, kb * BK, m0, full(s));
          tma_load(sB + s * Cfg::B_BYTES, &tb, kb * BK, n0, full(s));
        }
      }
    }
  } else {
    // Consumer warpgroup c: pair c / 2 takes every PAIRS-th tile of this
    // CTA; the warpgroup computes rows (c % 2) * 64 .. +63 of it.
    if constexpr (PAIRS == 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n" ::: "memory");
    const int c = wg - 1, pair = c / 2, half = c % 2, warp = tid / 32, lane = tid % 32;
    const int r = warp * 16 + lane / 4;  // rows r and r + 8 of this warpgroup's 64
    const uint32_t sOut = sC + pair * Cfg::BUF_BYTES + half * 64 * 128;  // its rows of the staged boxes
    unsigned char* stage = smem_raw + (sOut - raw);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int i = pair, t = blockIdx.x + pair * gridDim.x; t < tiles; i += PAIRS, t += PAIRS * gridDim.x) {
      const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
      for (int kb = 0; kb < kblocks; ++kb) {
        const int k = i / PAIRS * kblocks + kb, s = slot(pair, k);
        mbar_wait(full(s), parity(k));
        const uint64_t da = desc(sA + s * A_BYTES + half * 64 * 128), db = desc(sB + s * Cfg::B_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma<BN>(acc, da + 2 * kk, db + 2 * kk, kb > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty(s));
      }

      // Epilogue. This warpgroup's stores of its previous tile must have
      // read the staging buffer before it is written again.
      if (tid == 0) bulk_wait_read();
      named_sync(1 + c, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + (lane % 4) * 2;
        float2 b = make_float2(0.f, 0.f);
        if constexpr (EPI & BIAS)
          if (col < N) b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          const __nv_bfloat162 v = __floats2bfloat162_rn(epilogue<EPI>(acc[j * 4 + 2 * h], b.x),
                                                         epilogue<EPI>(acc[j * 4 + 2 * h + 1], b.y));
          // 128B swizzle: 16-byte chunk (j % 8) of the row lands at chunk (j % 8) ^ (row % 8).
          *reinterpret_cast<__nv_bfloat162*>(stage + (j / 8) * BOX_BYTES + row * 128 + (((j % 8) ^ (row % 8)) * 16) +
                                             (lane % 4) * 4) = v;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + c, 128);
      if (tid == 0) {
#pragma unroll
        for (int bx = 0; bx < Cfg::BOXES; ++bx)
          if (n0 + bx * 64 < N) tma_store(&tc, sOut + bx * BOX_BYTES, n0 + bx * 64, m0 + half * 64);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait();
  }
}

}  // namespace sm90
