// Fused stem, bf16 tensor-core route (stem_tc_kernel; every call of the
// serving path): conv0 3x3 s2 + bias + SiLU, then conv1 3x3 s2 + bias + SiLU
// on raw NHWC images, both convs on the tensor cores (mma.sync m16n8k16).
// Replaces experiments/stem_pallas.py:254 fused_stem and :204
// fused_stem_v2; the fp32 route and the module's overview are in stem.cu.
//
// Bound on an H100 at yolov10s 640, batch 32 (uint8 [32,640,640,3] in, bf16
// [32,160,160,64] out): bytes, 39.3 MB in + 52.4 MB out = 0.027 ms at 3.35
// TB/s (0.043 ms counting the weights and the bf16 output as chip_smoke.py
// does); 36 GFLOP = 0.037 ms at the bf16 tensor-core peak. Beneath both
// lies a floor the bytes do not show: every conv0 and conv1 output takes a
// SiLU, two special-function operations (ex2, rcp) each, ~157 M SiLUs with
// the tile halo, 16 a clock per SM on 132 SMs: ~0.08 ms. The wider sizes
// scale both with c0 and c1.
//
// - Persistent CTAs of 8 warps walk tiles of 8 x 16 conv1 outputs with all
//   c1 channels (H/4 is a multiple of 8; a ragged last column tile is
//   masked); two CTAs an SM where the plan fits twice (yolov10n and s), one
//   otherwise.
// - Weights packed once (kernels/stem.py pack_weights) in the order the
//   mma.sync B fragments are read (conv0's 3 k-steps x c0, conv1's 9 taps x
//   c0 x c1), copied to shared memory with 16-byte cp.async and read with
//   16-byte, conflict-free loads. conv1's 9 taps stay resident where they
//   fit beside the rest of the plan (yolov10n/s/m); for b/l/x (144 and 225
//   KB) they stream through a ring of 3 tap slots: the weights are the same
//   for every tile, so the ring cycles through taps 0..8 without end, each
//   tap's copy issued two taps ahead of its use (one barrier a tap; the
//   slot it refills was last read a tap earlier). The cost: each tile
//   reads conv1's weights from L2 once.
// - Input patch: 35 rows x 67 pixels x 3 channels, in 16-byte cp.async
//   chunks (zero-filled outside the image), double-buffered: the next
//   tile's patch lands while this one computes. It is then laid out as
//   bf16 pixel pairs, 16 bytes each (2 x 3 channels + 2 zeros; uint8 to
//   bf16 is exact).
// - conv0 on the tensor cores: an implicit GEMM, M = the 17 x 33 conv0
//   pixels of the tile (36 m16 tiles), N = c0, K = 3 rows of taps x 16:
//   one k16 step reads the pixel pairs (2c, 2c+1) and (2c+2, 2c+3) of one
//   input row, which is the 9 values of one kernel row of the stride-2
//   conv and 7 that meet zero weights. So ldmatrix reads the A fragments
//   straight from the patch, one 16-byte row address per lane. Its
//   epilogue zeroes conv1's padding pixels and writes bf16 into a
//   128B-swizzled activation buffer in shared memory.
// - conv1 on the tensor cores: 9 taps x c0/16 k16 steps, M = the 128 output
//   pixels, N = c1; the A rows are the stride-2 pixels of the activation
//   buffer, one ldmatrix row address per lane. A warp takes MTW output rows
//   by NGW groups of 32 channels (Plan: 2 x 1 groups for s, 1 x 3 for m,
//   4 x 1 for b/l, 1 x 5 for x).
// - Epilogue (both convs): the folded JAX forward's rounding points with
//   the fast SiLU of gemm_sm90.cuh (ex2.approx, rcp.approx), the roundings
//   and the bias add on bf16 pairs (sm90::bias_silu2); conv1's outputs go
//   through a per-warp swizzled staging buffer to 16-byte stores.
#include "common.cuh"
#include "gemm.cuh"
#include "gemm_sm90.cuh"
#include "kernels.h"

namespace {

constexpr int TY = 8, TX = 16;                 // conv1 outputs per tile: rows, columns
constexpr int R0 = 2 * TY + 1, Q0 = 2 * TX + 1;  // conv0 pixels per tile: 17 rows x 33
constexpr int P0 = R0 * Q0;                    // 561
constexpr int MT0 = (P0 + 15) / 16;            // 36 m16 tiles of conv0
constexpr int PR = 2 * R0 + 1;                 // 35 input rows
constexpr int PC = 2 * Q0 + 1;                 // 67 input columns
constexpr int PAIRS = (PC + 1) / 2;            // 34 pixel pairs a row
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int SMEM_LIMIT = 227 * 1024;         // dynamic shared memory a CTA can have
constexpr int SM_SMEM = 228 * 1024;            // shared memory of an SM (1 KB of it reserved per CTA)
constexpr int STAGE_BYTES = 16 * 64;           // a warp's conv1 staging: 16 pixels x 32 channels
static_assert(TY == WARPS, "conv1's warp layout splits the tile's 8 rows over the 8 warps");

constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// Byte offset in a buffer of 128-byte rows, 16-byte chunk c of row r at
// chunk c ^ (r % 8): the 8 rows an ldmatrix or a warp's stores touch land on
// distinct banks.
__device__ __forceinline__ int swz(int off) { return off ^ (((off >> 7) & 7) << 4); }

template <int C0, int C1, typename Tin>
struct Plan {
  static constexpr int E = sizeof(Tin);
  // The patch's column 0 (global input column 4*ox0-3, ox0 a multiple of
  // 16) starts OFF bytes into its first 16-byte chunk of the image row.
  static constexpr int OFF = (16 - (9 * E) % 16) % 16;
  static constexpr int CHUNKS = (OFF + PC * 3 * E + 15) / 16;
  static constexpr int PITCH = CHUNKS * 16;
  static constexpr int RAW_BYTES = PR * PITCH;
  static constexpr int TAP_BYTES = C0 * C1 * 2;        // conv1 B fragments of one tap
  static constexpr int W0_BYTES = 3 * 16 * C0 * 2;     // conv0 B fragments
  static constexpr int PATCH_BYTES = PR * PAIRS * 16;  // bf16 pixel pairs; then conv1's staging
  static constexpr int ACT_BYTES = MT0 * 16 * C0 * 2;  // conv0 activations, 576 pixels
  static constexpr int REST = W0_BYTES + ACT_BYTES + PATCH_BYTES + 2 * RAW_BYTES;
  // conv1's weights: all 9 taps resident where they fit, else a ring of 3.
  static constexpr bool STREAM = 9 * TAP_BYTES + REST > SMEM_LIMIT;
  static constexpr int W1_BYTES = (STREAM ? 3 : 9) * TAP_BYTES;
  static constexpr int w1 = 0;
  static constexpr int w0 = w1 + W1_BYTES;
  static constexpr int act = w0 + W0_BYTES;
  static constexpr int patch = act + ACT_BYTES;
  static constexpr int raw = patch + PATCH_BYTES;
  static constexpr int SMEM = raw + 2 * RAW_BYTES;
  static constexpr int MINB = 2 * (SMEM + 1024) <= SM_SMEM ? 2 : 1;  // CTAs an SM
  // conv1's warp layout: NGG blocks of NGW 32-channel groups side by side,
  // MG row groups of MTW output rows.
  static constexpr int NG = C1 / 32;
  static constexpr int NGG = gcd(NG, WARPS);
  static constexpr int NGW = NG / NGG;
  static constexpr int MG = WARPS / NGG;
  static constexpr int MTW = TY / MG;
  static_assert(TAP_BYTES % 128 == 0 && W0_BYTES % 128 == 0 && ACT_BYTES % 128 == 0 && PATCH_BYTES % 16 == 0 &&
                    RAW_BYTES % 16 == 0,
                "alignment of the shared buffers");
  static_assert(WARPS * STAGE_BYTES <= PATCH_BYTES && C0 % 16 == 0 && C1 % 32 == 0 && SMEM <= SMEM_LIMIT, "plan");
};

template <typename Tin>
__device__ __forceinline__ float raw_value(const unsigned char* p) {
  if constexpr (sizeof(Tin) == 1)
    return float(*p);
  else
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int C0, int C1, typename Tin>
__global__ void __launch_bounds__(THREADS, Plan<C0, C1, Tin>::MINB)
stem_tc_kernel(const Tin* __restrict__ x, const uint4* __restrict__ w0p, const __nv_bfloat16* __restrict__ b0,
               const uint4* __restrict__ w1p, const __nv_bfloat16* __restrict__ b1, __nv_bfloat16* __restrict__ out,
               int H, int W, int tiles) {
  using L = Plan<C0, C1, Tin>;
  constexpr int NJ0 = C0 / 8, KS = C0 / 16, NP1 = C1 / 16, TAP16 = L::TAP_BYTES / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* act = smem + L::act;
  unsigned char* patch = smem + L::patch;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int H1 = H / 4, W1 = W / 4, tiles_x = (W1 + TX - 1) / TX, tiles_y = H1 / TY;
  const long long row_bytes = (long long)W * 3 * L::E;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);

  // The input patch of tile t into raw buffer `buf`: 35 rows of CHUNKS
  // 16-byte chunks; a chunk outside the image is zero-filled (rows are
  // multiples of 16 bytes, so a chunk is wholly inside or outside).
  auto load_patch = [&](int t, int buf) {
    const int txi = t % tiles_x, tyi = t / tiles_x % tiles_y, b = t / tiles_x / tiles_y;
    const int y0 = 4 * TY * tyi - 3, a0 = (4 * TX * txi - 3) * 3 * L::E - L::OFF;
    unsigned char* dst = smem + L::raw + buf * L::RAW_BYTES;
    for (int i = tid; i < PR * L::CHUNKS; i += THREADS) {
      const int r = i / L::CHUNKS, o = a0 + 16 * (i % L::CHUNKS), y = y0 + r;
      const bool ok = y >= 0 && y < H && o >= 0 && o + 16 <= row_bytes;
      cp_async16(dst + r * L::PITCH + 16 * (i % L::CHUNKS), ok ? xb + ((long long)b * H + y) * row_bytes + o : xb, ok);
    }
  };
  // conv1's tap into ring slot tap % 3 (streamed plans; 9 % 3 == 0, so
  // the slot of a tap is the same on every tile).
  auto load_tap = [&](int tap) {
    unsigned char* dst = smem + L::w1 + (tap % 3) * L::TAP_BYTES;
    for (int i = tid; i < TAP16; i += THREADS) cp_async16(dst + 16 * i, w1p + tap * TAP16 + i, true);
  };

  // The B fragments to shared memory (conv1's first two taps where they
  // stream), with the first tile's patch.
  if constexpr (L::STREAM)
    load_tap(0);
  else
    for (int i = tid; i < L::W1_BYTES / 16; i += THREADS) cp_async16(smem + L::w1 + 16 * i, w1p + i, true);
  for (int i = tid; i < L::W0_BYTES / 16; i += THREADS) cp_async16(smem + L::w0 + 16 * i, w0p + i, true);
  if (int(blockIdx.x) < tiles) load_patch(blockIdx.x, 0);
  cp_async_commit();
  if constexpr (L::STREAM) {
    load_tap(1);
    cp_async_commit();
  }

  // This thread's biases stay in registers.
  const int gi = warp / L::MG, mg = warp % L::MG;  // conv1: channel-group block, row group of this warp
  __nv_bfloat162 bias0[NJ0], bias1[L::NGW][4];
#pragma unroll
  for (int j = 0; j < NJ0; ++j) bias0[j] = *reinterpret_cast<const __nv_bfloat162*>(b0 + 8 * j + 2 * (lane % 4));
#pragma unroll
  for (int g = 0; g < L::NGW; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bias1[g][j] = *reinterpret_cast<const __nv_bfloat162*>(b1 + 32 * (gi * L::NGW + g) + 8 * j + 2 * (lane % 4));

  // This lane's ldmatrix row in each conv1 m16 tile: output column tx.
  const int tx_l = lane % 8 + (lane / 8) % 2 * 8, half_l = lane / 16;

  for (int i = 0, t = blockIdx.x; t < tiles; ++i, t += gridDim.x) {
    const int txi = t % tiles_x, tyi = t / tiles_x % tiles_y, b = t / tiles_x / tiles_y;
    const int oy0 = TY * tyi, ox0 = TX * txi;
    if (t + int(gridDim.x) < tiles) load_patch(t + gridDim.x, (i + 1) % 2);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's patch (and, at first, the weights) has landed
    __syncthreads();     // ... for every thread; the last tile's staging is read out

    // Patch -> bf16 pixel pairs: pair j of row r holds columns 2j and 2j+1
    // (column 67 lies past the patch and is zero).
    const unsigned char* raw = smem + L::raw + (i % 2) * L::RAW_BYTES + L::OFF;
    for (int k = tid; k < PR * PAIRS; k += THREADS) {
      const int r = k / PAIRS, j = k % PAIRS;
      const unsigned char* src = raw + r * L::PITCH + 6 * j * L::E;
      float v[6];
#pragma unroll
      for (int e = 0; e < 6; ++e) v[e] = (6 * j + e < 3 * PC) ? raw_value<Tin>(src + e * L::E) : 0.f;
      *reinterpret_cast<uint4*>(patch + 16 * k) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                                             pack2(v[4], v[5]), 0u);
    }
    __syncthreads();

    // conv0: m16 tiles of conv0 pixels q = r * 33 + c; the k16 step of
    // kernel row kh reads pixel pairs c and c + 1 of patch row 2r + kh.
    for (int mt = warp; mt < MT0; mt += WARPS) {
      const int q = min(mt * 16 + lane % 8 + (lane / 8) % 2 * 8, P0 - 1);
      const unsigned char* a_row = patch + ((2 * (q / Q0)) * PAIRS + q % Q0 + lane / 16) * 16;
      float acc[NJ0][4];
#pragma unroll
      for (int j = 0; j < NJ0; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        unsigned a[4];
        gemm::ldsm_x4(a, a_row + kh * PAIRS * 16);
        const uint4* wf = reinterpret_cast<const uint4*>(smem + L::w0) + kh * (C0 / 16) * 32 + lane;
#pragma unroll
        for (int jp = 0; jp < NJ0 / 2; ++jp) {
          const uint4 w = wf[32 * jp];
          gemm::mma_16816(acc[2 * jp], a, w.x, w.y);
          gemm::mma_16816(acc[2 * jp + 1], a, w.z, w.w);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qq = mt * 16 + lane / 4 + 8 * h;
        if (qq >= P0) continue;
        // Row/column -1 is conv1's zero padding (a tile never reaches H/2).
        const bool pad = (2 * oy0 - 1 + qq / Q0) < 0 || (2 * ox0 - 1 + qq % Q0) < 0;
#pragma unroll
        for (int j = 0; j < NJ0; ++j) {
          const __nv_bfloat162 v = pad ? __floats2bfloat162_rn(0.f, 0.f)
                                       : sm90::bias_silu2(acc[j][2 * h], acc[j][2 * h + 1], bias0[j]);
          *reinterpret_cast<__nv_bfloat162*>(act + swz(qq * 2 * C0 + (8 * j + 2 * (lane % 4)) * 2)) = v;
        }
      }
    }
    __syncthreads();

    // conv1: this warp's MTW output rows x NGW groups of 32 channels; A row
    // of lane: the conv0 pixel (2 ty + kh, 2 tx + kw), channels k-step * 16
    // + half * 8.
    float acc[L::MTW][L::NGW][4][4];
#pragma unroll
    for (int m = 0; m < L::MTW; ++m)
#pragma unroll
      for (int g = 0; g < L::NGW; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][g][j][0] = acc[m][g][j][1] = acc[m][g][j][2] = acc[m][g][j][3] = 0.f;
#pragma unroll 1  // unrolled, the 9 taps' addresses spill (measured slower)
    for (int tap = 0; tap < 9; ++tap) {
      const uint4* wtap;
      if constexpr (L::STREAM) {
        cp_async_wait<1>();  // this tap's copy has landed (the next tap's may still fly)
        __syncthreads();     // ... for every thread; every warp is done with the previous tap's slot
        load_tap((tap + 2) % 9);
        cp_async_commit();
        wtap = reinterpret_cast<const uint4*>(smem + L::w1 + (tap % 3) * L::TAP_BYTES);
      } else {
        wtap = reinterpret_cast<const uint4*>(smem + L::w1 + tap * L::TAP_BYTES);
      }
#pragma unroll
      for (int cb = 0; cb < KS; ++cb) {
        uint4 w01[L::NGW], w23[L::NGW];
#pragma unroll
        for (int g = 0; g < L::NGW; ++g) {
          const uint4* wf = wtap + (cb * NP1 + 2 * (gi * L::NGW + g)) * 32 + lane;
          w01[g] = wf[0];
          w23[g] = wf[32];
        }
#pragma unroll
        for (int m = 0; m < L::MTW; ++m) {
          const int ty = mg * L::MTW + m;
          const int q = (2 * ty + tap / 3) * Q0 + 2 * tx_l + tap % 3;
          unsigned a[4];
          gemm::ldsm_x4(a, act + swz(q * 2 * C0 + (cb * 16 + half_l * 8) * 2));
#pragma unroll
          for (int g = 0; g < L::NGW; ++g) {
            gemm::mma_16816(acc[m][g][0], a, w01[g].x, w01[g].y);
            gemm::mma_16816(acc[m][g][1], a, w01[g].z, w01[g].w);
            gemm::mma_16816(acc[m][g][2], a, w23[g].x, w23[g].y);
            gemm::mma_16816(acc[m][g][3], a, w23[g].z, w23[g].w);
          }
        }
      }
    }

    // Epilogue: per output row and channel group, a warp stages 16 pixels x
    // 32 channels (64 bytes a pixel) in its slice of the patch buffer, then
    // writes 16-byte chunks.
    unsigned char* stage = patch + warp * STAGE_BYTES;
#pragma unroll
    for (int m = 0; m < L::MTW; ++m) {
      const int oy = oy0 + mg * L::MTW + m;
#pragma unroll
      for (int g = 0; g < L::NGW; ++g) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = lane / 4 + 8 * h;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<__nv_bfloat162*>(stage + swz(px * 64 + j * 16 + (lane % 4) * 4)) =
                sm90::bias_silu2(acc[m][g][j][2 * h], acc[m][g][j][2 * h + 1], bias1[g][j]);
        }
        __syncwarp();
#pragma unroll
        for (int k = lane; k < 64; k += 32) {
          const int px = k / 4, ch = k % 4, ox = ox0 + px;
          if (ox < W1)
            *reinterpret_cast<uint4*>(out + (((long long)b * H1 + oy) * W1 + ox) * C1 + 32 * (gi * L::NGW + g) +
                                      8 * ch) = *reinterpret_cast<const uint4*>(stage + swz(px * 64 + 16 * ch));
        }
        __syncwarp();
      }
    }
  }
  cp_async_wait<0>();
}

template <int C0, int C1, typename Tin>
cudaError_t launch(const void* x, const void* w0p, const void* b0, const void* w1p, const void* b1, void* out,
                   int B, int H, int W, cudaStream_t stream) {
  using L = Plan<C0, C1, Tin>;
  auto kernel = stem_tc_kernel<C0, C1, Tin>;
  static const int per_sm = [&] {
    int n = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, L::SMEM) != cudaSuccess)
      return 0;
    return n;
  }();
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = B * (H / 4 / TY) * ((W / 4 + TX - 1) / TX);
  const int grid = tiles < per_sm * sm90::sm_count() ? tiles : per_sm * sm90::sm_count();
  kernel<<<grid, THREADS, L::SMEM, stream>>>(static_cast<const Tin*>(x), static_cast<const uint4*>(w0p),
                                            static_cast<const __nv_bfloat16*>(b0), static_cast<const uint4*>(w1p),
                                            static_cast<const __nv_bfloat16*>(b1), static_cast<__nv_bfloat16*>(out),
                                            H, W, tiles);
  return cudaSuccess;
}

template <int C0, int C1>
cudaError_t launch_in(const void* x, bool x_u8, const void* w0p, const void* b0, const void* w1p, const void* b1,
                      void* out, int B, int H, int W, cudaStream_t stream) {
  return x_u8 ? launch<C0, C1, uint8_t>(x, w0p, b0, w1p, b1, out, B, H, W, stream)
              : launch<C0, C1, __nv_bfloat16>(x, w0p, b0, w1p, b1, out, B, H, W, stream);
}

}  // namespace

cudaError_t launch_stem_tc(const void* x, bool x_u8, const void* w0p, const void* b0, const void* w1p,
                           const void* b1, void* out, int B, int H, int W, int c0, int c1, cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (H % 32 || W % 32 || misaligned(x) || misaligned(w0p) || misaligned(w1p) || misaligned(out) ||
      reinterpret_cast<uintptr_t>(b0) % 4 || reinterpret_cast<uintptr_t>(b1) % 4)
    return cudaErrorInvalidValue;
#define STEM_TC(C0, C1) \
  if (c0 == C0 && c1 == C1) return launch_in<C0, C1>(x, x_u8, w0p, b0, w1p, b1, out, B, H, W, stream);
  STEM_WIDTHS(STEM_TC)
#undef STEM_TC
  return cudaErrorInvalidValue;
}
