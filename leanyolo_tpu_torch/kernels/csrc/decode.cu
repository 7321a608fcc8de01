// The decode's two per-anchor kernels, each one launch for up to four
// levels of head maps, read in place (strided rows, as the slices of a
// concatenated [B, H, W, 4R+nc] map):
//
// - gather_rows (K2) replaces the JAX package's one-hot-dot level gather,
//   leanyolo_tpu/models/yolov10/decode.py:102 _gather_levels: the rows of k
//   anchors by global index, bits copied, except that -0.0 is written as
//   +0.0 (the one-hot dot adds the row to zeros, and -0.0 + 0.0 = +0.0).
//   A thread moves one 16-byte chunk of a row (or one element where the rows
//   do not split into aligned chunks). An index outside [0, A) gives a zero
//   row, as the dot's one-hot matches no anchor.
// - dfl_boxes (K3) replaces the dense per-level DFL and box decode,
//   decode.py:191 _boxes_per_level with ops/anchors.py:73 dfl_expectation,
//   :48 dist2bbox and :17 make_anchors: only the k selected anchors are
//   decoded. A thread takes one side of one anchor: its reg_max = 16 bins'
//   softmax expectation, then the side's coordinate in pixels. In top-k mode
//   the anchor comes from a (anchor, class) pair of the second top-k, and the
//   row also gets sigmoid(logit) and the class.
//
// Order of operations (kernels/dfl.py's plain version computes the same,
// one rounding an operation, so the two are bit-equal on the card): m = the
// max of the 16 bins; e_i = expf(v_i - m); den = e_0 + e_1 + ... + e_15 and
// num = e_0*0 + e_1*1 + ... + e_15*15, left to right; d = num / den; the
// anchor's centre a = cell + 0.5; x1, y1 = (a - d) * stride, x2, y2 =
// (a + d) * stride; the score 1 / (1 + expf(-logit)) (torch.sigmoid's
// formula). The intrinsics keep nvcc from contracting a product and a sum
// into one FMA; expf is the full-precision one (no fast math).
//
// Bound on an H100: bytes (kernels/bounds.py), far below a launch's latency:
// the top-k decode's [32, 300, 80] bf16 rows, 1.5 MB in and 1.5 MB out, take
// 0.9 us at 3.35 TB/s; the box decode of [32, 300] anchors moves 1.6 MB (0.5
// us), of [32, 1000] 4.7 MB (1.4 us).
#include <cuda_bf16.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 256;

// Level of global anchor g: read at constant indices only (a dynamic index
// into the kernel's parameters copies them to local memory).
struct Cell {
  const void* x;
  long long sb, ld;
  int start, w;
  float s;
};

__device__ __forceinline__ Cell cell_of(const DecodeLevels& lv, int g) {
  Cell c{lv.x[0], lv.sb[0], lv.ld[0], 0, lv.w[0], lv.stride[0]};
#pragma unroll
  for (int l = 1; l < DECODE_MAX_LEVELS; ++l) {
    if (l < lv.count && g >= lv.start[l]) c = Cell{lv.x[l], lv.sb[l], lv.ld[l], lv.start[l], lv.w[l], lv.stride[l]};
  }
  return c;
}

// -0.0 -> +0.0 on raw bits: U is the element's bit type (uint16_t for bf16,
// uint32_t for fp32).
template <typename U>
__device__ __forceinline__ U plus_zero(U u) {
  constexpr U neg_zero = U(1) << (8 * sizeof(U) - 1);
  return u == neg_zero ? U(0) : u;
}
__device__ __forceinline__ uint32_t plus_zero_word(uint32_t u, uint32_t) { return plus_zero<uint32_t>(u); }
__device__ __forceinline__ uint32_t plus_zero_word(uint32_t u, uint16_t) {
  const uint32_t lo = plus_zero<uint16_t>(uint16_t(u & 0xFFFFu)), hi = plus_zero<uint16_t>(uint16_t(u >> 16));
  return lo | (hi << 16);
}

template <typename U, bool VEC>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(DecodeLevels lv, int A, const int32_t* __restrict__ idx, int k, int C, long long total,
                   U* __restrict__ out) {
  constexpr int V = VEC ? 16 / sizeof(U) : 1;  // elements a thread moves
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= total) return;
  const int per_row = C / V;
  const long long row = t / per_row;  // b * k + j
  const int c = static_cast<int>(t - row * per_row) * V;
  const int b = static_cast<int>(row / k);
  const int g = __ldg(idx + row);
  U* dst = out + row * C + c;
  if (g < 0 || g >= A) {
    if (VEC) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    } else {
      *dst = U(0);
    }
    return;
  }
  const Cell cl = cell_of(lv, g);
  const U* src = static_cast<const U*>(cl.x) + b * cl.sb + (g - cl.start) * cl.ld + c;
  if (VEC) {
    uint4 q = __ldg(reinterpret_cast<const uint4*>(src));
    q.x = plus_zero_word(q.x, U());
    q.y = plus_zero_word(q.y, U());
    q.z = plus_zero_word(q.z, U());
    q.w = plus_zero_word(q.w, U());
    *reinterpret_cast<uint4*>(dst) = q;
  } else {
    *dst = plus_zero<U>(__ldg(src));
  }
}

template <typename U>
cudaError_t gather_launch(const DecodeLevels& lv, int B, int C, const int32_t* idx, int k, void* out,
                          cudaStream_t stream) {
  bool vec = (C * sizeof(U)) % 16 == 0;
  for (int l = 0; l < lv.count; ++l) {
    vec = vec && reinterpret_cast<uintptr_t>(lv.x[l]) % 16 == 0 && (lv.ld[l] * sizeof(U)) % 16 == 0 &&
          (lv.sb[l] * sizeof(U)) % 16 == 0;
  }
  const long long total = static_cast<long long>(B) * k * (vec ? C / (16 / sizeof(U)) : C);
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  U* o = static_cast<U*>(out);
  if (vec) {
    gather_rows_kernel<U, true><<<blocks, THREADS, 0, stream>>>(lv, lv.start[lv.count], idx, k, C, total, o);
  } else {
    gather_rows_kernel<U, false><<<blocks, THREADS, 0, stream>>>(lv, lv.start[lv.count], idx, k, C, total, o);
  }
  return cudaGetLastError();
}

constexpr int REG_MAX = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// The 16 bins of one side: 16-byte loads (VEC) or one element at a time.
template <bool VEC>
__device__ __forceinline__ void load_bins(const __nv_bfloat16* p, float* v) {
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + h);
      const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[8 * h + 2 * i] = __uint_as_float(u[i] << 16);
        v[8 * h + 2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < REG_MAX; ++i) v[i] = __bfloat162float(p[i]);
  }
}
template <bool VEC>
__device__ __forceinline__ void load_bins(const float* p, float* v) {
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + h);
      v[4 * h] = q.x, v[4 * h + 1] = q.y, v[4 * h + 2] = q.z, v[4 * h + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < REG_MAX; ++i) v[i] = __ldg(p + i);
  }
}

// T: the reg maps' type; L: the pair logits' type (top-k mode).
template <typename T, typename L, bool VEC, bool TOPK>
__global__ void __launch_bounds__(THREADS)
dfl_boxes_kernel(DecodeLevels lv, int A, int k, const int32_t* __restrict__ anchor_idx, int k1,
                 const int32_t* __restrict__ pair_idx, const L* __restrict__ pair_logits, int nc, long long total,
                 float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= total) return;
  const long long row = t >> 2;  // b * k + j
  const int side = static_cast<int>(t & 3);
  const int b = static_cast<int>(row / k);
  int g, pair = 0, rel = 0;
  if (TOPK) {
    pair = __ldg(pair_idx + row);
    rel = pair / nc;
    g = __ldg(anchor_idx + static_cast<long long>(b) * k1 + rel);
  } else {
    g = __ldg(anchor_idx + row);
  }
  float* o = out + row * (TOPK ? 6 : 4);
  if (TOPK && side == 0) {
    const float x = to_f(pair_logits[row]);
    o[4] = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
    o[5] = static_cast<float>(pair - rel * nc);
  }
  if (g < 0 || g >= A) {
    o[side] = 0.0f;
    return;
  }
  const Cell cl = cell_of(lv, g);
  const int local = g - cl.start;
  const int cy = local / cl.w, cx = local - cy * cl.w;
  float v[REG_MAX];
  load_bins<VEC>(static_cast<const T*>(cl.x) + b * cl.sb + local * cl.ld + side * REG_MAX, v);
  float m = v[0];
#pragma unroll
  for (int i = 1; i < REG_MAX; ++i) m = fmaxf(m, v[i]);
  const float e0 = expf(__fsub_rn(v[0], m));
  float den = e0, num = __fmul_rn(e0, 0.0f);
#pragma unroll
  for (int i = 1; i < REG_MAX; ++i) {
    const float e = expf(__fsub_rn(v[i], m));
    den = __fadd_rn(den, e);
    num = __fadd_rn(num, __fmul_rn(e, static_cast<float>(i)));
  }
  const float d = __fdiv_rn(num, den);
  const float a = static_cast<float>((side & 1) ? cy : cx) + 0.5f;  // l, r: x; t, b: y
  o[side] = __fmul_rn(side < 2 ? __fsub_rn(a, d) : __fadd_rn(a, d), cl.s);
}

template <typename T, typename L, bool TOPK>
cudaError_t dfl_launch(const DecodeLevels& lv, int B, const int32_t* anchor_idx, int k1, const int32_t* pair_idx,
                       const void* pair_logits, int k, int nc, float* out, cudaStream_t stream) {
  bool vec = true;
  for (int l = 0; l < lv.count; ++l) {
    vec = vec && reinterpret_cast<uintptr_t>(lv.x[l]) % 16 == 0 && (lv.ld[l] * sizeof(T)) % 16 == 0 &&
          (lv.sb[l] * sizeof(T)) % 16 == 0;
  }
  const long long total = 4LL * B * k;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  const L* lg = static_cast<const L*>(pair_logits);
  const int A = lv.start[lv.count];
  if (vec) {
    dfl_boxes_kernel<T, L, true, TOPK><<<blocks, THREADS, 0, stream>>>(lv, A, k, anchor_idx, k1, pair_idx, lg, nc,
                                                                        total, out);
  } else {
    dfl_boxes_kernel<T, L, false, TOPK><<<blocks, THREADS, 0, stream>>>(lv, A, k, anchor_idx, k1, pair_idx, lg, nc,
                                                                         total, out);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dfl_dispatch(const DecodeLevels& lv, int B, const int32_t* anchor_idx, int k1, const int32_t* pair_idx,
                         const void* pair_logits, bool logits_bf16, int k, int nc, float* out, cudaStream_t stream) {
  if (!pair_idx) return dfl_launch<T, float, false>(lv, B, anchor_idx, k1, nullptr, nullptr, k, 1, out, stream);
  return logits_bf16
             ? dfl_launch<T, __nv_bfloat16, true>(lv, B, anchor_idx, k1, pair_idx, pair_logits, k, nc, out, stream)
             : dfl_launch<T, float, true>(lv, B, anchor_idx, k1, pair_idx, pair_logits, k, nc, out, stream);
}

}  // namespace

cudaError_t launch_gather_rows(const DecodeLevels& lv, int B, int C, const int32_t* idx, int k, bool bf16,
                               void* out, cudaStream_t stream) {
  if (lv.count < 1 || lv.count > DECODE_MAX_LEVELS || C < 1 || k < 1) return cudaErrorInvalidValue;
  return bf16 ? gather_launch<uint16_t>(lv, B, C, idx, k, out, stream)
              : gather_launch<uint32_t>(lv, B, C, idx, k, out, stream);
}

cudaError_t launch_dfl_boxes(const DecodeLevels& lv, int B, const int32_t* anchor_idx, int k1,
                             const int32_t* pair_idx, const void* pair_logits, bool logits_bf16, int k, int nc,
                             bool bf16, float* out, cudaStream_t stream) {
  if (lv.count < 1 || lv.count > DECODE_MAX_LEVELS || k < 1 || (pair_idx && (nc < 1 || !pair_logits))) {
    return cudaErrorInvalidValue;
  }
  return bf16 ? dfl_dispatch<__nv_bfloat16>(lv, B, anchor_idx, k1, pair_idx, pair_logits, logits_bf16, k, nc, out,
                                            stream)
              : dfl_dispatch<float>(lv, B, anchor_idx, k1, pair_idx, pair_logits, logits_bf16, k, nc, out, stream);
}
