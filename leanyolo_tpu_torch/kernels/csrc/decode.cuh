// The decode's per-anchor device code, shared by the box decode K3
// (decode.cu) and the fused second top-k's epilogue (topk.cu): a global
// anchor's level and cell, its reg bins, and one side's DFL box coordinate
// in K3's order of operations (kernels/dfl.py's plain version computes the
// same, one rounding an operation: m = the max of the 16 bins; e_i =
// expf(v_i - m); den = e_0 + ... + e_15 and num = e_0*0 + ... + e_15*15,
// left to right; d = num / den; the anchor's centre a = cell + 0.5; x1, y1 =
// (a - d) * stride, x2, y2 = (a + d) * stride). The intrinsics keep nvcc
// from contracting a product and a sum into one FMA; expf is the
// full-precision one (no fast math).
//
// Non-finite values follow JAX's one-hot-dot gathers (kernels/gather.py,
// kernels/dfl.py): with the per-image flags of argmax.cu (kernels.h
// DecodeFlags), a side flagged non-finite is NaN in every box of its
// image, and a class column flagged non-finite is NaN in every gathered row
// but the one of its only non-finite anchor. Every NaN a box or score takes is
// written as 0x7FC00000.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "kernels.h"

namespace decode_detail {

constexpr int REG_MAX = 16;
constexpr uint32_t CANON_NAN = 0x7FC00000u;  // torch's float("nan")
constexpr uint32_t DOT_NAN = 0xFFC00000u;    // 0 * inf on the CPU JAX runs on

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

__device__ __forceinline__ float canon_nan(float v) { return v != v ? __uint_as_float(CANON_NAN) : v; }

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

// Side `side` (l, t, r, b) of anchor g of image b in pixels, from the reg
// maps lv (A anchors); 0 outside [0, A); NaN as CANON_NAN, and CANON_NAN
// where the flags (the image's row of fl's layout, or nullptr) name the
// side non-finite.
template <typename T, bool VEC>
__device__ __forceinline__ float dfl_side(const DecodeLevels& lv, int A, int b, int g, int side,
                                          const int32_t* flag_row, DecodeFlags fl) {
  if (flag_row && __ldg(flag_row + fl.side(side))) return __uint_as_float(CANON_NAN);
  if (g < 0 || g >= A) return 0.0f;
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
  return canon_nan(__fmul_rn(side < 2 ? __fsub_rn(a, d) : __fadd_rn(a, d), cl.s));
}

// Whether the levels' rows allow 16-byte loads of T.
template <typename T>
inline bool rows_vec(const DecodeLevels& lv, int row_elems) {
  bool vec = (row_elems * sizeof(T)) % 16 == 0;
  for (int l = 0; l < lv.count; ++l) {
    vec = vec && reinterpret_cast<uintptr_t>(lv.x[l]) % 16 == 0 && (lv.ld[l] * sizeof(T)) % 16 == 0 &&
          (lv.sb[l] * sizeof(T)) % 16 == 0;
  }
  return vec;
}

}  // namespace decode_detail
