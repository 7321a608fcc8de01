// The task-aligned assignment (TAL) of the training loss, in two kernels:
// K7 (the pairwise CIoU and the alignment metric) and K6 (each GT's top-k
// set of anchors).
//
// Replaces the hand-shaped lax program of the JAX package's
// leanyolo_tpu/ops/tal.py:47 task_aligned_assign, with ops/boxes.py:49
// box_ciou_pairwise and ops/topk.py:113 topk_membership: the [B, N, A]
// CIoU, class-score, alignment and membership tensors, the one-hot class
// gather and the one-hot GT-row gather, the k rounds of argmax + mask. Here
// no [B, N, A] tensor reaches device memory (kernels/tal.py, whose plain
// version computes the same in torch operations in the same two passes).
//
// tal_candidates_kernel: one CTA a GT row (b, n); a padded row (mask_gt
// false) writes has_any = 0 and exits, since no anchor of it can be claimed.
// Its threads take the anchors a = t, t + 256, ...: the inside test (each of
// the anchor's four distances to the box's sides > 1e-9), the CIoU of the GT
// box against the predicted box, sigmoid(pd_scores[b, a, max(label, 0)])
// (one logit gathered, none for a label >= C, whose score is 0), and align =
// clamp(s, 0, 1) ** 0.5 * clamp(ciou, 0, 1) ** 6 * inside. Each thread
// keeps its k best anchors in registers as 64-bit keys, (align's order-
// preserving bits, -0.0 as +0.0, NaN above everything) << 32 | ~a, so a key
// is unique and the larger key is the larger value, then the lower index:
// torch.argmax's and lax.top_k's order. k rounds of a block maximum then
// give the row's winners in that order, the thread holding each one dropping
// it; has_any = the best value > eps (false where it is NaN, as amax then
// is). With k >= A every anchor is a member and only has_any is needed. A
// check-only flag writes the row's CIoU and align (every row, padded ones
// too) so a caller can hold them to the plain version's bits.
//
// tal_targets_kernel: one thread an anchor (b, a). GT n claims the anchor
// when mask_gt[b, n], the anchor is inside GT n and it is in n's set (its
// winners or, where has_any is false, anchor 0). One claim: that GT. More:
// the GT of highest CIoU over all N slots, padded ones included (their
// boxes compete, as overlaps.argmax(dim=1) takes every slot), first
// occurrence, NaN the highest; the CIoU comes from the same device function
// as the first kernel's, so its bits are the same. None: slot 0 and no
// foreground. It writes the label (max(label, 0)), the GT box, the slot and
// the foreground flag, then the CTA writes its anchors' rows of one-hot
// class scores (zeros where there is no foreground, and for a label >=
// num_classes), 16 bytes a thread where the rows allow.
//
// Rounding: the plain version on the card rounds after every torch
// operation, so each operation here is one IEEE operation, with
// __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn (the build leaves --fmad on);
// torch.maximum, torch.minimum, clamp and clamp_min as torch's CUDA
// kernels compute them (NaN passes, else fmaxf/fminf); atanf, expf and
// powf are the full-precision ones; a tensor to a scalar power takes
// torch's route for that exponent (** 0.5 is sqrt, ** 6 is powf, the
// exponent a run-time value as in torch's kernel); sigmoid is 1 / (1 +
// expf(-x)). Every input of a CTA's row comes from one image: an image's
// result does not depend on the rest of the batch, and no floating-point
// atomic is used.
//
// Bound on an H100: bytes (kernels/bounds.py::tal_work). At the training
// step's [32, 16, 8400] with 80 classes the outputs, [B, A, 80] fp32 scores
// most of them, are 95 MB: 0.03 ms at 3.35 TB/s; the gathered logits and
// the boxes are a few MB. The first kernel reads its logits one 4-byte value
// in a 32-byte sector at a stride of 4 * reg_max + C values, so about 8x the
// bytes the bound counts; the second writes every output once.
#include <cstdint>

#include "kernels.h"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// torch.maximum / torch.minimum on the card: a NaN operand passes, else
// fmaxf / fminf (::max, ::min).
__device__ __forceinline__ float tmax(float a, float b) { return a != a ? a : b != b ? b : fmaxf(a, b); }
__device__ __forceinline__ float tmin(float a, float b) { return a != a ? a : b != b ? b : fminf(a, b); }
// torch.clamp_min(v, lo) and torch.clamp(v, lo, hi) with scalar limits.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp01(float v) { return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f); }

struct Box {
  float x1, y1, x2, y2;
};

__device__ __forceinline__ Box load_box(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return Box{v.x, v.y, v.z, v.w};
}

// select_candidates_in_gts: min(ax - x1, ay - y1, x2 - ax, y2 - ay) > 1e-9
// (false where any is NaN, as the min then is).
__device__ __forceinline__ bool inside(float ax, float ay, const Box& g) {
  const float eps = static_cast<float>(1e-9);
  return __fsub_rn(ax, g.x1) > eps && __fsub_rn(ay, g.y1) > eps && __fsub_rn(g.x2, ax) > eps &&
         __fsub_rn(g.y2, ay) > eps;
}

// box_ciou_pairwise(b1 = a GT box, b2 = a predicted box), in ops/boxes.py's
// order of operations (`_iou_c2`, `_aspect_term`); cv = float(4 / pi ** 2).
__device__ __forceinline__ float ciou(const Box& b1, const Box& b2, float cv) {
  const float e9 = static_cast<float>(1e-9);
  const float x1 = tmax(b1.x1, b2.x1), y1 = tmax(b1.y1, b2.y1);
  const float x2 = tmin(b1.x2, b2.x2), y2 = tmin(b1.y2, b2.y2);
  const float inter = __fmul_rn(clamp_min(__fsub_rn(x2, x1), 0.0f), clamp_min(__fsub_rn(y2, y1), 0.0f));
  const float area1 = __fmul_rn(clamp_min(__fsub_rn(b1.x2, b1.x1), 0.0f), clamp_min(__fsub_rn(b1.y2, b1.y1), 0.0f));
  const float area2 = __fmul_rn(clamp_min(__fsub_rn(b2.x2, b2.x1), 0.0f), clamp_min(__fsub_rn(b2.y2, b2.y1), 0.0f));
  const float uni = __fadd_rn(__fsub_rn(__fadd_rn(area1, area2), inter), e9);
  const float iou = __fdiv_rn(inter, uni);
  const float cw = clamp_min(__fsub_rn(tmax(b1.x2, b2.x2), tmin(b1.x1, b2.x1)), 0.0f);
  const float ch = clamp_min(__fsub_rn(tmax(b1.y2, b2.y2), tmin(b1.y1, b2.y1)), 0.0f);
  const float c2 = __fadd_rn(__fadd_rn(__fmul_rn(cw, cw), __fmul_rn(ch, ch)), e9);
  const float b1cx = __fmul_rn(__fadd_rn(b1.x1, b1.x2), 0.5f), b1cy = __fmul_rn(__fadd_rn(b1.y1, b1.y2), 0.5f);
  const float b2cx = __fmul_rn(__fadd_rn(b2.x1, b2.x2), 0.5f), b2cy = __fmul_rn(__fadd_rn(b2.y1, b2.y2), 0.5f);
  const float dx = __fsub_rn(b1cx, b2cx), dy = __fsub_rn(b1cy, b2cy);
  const float rho2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  const float w1 = clamp_min(__fsub_rn(b1.x2, b1.x1), e9), h1 = clamp_min(__fsub_rn(b1.y2, b1.y1), e9);
  const float w2 = clamp_min(__fsub_rn(b2.x2, b2.x1), e9), h2 = clamp_min(__fsub_rn(b2.y2, b2.y1), e9);
  const float da = __fsub_rn(atanf(__fdiv_rn(w2, h2)), atanf(__fdiv_rn(w1, h1)));
  const float v = __fmul_rn(cv, __fmul_rn(da, da));
  const float alpha = __fdiv_rn(v, __fadd_rn(__fadd_rn(__fsub_rn(1.0f, iou), v), e9));
  return clamp01(__fsub_rn(__fsub_rn(iou, __fdiv_rn(rho2, c2)), __fmul_rn(alpha, v)));
}

// A value's 32 order-preserving bits: larger value, larger key; -0.0 as
// +0.0; every NaN above +inf.
__device__ __forceinline__ uint32_t order_bits(float v) {
  if (v != v) return 0xFFFFFFFFu;
  const uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t k) {
  return k == 0xFFFFFFFFu ? __int_as_float(0x7FC00000) : __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a, unsigned long long b) { return a > b ? a : b; }
__device__ __forceinline__ unsigned long long umin64(unsigned long long a, unsigned long long b) { return a < b ? a : b; }

// The CTA's largest key (every thread gets it). red: WARPS + 1 words of
// shared memory; two barriers.
__device__ __forceinline__ unsigned long long block_max(unsigned long long v, unsigned long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) v = umax64(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? red[lane] : 0ull;
#pragma unroll
    for (int o = WARPS / 2; o; o >>= 1) v = umax64(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
    if (lane == 0) red[WARPS] = v;
  }
  __syncthreads();
  return red[WARPS];
}

__global__ void __launch_bounds__(THREADS) tal_candidates_kernel(TalArgs p) {
  __shared__ unsigned long long red[WARPS + 1];
  const int b = blockIdx.y, n = blockIdx.x;
  const long long row = static_cast<long long>(b) * p.N + n;
  const bool valid = p.mask[row] != 0;
  const bool check = p.overlaps != nullptr;
  if (!valid && !check) {
    if (threadIdx.x == 0) p.has_any[row] = 0;
    return;
  }
  const Box g = load_box(p.gt + row * 4);
  const int cls = max(p.labels[row], 0);
  const float* scores = p.scores + b * p.score_sb + cls;
  const float* pd = p.pd + static_cast<long long>(b) * p.A * 4;
  // Rounds of the block maximum: the k winners, or one (has_any) where every
  // anchor is a member or k is 0.
  const int rounds = p.all_members ? 1 : max(p.k, 1);

  unsigned long long best[TAL_MAX_K];
#pragma unroll
  for (int j = 0; j < TAL_MAX_K; ++j) best[j] = 0ull;  // below every key
  for (int a = threadIdx.x; a < p.A; a += THREADS) {
    const float ax = p.anc[2 * a], ay = p.anc[2 * a + 1];
    const bool in = valid && inside(ax, ay, g);
    const float o = ciou(g, load_box(pd + 4ll * a), p.cv);
    float s = 0.0f;
    if (cls < p.C) s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-scores[a * p.score_sa])));
    const float t = __fmul_rn(__fsqrt_rn(clamp01(s)), powf(clamp01(o), p.beta));  // s ** 0.5 * o ** 6, torch's routes
    const float al = __fmul_rn(t, in ? 1.0f : 0.0f);
    if (check) {
      p.overlaps[row * p.A + a] = o;
      p.align[row * p.A + a] = al;
    }
    unsigned long long key = (static_cast<unsigned long long>(order_bits(al)) << 32) | (0xFFFFFFFFu - a);
#pragma unroll
    for (int j = 0; j < TAL_MAX_K; ++j) {
      if (j < rounds) {  // insert: the list stays in descending order, its smallest key drops out
        const unsigned long long hi = umax64(best[j], key);
        key = umin64(best[j], key);
        best[j] = hi;
      }
    }
  }
  for (int r = 0; r < rounds; ++r) {
    const unsigned long long win = block_max(best[0], red);
    if (best[0] == win && win != 0ull) {  // keys are unique: one thread holds it
#pragma unroll
      for (int j = 0; j + 1 < TAL_MAX_K; ++j) best[j] = best[j + 1];
      best[TAL_MAX_K - 1] = 0ull;
    }
    if (threadIdx.x == 0) {
      if (r == 0) p.has_any[row] = valid && from_order_bits(static_cast<uint32_t>(win >> 32)) > p.eps;
      if (!p.all_members && r < p.k)
        p.winners[row * TAL_MAX_K + r] = win ? static_cast<int32_t>(0xFFFFFFFFu - static_cast<uint32_t>(win)) : -1;
    }
  }
}

__global__ void __launch_bounds__(THREADS) tal_targets_kernel(TalArgs p) {
  __shared__ int lab[THREADS];
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * THREADS, a = a0 + threadIdx.x;
  const long long ba = static_cast<long long>(b) * p.A + a;
  const long long r0 = static_cast<long long>(b) * p.N;
  int label = -1;
  if (a < p.A) {
    const float ax = p.anc[2 * a], ay = p.anc[2 * a + 1];
    int claims = 0, last = 0;
    for (int n = 0; n < p.N; ++n) {
      if (!p.mask[r0 + n] || !inside(ax, ay, load_box(p.gt + (r0 + n) * 4))) continue;
      bool member = false;
      if (!p.has_any[r0 + n]) {
        member = a == 0;
      } else if (p.all_members) {
        member = true;
      } else {
        const int32_t* w = p.winners + (r0 + n) * TAL_MAX_K;
        for (int j = 0; j < p.k; ++j) member |= w[j] == a;
      }
      if (member) {
        ++claims;
        last = n;
      }
    }
    int idx = claims == 1 ? last : 0;
    if (claims > 1) {  // the slot of highest CIoU, first occurrence, NaN the highest
      const Box pb = load_box(p.pd + ba * 4);
      float top = ciou(load_box(p.gt + r0 * 4), pb, p.cv);
      for (int n = 1; n < p.N; ++n) {
        const float o = ciou(load_box(p.gt + (r0 + n) * 4), pb, p.cv);
        if (top == top && (o != o || o > top)) {
          top = o;
          idx = n;
        }
      }
    }
    const Box t = load_box(p.gt + (r0 + idx) * 4);
    const int l = max(p.labels[r0 + idx], 0);
    p.out_labels[ba] = l;
    p.out_idx[ba] = idx;
    p.out_fg[ba] = claims > 0;
    *reinterpret_cast<float4*>(p.out_bboxes + ba * 4) = make_float4(t.x1, t.y1, t.x2, t.y2);
    if (claims > 0) label = l;
  }
  lab[threadIdx.x] = label;
  __syncthreads();
  // The CTA's rows of one-hot scores: one dense span of its anchors x nc.
  const int na = min(THREADS, p.A - a0);
  float* out = p.out_scores + (static_cast<long long>(b) * p.A + a0) * p.nc;
  if (p.nc % 4 == 0) {
    const int q = p.nc / 4;
    for (int e = threadIdx.x; e < na * q; e += THREADS) {
      const int i = e / q, c = 4 * (e - i * q), want = lab[i];
      reinterpret_cast<float4*>(out)[e] =
          make_float4(want == c ? 1.0f : 0.0f, want == c + 1 ? 1.0f : 0.0f, want == c + 2 ? 1.0f : 0.0f,
                      want == c + 3 ? 1.0f : 0.0f);
    }
  } else {
    for (int e = threadIdx.x; e < na * p.nc; e += THREADS) {
      const int i = e / p.nc;
      out[e] = lab[i] == e - i * p.nc ? 1.0f : 0.0f;
    }
  }
}

}  // namespace

cudaError_t launch_tal_candidates(const TalArgs& args, cudaStream_t stream) {
  tal_candidates_kernel<<<dim3(args.N, args.B), THREADS, 0, stream>>>(args);
  return cudaSuccess;
}

cudaError_t launch_tal_targets(const TalArgs& args, cudaStream_t stream) {
  tal_targets_kernel<<<dim3((args.A + THREADS - 1) / THREADS, args.B), THREADS, 0, stream>>>(args);
  return cudaSuccess;
}
