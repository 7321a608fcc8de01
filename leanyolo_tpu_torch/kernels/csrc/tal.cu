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
// tal_candidates_kernel: a cluster of TAL_CLUSTER (8) CTAs an image, CTA q
// of it a chunk of A / 8 anchors, staged once in shared memory with each
// predicted box's aspect angle (atanf once an anchor). A warp takes a GT row
// (the image's valid rows; every row in check mode) and walks the chunk, 32
// anchors at a time, 8 logits of a lane in flight; per (row, anchor): the
// inside test (each of the anchor's four distances to the box's sides >
// 1e-9), the CIoU of the GT box (its aspect angle once a row) against the
// predicted box, sigmoid(pd_scores[b, a, max(label, 0)]) (none for a label
// >= C, whose score is 0), and align = clamp(s, 0, 1) ** 0.5 * clamp(ciou,
// 0, 1) ** 6 * inside. Outside the box align is t * 0, which is +0.0
// unless t is NaN: where the logit is not NaN and both boxes are `tame`
// (finite, at most 1e18 in magnitude: ciou_at then gives a number in [0,
// 1]) the pair takes +0.0 without the chain; elsewhere, and in check mode,
// the full chain. Each lane keeps its k best anchors (a list of depth k,
// entered only by keys above its smallest) as 64-bit keys, (align's order-
// preserving bits, -0.0 as +0.0, NaN above everything) << 32 | ~a, so a key
// is unique and the larger key is the larger value, then the lower index:
// torch.argmax's and lax.top_k's order. k warp maxima give the chunk's
// winners of the row. After a cluster barrier, CTA i % 8 merges row i's 8 x k
// chunk winners from the CTAs' shared memory (distributed shared memory),
// one warp a row, k warp maxima again: the row's winners in rank order
// (keys are unique, so any exact merge gives them), and has_any = the best
// value > eps (false where it is NaN, as amax then is). A padded row writes
// has_any = 0: no anchor of it can be claimed. With k >= A every anchor is
// a member and only has_any is needed. A check-only flag writes every row's
// CIoU and align (padded ones too) so a caller can hold them to the plain
// version's bits.
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
// Bound on an H100 (kernels/bounds.py::tal_work): the larger of bytes and
// operations. At the training step's [32, 16, 8400] with 80 classes the
// outputs, [B, A, 80] fp32 scores most of them, are 95 MB: 0.03 ms at 3.35
// TB/s; the logits of each valid row's class and the boxes are a few MB.
// The candidates kernel reads a logit for every (valid row, anchor), one
// 4-byte value in a 32-byte sector at a stride of 4 * reg_max + C values;
// the chain of the pairs inside a box is its operations. The targets kernel
// writes every output once.
#include <cooperative_groups.h>

#include <cstdint>

#include "kernels.h"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;  // the targets kernel

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

// atanf(w / h) of a box, its widths clamped at 1e-9: the aspect term's
// angle, which `ciou_at` takes precomputed (the same function on the same
// input gives the same bits).
__device__ __forceinline__ float aspect_atan(const Box& b) {
  const float e9 = static_cast<float>(1e-9);
  return atanf(__fdiv_rn(clamp_min(__fsub_rn(b.x2, b.x1), e9), clamp_min(__fsub_rn(b.y2, b.y1), e9)));
}

// box_ciou_pairwise(b1 = a GT box, b2 = a predicted box), in ops/boxes.py's
// order of operations (`_iou_c2`, `_aspect_term`); cv = float(4 / pi ** 2);
// at1, at2: aspect_atan of b1 and b2.
__device__ __forceinline__ float ciou_at(const Box& b1, const Box& b2, float cv, float at1, float at2) {
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
  const float da = __fsub_rn(at2, at1);
  const float v = __fmul_rn(cv, __fmul_rn(da, da));
  const float alpha = __fdiv_rn(v, __fadd_rn(__fadd_rn(__fsub_rn(1.0f, iou), v), e9));
  return clamp01(__fsub_rn(__fsub_rn(iou, __fdiv_rn(rho2, c2)), __fmul_rn(alpha, v)));
}

__device__ __forceinline__ float ciou(const Box& b1, const Box& b2, float cv) {
  return ciou_at(b1, b2, cv, aspect_atan(b1), aspect_atan(b2));
}

// Every coordinate finite and at most 1e18 in magnitude. For two such boxes
// no step of ciou_at overflows or divides 0 by 0 (products at most 8e36;
// uni >= inter and 1 - iou >= 0, since rounding is monotone), so the CIoU
// is a number in [0, 1] and never NaN.
__device__ __forceinline__ bool tame(const Box& b) {
  const float m = 1e18f;
  return fabsf(b.x1) <= m && fabsf(b.y1) <= m && fabsf(b.x2) <= m && fabsf(b.y2) <= m;
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

// The warp's largest key (every lane gets it).
__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = umax64(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

// Inserts key into best[0 .. rounds), kept in descending order (its
// smallest key drops out); returns the new smallest kept key.
template <int KD>
__device__ __forceinline__ unsigned long long insert(unsigned long long (&best)[KD], unsigned long long key, int rounds) {
  unsigned long long low = 0ull;
#pragma unroll
  for (int j = 0; j < KD; ++j) {
    if (j < rounds) {
      const unsigned long long hi = umax64(best[j], key);
      key = umin64(best[j], key);
      best[j] = hi;
      low = best[j];
    }
  }
  return low;
}

// Pops the warp's largest key of best[0] over its lanes (keys are unique:
// one lane holds it) and returns it; 0 when every list is empty.
template <int KD>
__device__ __forceinline__ unsigned long long pop_max(unsigned long long (&best)[KD]) {
  const unsigned long long win = warp_max(best[0]);
  if (best[0] == win && win != 0ull) {
#pragma unroll
    for (int j = 0; j + 1 < KD; ++j) best[j] = best[j + 1];
    best[KD - 1] = 0ull;
  }
  return win;
}

constexpr int CAND_THREADS = 256;  // three CTAs an SM: 32 clusters of 8 are resident at once
constexpr int CAND_WARPS = CAND_THREADS / 32;
constexpr int STRIPE = 32;     // anchors dealt to the cluster's CTAs in turn
constexpr int ROW_GROUP = 64;  // rows whose chunk winners a CTA holds at once
constexpr int MERGE_KEYS = TAL_CLUSTER * TAL_MAX_K / 32;  // keys a lane takes in the cluster's merge
constexpr int BATCH = 8;       // anchors of a lane whose logits are loaded before they are used
constexpr int SCAN = 8;        // loads of a lane in flight in the NaN scan

// One anchor of the CTA's chunk, staged once: its predicted box, its centre,
// the box's aspect angle and whether the box is `tame`.
struct Anchor {
  float4 box;
  float ax, ay, at;
  int tame;
};

// A stripe of the CTA's chunk: the extremes of its anchors' centres and
// whether every anchor of it is `safe` (tame box, no NaN logit).
struct Stripe {
  float4 lo_hi;  // min x, min y, max x, max y
  int safe;
};

// No anchor of the stripe is inside g: one of inside()'s four tests fails
// at the stripe's extreme, so at each anchor (rounding is monotone).
__device__ __forceinline__ bool outside(const Stripe& s, const Box& g) {
  const float eps = static_cast<float>(1e-9);
  return __fsub_rn(s.lo_hi.z, g.x1) <= eps || __fsub_rn(s.lo_hi.w, g.y1) <= eps ||
         __fsub_rn(g.x2, s.lo_hi.x) <= eps || __fsub_rn(g.y2, s.lo_hi.y) <= eps;
}

// The anchor of a CTA's local index i: stripe i / 32 of the CTA is stripe
// q + TAL_CLUSTER * (i / 32) of the image.
__device__ __forceinline__ int anchor_of(int q, int i) {
  return (q + TAL_CLUSTER * (i / STRIPE)) * STRIPE + i % STRIPE;
}

// Sets nan_any[i] for each anchor i of the CTA (na of them) whose W words
// of class logits (W = C, or C / 4 16-byte vectors: T = float4) hold a NaN;
// a warp takes a stripe, lane e of it reading words e, e + 32, ... of the
// stripe's anchors, each anchor's words one dense span. Each writes 1, so
// the flags do not depend on the order.
template <typename T>
__device__ __forceinline__ void scan_nans(const float* scores, long long sa, int W, int q, int na, int* nan_any) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int step_a = 32 / W, step_w = 32 % W;  // e += 32 moves the (anchor, word) pair by these
  for (int s0 = warp * STRIPE; s0 < na; s0 += CAND_WARPS * STRIPE) {
    const int n = min(STRIPE, na - s0), total = n * W;
    const long long a0 = anchor_of(q, s0);
    int ai = lane / W, w = lane % W;
    for (int e0 = lane; e0 < total; e0 += SCAN * 32) {
      T v[SCAN];
      int at[SCAN];
#pragma unroll
      for (int u = 0; u < SCAN; ++u) {
        at[u] = e0 + u * 32 < total ? ai : -1;
        if (at[u] >= 0) v[u] = __ldg(reinterpret_cast<const T*>(scores + (a0 + ai) * sa) + w);
        ai += step_a;
        w += step_w;
        if (w >= W) {
          w -= W;
          ++ai;
        }
      }
#pragma unroll
      for (int u = 0; u < SCAN; ++u) {
        bool nan;
        if constexpr (sizeof(T) == 16) {
          nan = v[u].x != v[u].x || v[u].y != v[u].y || v[u].z != v[u].z || v[u].w != v[u].w;
        } else {
          nan = v[u] != v[u];
        }
        if (at[u] >= 0 && nan) nan_any[s0 + at[u]] = 1;
      }
    }
  }
}

// Stripe m's extremes and whether it is safe: every anchor's box tame and
// no NaN logit (a warp a stripe).
__device__ __forceinline__ void stripe_data(const Anchor* anc, const int* nan_any, int na, int mine, Stripe* stripe) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < mine; m += CAND_WARPS) {
    const int j = m * STRIPE + lane;
    const bool here = j < na;
    float x0 = here ? anc[j].ax : __int_as_float(0x7FFFFFFF), y0 = here ? anc[j].ay : __int_as_float(0x7FFFFFFF);
    float x1 = x0, y1 = y0;  // fminf / fmaxf pass over NaN: a NaN centre is inside no box
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      x0 = fminf(x0, __shfl_xor_sync(0xFFFFFFFFu, x0, o));
      y0 = fminf(y0, __shfl_xor_sync(0xFFFFFFFFu, y0, o));
      x1 = fmaxf(x1, __shfl_xor_sync(0xFFFFFFFFu, x1, o));
      y1 = fmaxf(y1, __shfl_xor_sync(0xFFFFFFFFu, y1, o));
    }
    const bool safe = __all_sync(0xFFFFFFFFu, !here || (anc[j].tame && !nan_any[j]));
    if (lane == 0) stripe[m] = Stripe{make_float4(x0, y0, x1, y1), safe};
  }
}

// The CTA's k best keys of GT row n over its anchors (list[rounds]), by one
// warp.
template <int KD>
__device__ __forceinline__ void row_winners(const TalArgs& p, int q, int b, int n, int na, int mine, int rounds,
                                            bool check, const Anchor* anc, const Stripe* stripe, const int* nan_any,
                                            unsigned long long* list) {
  const int lane = threadIdx.x % 32;
  const float* scores = p.scores + b * p.score_sb;
  const long long row = static_cast<long long>(b) * p.N + n;
  const bool valid = p.mask[row] != 0;
  const Box g = load_box(p.gt + row * 4);
  const int cls = max(p.labels[row], 0);
  const bool has_cls = cls < p.C, g_tame = tame(g);
  const float at1 = aspect_atan(g);
  unsigned long long best[KD];
#pragma unroll
  for (int j = 0; j < KD; ++j) best[j] = 0ull;  // below every key
  unsigned long long low = 0ull;                // keys above it enter the list
  // Warp-wide, stripe m: a whole stripe whose pairs are provably +0.0 (the
  // row valid, its box and the stripe safe, no anchor of the stripe inside)
  // is skipped after the first stripe (m >= 1): that stripe's 32 keys all
  // lie above any later +0.0 key (a lower index), and k <= 16, so no
  // skipped key is among the CTA's k best.
  for (int m0 = 0; m0 < mine; m0 += BATCH) {
    // Outside the box the alignment is t * 0: +0.0 wherever t is not NaN,
    // which holds where no logit of the anchor is NaN and both boxes are
    // tame (t is then in [0, 1]). Elsewhere, and in check mode, the pair
    // takes the full chain (`full`), its logit loaded first for the batch.
    unsigned in_bits = 0u, full_bits = 0u, skip_bits = 0u;
    float x[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int m = m0 + u, j = m * STRIPE + lane;
      x[u] = 0.0f;
      if (m < mine && !check && valid && g_tame && m >= 1 && stripe[m].safe && outside(stripe[m], g)) {
        skip_bits |= 1u << u;
      } else if (m < mine && j < na) {
        const Anchor& d = anc[j];
        const bool nan = nan_any[j];
        const bool in = valid && inside(d.ax, d.ay, g);
        const bool full = check || in || !(g_tame && d.tame && !nan);
        in_bits |= static_cast<unsigned>(in) << u;
        full_bits |= static_cast<unsigned>(full) << u;
        if (full && has_cls && !nan) x[u] = __ldg(scores + static_cast<long long>(anchor_of(q, j)) * p.score_sa + cls);
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int m = m0 + u, j = m * STRIPE + lane;
      if (m >= mine) break;
      if ((skip_bits >> u & 1u) || j >= na) continue;
      const int a = anchor_of(q, j);
      float al = 0.0f;
      if (full_bits >> u & 1u) {
        const Anchor& d = anc[j];
        const float o = ciou_at(g, Box{d.box.x, d.box.y, d.box.z, d.box.w}, p.cv, at1, d.at);
        // The GT class's sigmoid; NaN where any logit of the anchor is
        // (kernels/tal.py: JAX's one-hot contraction), 0 for a label >= C.
        const float s = nan_any[j] ? __int_as_float(0x7FFFFFFF)
                        : has_cls  ? __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x[u])))
                                   : 0.0f;
        const float t = __fmul_rn(__fsqrt_rn(clamp01(s)), powf(clamp01(o), p.beta));  // s ** 0.5 * o ** 6
        al = __fmul_rn(t, (in_bits >> u & 1u) ? 1.0f : 0.0f);
        if (check) {
          p.overlaps[row * p.A + a] = o;
          p.align[row * p.A + a] = al;
        }
      }
      const unsigned long long key = (static_cast<unsigned long long>(order_bits(al)) << 32) | (0xFFFFFFFFu - a);
      if (key > low) low = insert(best, key, rounds);
    }
  }
  for (int r = 0; r < rounds; ++r) {
    const unsigned long long win = pop_max(best);
    if (lane == 0) list[r] = win;
  }
}

// A CTA an (image b, TAL_CLUSTER-th of its anchors: stripes of 32 dealt in
// turn, so a box's anchors spread over the cluster), the image's TAL_CLUSTER
// CTAs one cluster. The CTA's anchors are staged first: each one's box data,
// and whether any of its C logits is NaN (every logit read once). The warps
// then take the rows to assign (the valid ones; every row in check mode)
// from a queue, one at a time, and the cluster's CTAs merge each row's chunk
// winners from their shared memory. KD >= rounds: the depth of a lane's list.
template <int KD>
__global__ void __launch_bounds__(CAND_THREADS, 3) tal_candidates_kernel(TalArgs p, int chunk, bool vec4) {
  extern __shared__ float4 dyn[];
  Anchor* anc = reinterpret_cast<Anchor*>(dyn);
  Stripe* stripe = reinterpret_cast<Stripe*>(anc + chunk);
  int* nan_any = reinterpret_cast<int*>(stripe + chunk / STRIPE);  // the anchor's logits hold a NaN
  __shared__ unsigned long long lists[ROW_GROUP][KD];  // this CTA's chunk winners of each row of the group
  __shared__ int rows[ROW_GROUP];
  __shared__ int count, next;
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank()), b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool check = p.overlaps != nullptr;
  // The CTA's stripes: q, q + TAL_CLUSTER, ...; the image's last one may be short.
  const int stripes = (p.A + STRIPE - 1) / STRIPE;
  const int mine = q < stripes ? (stripes - 1 - q) / TAL_CLUSTER + 1 : 0;
  const int na = mine * STRIPE - ((stripes - 1) % TAL_CLUSTER == q ? stripes * STRIPE - p.A : 0);
  const int rounds = p.all_members ? 1 : max(p.k, 1);  // the k winners, or one (has_any)
  const float* scores = p.scores + b * p.score_sb;

  for (int i = threadIdx.x; i < na; i += CAND_THREADS) {
    const int a = anchor_of(q, i);
    const Box pb = load_box(p.pd + (static_cast<long long>(b) * p.A + a) * 4);
    anc[i] = Anchor{make_float4(pb.x1, pb.y1, pb.x2, pb.y2), p.anc[2 * a], p.anc[2 * a + 1], aspect_atan(pb),
                    tame(pb)};
    nan_any[i] = 0;
  }
  if (q == 0 && !check) {  // a padded row claims nothing
    for (int n = threadIdx.x; n < p.N; n += CAND_THREADS)
      if (!p.mask[static_cast<long long>(b) * p.N + n]) p.has_any[static_cast<long long>(b) * p.N + n] = 0;
  }
  __syncthreads();
  if (vec4) {
    scan_nans<float4>(scores, p.score_sa, p.C / 4, q, na, nan_any);
  } else {
    scan_nans<float>(scores, p.score_sa, p.C, q, na, nan_any);
  }
  __syncthreads();
  stripe_data(anc, nan_any, na, mine, stripe);

  for (int n0 = 0; n0 < p.N; n0 += ROW_GROUP) {
    if (warp == 0) {  // the group's rows to assign, in order
      int c = 0;
      for (int h = 0; h < ROW_GROUP; h += 32) {
        const int n = n0 + h + lane;
        const bool take = n < p.N && (check || p.mask[static_cast<long long>(b) * p.N + n]);
        const unsigned m = __ballot_sync(0xFFFFFFFFu, take);
        if (take) rows[c + __popc(m & ((1u << lane) - 1u))] = n;
        c += __popc(m);
      }
      if (lane == 0) {
        count = c;
        next = 0;
      }
    }
    __syncthreads();  // also: the chunk and its stripes are staged
    for (;;) {  // rows from the queue, one a warp
      int i = 0;
      if (lane == 0) i = atomicAdd(&next, 1);
      i = __shfl_sync(0xFFFFFFFFu, i, 0);
      if (i >= count) break;
      row_winners<KD>(p, q, b, rows[i], na, mine, rounds, check, anc, stripe, nan_any, lists[i]);
    }
    cluster.sync();  // every chunk's winners of the group's rows are in the cluster's shared memory

    // Row i of the group is merged by CTA i % TAL_CLUSTER: lane e takes keys
    // e, e + 32, ... of the TAL_CLUSTER x rounds, then `rounds` warp maxima.
    for (int i = q + TAL_CLUSTER * warp; i < count; i += TAL_CLUSTER * CAND_WARPS) {
      const long long row = static_cast<long long>(b) * p.N + rows[i];
      unsigned long long best[MERGE_KEYS];
#pragma unroll
      for (int j = 0; j < MERGE_KEYS; ++j) best[j] = 0ull;
#pragma unroll
      for (int e = 0; e < MERGE_KEYS; ++e) {
        const int idx = lane + 32 * e;
        if (idx < TAL_CLUSTER * rounds)
          insert(best, *cluster.map_shared_rank(&lists[i][idx % rounds], idx / rounds), MERGE_KEYS);
      }
      for (int r = 0; r < rounds; ++r) {
        const unsigned long long win = pop_max(best);
        if (lane == 0) {
          if (r == 0) p.has_any[row] = p.mask[row] && from_order_bits(static_cast<uint32_t>(win >> 32)) > p.eps;
          if (!p.all_members && r < p.k)
            p.winners[row * TAL_MAX_K + r] = win ? static_cast<int32_t>(0xFFFFFFFFu - static_cast<uint32_t>(win)) : -1;
        }
      }
    }
    cluster.sync();  // the lists and rows are free again
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

// Dynamic shared memory an anchor of the chunk: its Anchor, its NaN flag and
// a 32nd of its stripe's Stripe.
constexpr int kAnchorBytes = sizeof(Anchor) + sizeof(int) + (sizeof(Stripe) + STRIPE - 1) / STRIPE;

template <int KD>
cudaError_t launch_candidates(const TalArgs& args, cudaStream_t stream) {
  const int chunk = ((args.A + STRIPE - 1) / STRIPE + TAL_CLUSTER - 1) / TAL_CLUSTER * STRIPE;
  auto kernel = tal_candidates_kernel<KD>;
  // Room for two CTAs an SM: the most shared memory, the least L1.
  static const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TAL_MAX_CHUNK * kAnchorBytes);
  static const cudaError_t carve =
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (set != cudaSuccess) return set;
  if (carve != cudaSuccess) return carve;
  if (chunk > TAL_MAX_CHUNK) return cudaErrorInvalidValue;
  // 16-byte loads of the logits where every anchor's span of C is 16-byte aligned.
  const bool vec4 = args.C % 4 == 0 && args.score_sa % 4 == 0 && args.score_sb % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(args.scores) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(TAL_CLUSTER, args.B);
  cfg.blockDim = dim3(CAND_THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(chunk) * (sizeof(Anchor) + sizeof(int)) + chunk / STRIPE * sizeof(Stripe);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = TAL_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args, chunk, vec4);
}

}  // namespace

cudaError_t launch_tal_candidates(const TalArgs& args, cudaStream_t stream) {
  const int rounds = args.all_members ? 1 : (args.k > 1 ? args.k : 1);
  if (rounds <= 1) return launch_candidates<1>(args, stream);
  if (rounds <= 2) return launch_candidates<2>(args, stream);
  if (rounds <= 4) return launch_candidates<4>(args, stream);
  if (rounds <= 8) return launch_candidates<8>(args, stream);
  if (rounds <= 10) return launch_candidates<10>(args, stream);  // one2many's k
  return launch_candidates<16>(args, stream);
}

cudaError_t launch_tal_targets(const TalArgs& args, cudaStream_t stream) {
  tal_targets_kernel<<<dim3((args.A + THREADS - 1) / THREADS, args.B), THREADS, 0, stream>>>(args);
  return cudaSuccess;
}
