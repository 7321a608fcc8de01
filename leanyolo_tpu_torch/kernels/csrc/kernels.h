// Launchers of the port's CUDA kernels, with a plain C++ interface: no
// PyTorch header reaches nvcc. Each launches on `stream` and returns the
// first CUDA error it met while configuring the launch (cudaSuccess if
// none); the caller checks the launch itself right after.
#pragma once

#include <cuda_runtime_api.h>
#include <cstddef>
#include <cstdint>

// Fused stem (stem.cu, stem_tc.cu). x [B,H,W,3] uint8 (x_u8) or the
// activation type; out [B,H/4,W/4,c1]; (c0, c1) one of STEM_WIDTHS; H, W %
// 32 == 0.
// The (c0, c1) the stem is compiled for: backbone cv0/cv1 of the six YOLOv10
// sizes n, s, m, b and l, x (models/yolov10/config.py; tests/test_torch_stem.py
// holds this list to the configs).
#define STEM_WIDTHS(X) X(16, 32) X(32, 64) X(48, 96) X(64, 128) X(80, 160)
// launch_stem, the fp32 route: w0 [3,3,3,c0] and w1 [3,3,c0,c1] HWIO, b0
// [c0], b1 [c1], out, and float x, all fp32.
cudaError_t launch_stem(const void* x, bool x_u8, const void* w0, const void* b0, const void* w1,
                        const void* b1, void* out, int B, int H, int W, int c0, int c1, cudaStream_t stream);
// launch_stem_tc, the bf16 tensor-core route: w0p [3, c0/16, 32, 8] and w1p
// [9*c0/16, c1/16, 32, 8], the mma.sync B fragments of kernels/stem.py
// pack_weights; b0, b1, out and a non-uint8 x bf16; x, w0p, w1p and out
// 16-byte aligned.
cudaError_t launch_stem_tc(const void* x, bool x_u8, const void* w0p, const void* b0, const void* w1p,
                           const void* b1, void* out, int B, int H, int W, int c0, int c1, cudaStream_t stream);

// Depthwise 7x7, pad 3, + bias + SiLU (dw7x7.cu). x, out [B,H,W,C] dense;
// w [49,C]; b [C]; all bf16 (bf16) or fp32. Any B, H, W, C.
cudaError_t launch_dw7x7(const void* x, const void* w, const void* b, void* out, int B, int H, int W, int C,
                         bool bf16, cudaStream_t stream);

// Exact per-row top-k (topk.cu). x [rows, n] bf16 or fp32; vals [rows, k]
// in x's type; idx [rows, k] int32; 1 <= k <= n. scratch: at least
// topk_scratch_bytes(rows, n, k, bf16) bytes of device memory, 16-byte
// aligned (the winners' keys on their way to being ordered).
size_t topk_scratch_bytes(int rows, int n, int k, bool bf16);
cudaError_t launch_topk(const void* x, int rows, int n, int k, bool canon_zero, bool bf16, void* vals,
                        int32_t* idx, void* scratch, cudaStream_t stream);

// Backward of the k x k stride-1 "same" max pool (mpbwd.cu). x, dy, dx
// [B,H,W,C], all bf16 (bf16) or fp32; k odd, 1 <= k <= 15. vec: the
// 16-byte route (C a multiple of 8 bf16 or 4 fp32 values; x, dy and dx
// 16-byte aligned), else the general route.
cudaError_t launch_mpbwd(const void* x, const void* dy, void* dx, int B, int H, int W, int C, int k, bool bf16,
                         bool vec, cudaStream_t stream);

// Matrix product out[rows, N] = x[rows, K] @ w[K, N] (matmul.cu), fp32 sum,
// then the folded conv's epilogue: rounded, + bias[N] rounded (bias may be
// nullptr), SiLU rounded (act). x rows lda elements apart; out dense; all
// bf16 (bf16) or fp32.
// launch_bmm, the mma.sync route: w row-major [K, N].
cudaError_t launch_bmm(const void* x, const void* w, const void* bias, void* out, int rows, int K, int N,
                       long long lda, bool act, bool bf16, cudaStream_t stream);
// launch_bmm_wgmma, the TMA + wgmma route (bf16 only): w K-major, element
// (k, n) at w[n * ldb + k]; K, N, lda, ldb multiples of 8, x, w and out
// 16-byte aligned; bn the tile width (64, 80 when N <= 80, or 128); pairs
// the consumer pairs of a CTA (1 or 2); act needs a bias.
cudaError_t launch_bmm_wgmma(const void* x, const void* w, long long ldb, const void* bias, void* out, int rows,
                             int K, int N, long long lda, bool act, int bn, int pairs, cudaStream_t stream);

// Dense 3x3 SAME conv 32 -> 32 + bias + SiLU as a 2x2 conv over the
// space-to-depth form (s2dconv.cu). x [B,H,W,32] with batch stride sb and
// pixel stride sp (elements, multiples of 16 bytes, channels contiguous);
// bias [32]; out [B,H,W,32] dense. taps: bit 2t is tap t's row offset, bit
// 2t+1 its column offset.
// launch_s2dconv, the fp32 route: w [4 taps, 128, 128] S2D weights, row-major.
cudaError_t launch_s2dconv(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                           long long sb, long long sp, int taps, cudaStream_t stream);
// launch_s2dconv_wgmma, the bf16 wgmma route: wk [128 N, 512 K], the same
// weights K-major (element (k, n) of the [512, 128] matrix at wk[n * 512 + k]);
// x, wk and out 16-byte aligned.
cudaError_t launch_s2dconv_wgmma(const void* x, const void* wk, const void* bias, void* out, int B, int H, int W,
                                 long long sb, long long sp, int taps, cudaStream_t stream);

// Per-row (max, first argmax) over the last dim (argmax.cu), for up to
// ARGMAX_MAX_LEVELS levels in one launch. Level l: x[l] [B, rows_l, n]
// with unit stride in n, rows ld[l] and images sb[l] elements apart; its
// rows land at columns start[l] .. start[l + 1] of the [B, start[count]]
// outputs. All levels bf16 (bf16) or fp32. canon_zero: lax's total order
// of the bits, -0.0 tying +0.0 (the packed route); else a NaN first, then
// the largest number, -0.0 below +0.0 in the max, and the index the first
// holding it. vals: bf16 (vals_bf16) or fp32; idx int32. reg (or nullptr):
// the same levels' reg maps [B, rows_l, 64] in x's type; with it, the
// DecodeFlags of the maps (nc = n; zeroed here by a memset, then set by
// integer atomics; kernels/argmax.py flags_plain).
#define ARGMAX_MAX_LEVELS 4
struct ArgmaxLevels {
  const void* x[ARGMAX_MAX_LEVELS];
  long long sb[ARGMAX_MAX_LEVELS];
  long long ld[ARGMAX_MAX_LEVELS];
  int start[ARGMAX_MAX_LEVELS + 1];
  int count;
};
cudaError_t launch_argmax(const ArgmaxLevels& lv, const ArgmaxLevels* reg, int B, int n, bool bf16, bool canon_zero,
                          void* vals, bool vals_bf16, int32_t* idx, int32_t* flags, cudaStream_t stream);

// Exact greedy NMS over score-sorted candidates, one CTA an image (nms.cu).
// boxes [B, n, 4] xyxy; scores and cls [B, n]; all bf16 (bf16) or fp32
// (scores needed by use_conf or num, cls by class_wise or num; else
// nullptr); boxes 8-byte (bf16) or 16-byte (fp32) aligned. valid [B, n]
// uint8 (or bool) or nullptr (all valid). A candidate is valid where valid
// says so and, with use_conf, its score > conf_thresh; invalid ones never
// survive and never suppress. class_wise: IoUs of boxes shifted by cls *
// group_offset. bf16: the shift, the areas and the IoU round each operation
// to bf16 (JAX's arithmetic on bf16 arrays); thresholds and the offset come
// rounded to the inputs' type by the caller.
// Outputs: keep [B, n] of 0/1 bytes (uint8 or bool), or nullptr; num [B]
// int32 with dets [B, max_det, 6] (the first min(kept, max_det, n)
// survivors' [box, score, cls] in rank order, zero rows after), or
// nullptr: the compaction stops once its slots are filled. scratch:
// nms_scratch_bytes(B, n) bytes of device memory, 4-byte aligned; none (0)
// unless n is past 1.8 million, where the dead bits leave shared memory.
size_t nms_scratch_bytes(int B, int n);
cudaError_t launch_nms(const void* boxes, const void* scores, const void* cls, const uint8_t* valid, int B, int n,
                       float iou_thresh, bool use_conf, float conf_thresh, bool class_wise, float group_offset,
                       uint8_t* keep, float* dets, int32_t* num, int max_det, bool bf16, void* scratch,
                       cudaStream_t stream);

// The decode's per-anchor kernels (decode.cu, topk.cu), over up to
// DECODE_MAX_LEVELS levels of head maps. Level l: x[l] [B, rows_l, n] with
// unit stride in n,
// rows ld[l] and images sb[l] elements apart, its anchors the global indices
// start[l] .. start[l + 1] (start[0] = 0), its rows w[l] cells wide at
// stride[l] pixels; all levels bf16 (bf16) or fp32.
#define DECODE_MAX_LEVELS 4
struct DecodeLevels {
  const void* x[DECODE_MAX_LEVELS];
  long long sb[DECODE_MAX_LEVELS];
  long long ld[DECODE_MAX_LEVELS];
  int start[DECODE_MAX_LEVELS + 1];
  int w[DECODE_MAX_LEVELS];
  float stride[DECODE_MAX_LEVELS];
  int count;
};
// The decodes' per-image non-finite flags, written by launch_argmax and read
// by launch_dfl_boxes and launch_topk_decode (kernels/flags.py holds the same
// layout): int32 [B, 3 nc + 4], a row an image over the levels' A anchors.
// For class column c: lo(c) = A - the first anchor whose logit in c is not
// finite (0: none), hi(c) = 1 + the last, nan_bits(c) = the largest of
// their NaN bits as fp32 with the quiet bit set, read unsigned (0: none).
// For box side s (l, t, r, b): side(s) = 1 where some anchor's 16 bins hold
// a NaN or +inf or are all -inf.
#if defined(__CUDACC__)
#define DECODE_FLAGS_FN __host__ __device__ __forceinline__
#else
#define DECODE_FLAGS_FN inline
#endif
struct DecodeFlags {
  int nc;
  DECODE_FLAGS_FN long long width() const { return 3LL * nc + 4; }
  DECODE_FLAGS_FN int lo(int c) const { return c; }
  DECODE_FLAGS_FN int hi(int c) const { return nc + c; }
  DECODE_FLAGS_FN int nan_bits(int c) const { return 2 * nc + c; }
  DECODE_FLAGS_FN int side(int s) const { return 3 * nc + s; }
  // Image b's row (nullptr where flags is).
  template <typename P>
  DECODE_FLAGS_FN P* row(P* flags, int b) const {
    return flags ? flags + b * width() : nullptr;
  }
  // The class count of a row of w words, or -1 where none gives it.
  static DECODE_FLAGS_FN long long classes(long long w) { return w >= 4 && (w - 4) % 3 == 0 ? (w - 4) / 3 : -1; }
};

// launch_dfl_boxes (decode.cu): the levels' rows are the reg maps, n = 4 *
// 16 (reg_max 16, the four sides' bins in order l, t, r, b); out [B, k, 4]
// fp32, the xyxy pixel box of anchor anchor_idx[b, j] (int32 [B, k]); NaN
// written as 0x7FC00000. flags (or nullptr): launch_argmax's DecodeFlags of
// nc classes; a side flagged non-finite is NaN in every box of its image.
cudaError_t launch_dfl_boxes(const DecodeLevels& lv, int B, const int32_t* anchor_idx, int k, const int32_t* flags,
                             int nc, bool bf16, float* out, cudaStream_t stream);

// The top-k decode's second stage in one launch (topk.cu): the top k of the
// [k1, nc] (anchor, class) pairs of anchor_idx [B, k1] (int32, global
// anchors of the levels), their class logits read from cls's levels as
// the JAX package's one-hot dot gathers them (-0.0 as +0.0; flags,
// launch_argmax's DecodeFlags: a column non-finite at an anchor other than
// the row's own alone is NaN), ranked as launch_topk ranks (bf16 pairs on 32-bit keys
// up to 32768, else 64-bit) -> dets [B, k, 6] fp32: the winner's anchor's
// box from reg's levels (launch_dfl_boxes, the same flags), 1 / (1 +
// exp(-logit)) and the class pair % nc. cls and reg: the same levels'
// class maps [B, rows_l, nc] and reg maps [B, rows_l, 64], all bf16 (bf16) or
// fp32. scratch: topk_scratch_bytes(B, k1 * nc, k, bf16) bytes.
struct TopkDecodeArgs {
  DecodeLevels cls, reg;
  const int32_t* anchor_idx;
  int k1, nc;
  const int32_t* flags;
  float* dets;
};
cudaError_t launch_topk_decode(const TopkDecodeArgs& args, int B, int k, bool canon_zero, bool bf16, void* scratch,
                               cudaStream_t stream);

// The training BatchNorm's one-pass batch moments (bnstats.cu). y [N, C, H,
// W] bf16 (bf16) or fp32, size {N, C, H, W} and stride (elements) as the
// tensor has them. vec: the 16-byte route (y channels_last and dense, C a
// multiple of 8 bf16 or 4 fp32 values, y and dy 16-byte aligned), else the
// general route (any strides).
// launch_bn_moments: s1, s2 fp32 [C] = sum y, sum y^2 over N, H, W in the
// fixed order of kernels/bnstats.py; slots G, a power of two up to 256
// (slots of 32 lanes; bnstats.py::slots); partials: 2 * G * C floats of
// scratch, 16-byte aligned; tickets: n_tickets unsigned counters, at
// least one a channel tile (C is always enough), 0 before the launch and 0
// again after it, used by one stream's launches only.
cudaError_t launch_bn_moments(const void* y, const int* size, const long long* stride, int slots, bool bf16, bool vec,
                              float* partials, unsigned* tickets, int n_tickets, float* s1, float* s2,
                              cudaStream_t stream);
// launch_bn_moments_bwd: dy = g_s1[c] + (2 y) g_s2[c] (fp32, rounded after the
// product and the sum) cast to y's type; g_s1, g_s2 fp32 [C]; dy by dy_stride.
cudaError_t launch_bn_moments_bwd(const void* y, const float* g_s1, const float* g_s2, void* dy, const int* size,
                                  const long long* y_stride, const long long* dy_stride, bool bf16, bool vec,
                                  cudaStream_t stream);

// The task-aligned assignment of the training loss (tal.cu), two kernels
// (kernels/tal.py says what each computes): launch_tal_candidates, a
// cluster of CTAs an image, writes winners [B, N, TAL_MAX_K] int32 (the first k of a row, in
// rank order; a padded row's only in check mode) and has_any [B, N] 0/1
// bytes; launch_tal_targets, a thread an anchor, reads them and writes the
// outputs. scores: pd_scores [B, A, C] fp32 logits, unit stride in C,
// element (b, a, c) at b * score_sb + a * score_sa + c; pd [B, A, 4] and gt
// [B, N, 4] fp32 xyxy, dense and 16-byte aligned; anc [A, 2] fp32 dense;
// labels [B, N] int32; mask [B, N] 0/1 bytes. k: the winners of a row, at
// most TAL_MAX_K and below A, unless all_members (k >= A: every anchor a
// member). The alignment is s ** 0.5 (sqrt) * CIoU ** beta (powf, beta =
// 6 at run time, as torch's kernel takes it). eps: has_any's threshold; cv:
// float(4 / pi ** 2). carry: [B, N, TAL_MAX_K] 64-bit keys of scratch where
// A > TAL_CLUSTER * TAL_MAX_CHUNK (the candidates kernel then takes the
// anchors in passes and carries each row's winners across them), else
// nullptr. overlaps and align [B, N, A]
// fp32, or nullptr: with them (check mode) the candidates kernel writes every
// row's CIoU and alignment. Outputs of the targets kernel, dense: out_labels
// and out_idx [B, A] int32, out_bboxes [B, A, 4] fp32 (16-byte aligned),
// out_scores [B, A, nc] fp32 (16-byte aligned), out_fg [B, A] 0/1 bytes.
// B, N, A >= 1; B < 2^16.
#define TAL_MAX_K 16
// The candidates kernel: a cluster of TAL_CLUSTER CTAs an image, each
// staging A / TAL_CLUSTER anchors, at most TAL_MAX_CHUNK at a time: above
// A = 48,128 in passes of that many.
#define TAL_CLUSTER 8
#define TAL_MAX_CHUNK 6016
struct TalArgs {
  const float* scores;
  long long score_sb, score_sa;
  const float* pd;
  const float* anc;
  const int32_t* labels;
  const float* gt;
  const uint8_t* mask;
  int B, N, A, C, nc, k;
  bool all_members;
  float beta, eps, cv;
  int32_t* winners;
  uint8_t* has_any;
  unsigned long long* carry;
  float* overlaps;
  float* align;
  int32_t* out_labels;
  float* out_bboxes;
  float* out_scores;
  uint8_t* out_fg;
  int32_t* out_idx;
};
cudaError_t launch_tal_candidates(const TalArgs& args, cudaStream_t stream);
cudaError_t launch_tal_targets(const TalArgs& args, cudaStream_t stream);
