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
// outputs. All levels bf16 (bf16) or fp32. canon_zero: -0.0 ties +0.0 (the
// packed route); else -0.0 ranks below +0.0 in the max and the index is the
// first equal to it as a number. vals: bf16 (vals_bf16) or fp32; idx int32.
#define ARGMAX_MAX_LEVELS 4
struct ArgmaxLevels {
  const void* x[ARGMAX_MAX_LEVELS];
  long long sb[ARGMAX_MAX_LEVELS];
  long long ld[ARGMAX_MAX_LEVELS];
  int start[ARGMAX_MAX_LEVELS + 1];
  int count;
};
cudaError_t launch_argmax(const ArgmaxLevels& lv, int B, int n, bool bf16, bool canon_zero, void* vals,
                          bool vals_bf16, int32_t* idx, cudaStream_t stream);

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
