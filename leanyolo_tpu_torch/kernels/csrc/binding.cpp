// PyTorch binding of the port's kernels: the one source that includes
// PyTorch's headers. It checks what the Python wrappers already checked
// (device, dtype, contiguity), launches on the current stream and checks
// the launch.
#include <torch/extension.h>
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>

#include <optional>
#include <tuple>
#include <vector>

#include "kernels.h"

namespace {

void check(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, ": expected a CUDA tensor");
  TORCH_CHECK(t.is_contiguous(), name, ": expected a contiguous tensor");
}

bool act_is_bf16(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.scalar_type() == at::kBFloat16 || t.scalar_type() == at::kFloat, name,
              ": expected bfloat16 or float32");
  return t.scalar_type() == at::kBFloat16;
}

void stem_args(const torch::Tensor& x, const torch::Tensor& out, int64_t c1, at::ScalarType act) {
  for (auto* p : {&x, &out}) check(*p, "stem");
  TORCH_CHECK(out.scalar_type() == act, "stem: out dtype");
  TORCH_CHECK(x.scalar_type() == at::kByte || x.scalar_type() == act, "stem: images must be uint8 or the activation dtype");
  TORCH_CHECK(x.dim() == 4 && x.size(3) == 3, "stem: images [B,H,W,3]");
  const int64_t H = x.size(1), W = x.size(2);
  TORCH_CHECK(H % 32 == 0 && W % 32 == 0, "stem: H, W % 32");
  TORCH_CHECK(out.dim() == 4 && out.size(0) == x.size(0) && out.size(1) == H / 4 && out.size(2) == W / 4 &&
                  out.size(3) == c1,
              "stem: out shape");
}

void stem(torch::Tensor x, torch::Tensor w0, torch::Tensor b0, torch::Tensor w1, torch::Tensor b1, torch::Tensor out) {
  for (auto* p : {&w0, &b0, &w1, &b1}) {
    check(*p, "stem");
    TORCH_CHECK(p->scalar_type() == at::kFloat, "stem: float32 weights");
  }
  const int c0 = w0.size(3), c1 = w1.size(3);
  stem_args(x, out, c1, at::kFloat);
  C10_CUDA_CHECK(launch_stem(x.data_ptr(), x.scalar_type() == at::kByte, w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
                             b1.data_ptr(), out.data_ptr(), x.size(0), x.size(1), x.size(2), c0, c1,
                             at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void stem_tc(torch::Tensor x, torch::Tensor w0p, torch::Tensor b0, torch::Tensor w1p, torch::Tensor b1,
             torch::Tensor out) {
  for (auto* p : {&w0p, &b0, &w1p, &b1}) {
    check(*p, "stem_tc");
    TORCH_CHECK(p->scalar_type() == at::kBFloat16, "stem_tc: bfloat16 weights");
  }
  const int c0 = b0.numel(), c1 = b1.numel();
  TORCH_CHECK(w0p.numel() == 3 * 16 * c0 && w1p.numel() == 9 * c0 * c1, "stem_tc: packed weight sizes");
  stem_args(x, out, c1, at::kBFloat16);
  C10_CUDA_CHECK(launch_stem_tc(x.data_ptr(), x.scalar_type() == at::kByte, w0p.data_ptr(), b0.data_ptr(),
                                w1p.data_ptr(), b1.data_ptr(), out.data_ptr(), x.size(0), x.size(1), x.size(2), c0,
                                c1, at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void dw7x7(torch::Tensor x, torch::Tensor w, torch::Tensor b, torch::Tensor out) {
  for (auto* p : {&x, &w, &b, &out}) check(*p, "dw7x7");
  const bool bf16 = act_is_bf16(x, "dw7x7 x");
  for (auto* p : {&w, &b, &out}) TORCH_CHECK(p->scalar_type() == x.scalar_type(), "dw7x7: dtype");
  TORCH_CHECK(x.dim() == 4 && out.sizes() == x.sizes(), "dw7x7: x, out [B,H,W,C]");
  const int C = x.size(3);
  TORCH_CHECK(w.numel() == 49 * C && b.numel() == C, "dw7x7: w [49,C], b [C]");
  C10_CUDA_CHECK(launch_dw7x7(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), x.size(0), x.size(1),
                              x.size(2), C, bf16, at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

std::tuple<torch::Tensor, torch::Tensor> topk(torch::Tensor x, int64_t k, bool canon_zero) {
  check(x, "topk");
  const bool bf16 = act_is_bf16(x, "topk x");
  TORCH_CHECK(x.dim() == 2, "topk: x [rows, n]");
  TORCH_CHECK(x.size(1) < (int64_t(1) << 31) && x.size(0) < (int64_t(1) << 31), "topk: rows and n below 2^31");
  const int rows = x.size(0), n = x.size(1);
  TORCH_CHECK(k >= 1 && k <= n, "topk: 1 <= k <= n");
  auto vals = torch::empty({rows, k}, x.options());
  auto idx = torch::empty({rows, k}, x.options().dtype(at::kInt));
  if (rows == 0) return {vals, idx};
  auto scratch = torch::empty({static_cast<int64_t>(topk_scratch_bytes(rows, n, static_cast<int>(k), bf16))},
                              x.options().dtype(at::kByte));
  C10_CUDA_CHECK(launch_topk(x.data_ptr(), rows, n, static_cast<int>(k), canon_zero, bf16, vals.data_ptr(),
                             idx.data_ptr<int32_t>(), scratch.data_ptr(), at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {vals, idx};
}

void mpbwd(torch::Tensor x, torch::Tensor dy, torch::Tensor dx, int64_t k, bool vec) {
  for (auto* p : {&x, &dy, &dx}) check(*p, "mpbwd");
  const bool bf16 = act_is_bf16(x, "mpbwd x");
  for (auto* p : {&dy, &dx}) TORCH_CHECK(p->scalar_type() == x.scalar_type(), "mpbwd: dtype");
  TORCH_CHECK(x.dim() == 4 && dy.sizes() == x.sizes() && dx.sizes() == x.sizes(), "mpbwd: x, dy, dx [B,H,W,C]");
  TORCH_CHECK(k % 2 == 1 && k >= 1 && k <= 15, "mpbwd: k odd, 1 <= k <= 15");
  C10_CUDA_CHECK(launch_mpbwd(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), x.size(0), x.size(1), x.size(2), x.size(3),
                              static_cast<int>(k), bf16, vec, at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

const void* bmm_bias(const std::optional<torch::Tensor>& bias, const torch::Tensor& x, int64_t N) {
  if (!bias) return nullptr;
  check(*bias, "bmm bias");
  TORCH_CHECK(bias->scalar_type() == x.scalar_type() && bias->numel() == N, "bmm: bias [N] in x's dtype");
  return bias->data_ptr();
}

void bmm(torch::Tensor x, torch::Tensor w, torch::Tensor out, std::optional<torch::Tensor> bias, int64_t rows,
         int64_t lda, bool act) {
  TORCH_CHECK(x.is_cuda() && x.stride(-1) == 1, "bmm: x must be a CUDA tensor with unit stride in K");
  for (auto* p : {&w, &out}) check(*p, "bmm");
  const bool bf16 = act_is_bf16(x, "bmm x");
  for (auto* p : {&w, &out}) TORCH_CHECK(p->scalar_type() == x.scalar_type(), "bmm: dtype");
  TORCH_CHECK(w.dim() == 2 && x.size(-1) == w.size(0), "bmm: w [K, N]");
  const int64_t K = w.size(0), N = w.size(1);
  TORCH_CHECK(out.numel() == rows * N && lda >= K && rows < (int64_t(1) << 31), "bmm: out [rows, N], lda >= K");
  C10_CUDA_CHECK(launch_bmm(x.data_ptr(), w.data_ptr(), bmm_bias(bias, x, N), out.data_ptr(), static_cast<int>(rows),
                            static_cast<int>(K), static_cast<int>(N), lda, act, bf16,
                            at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void bmm_wgmma(torch::Tensor x, torch::Tensor w, torch::Tensor out, std::optional<torch::Tensor> bias, int64_t rows,
               int64_t lda, bool act, int64_t bn, int64_t pairs) {
  TORCH_CHECK(x.is_cuda() && x.stride(-1) == 1, "bmm_wgmma: x must be a CUDA tensor with unit stride in K");
  TORCH_CHECK(w.is_cuda() && w.dim() == 2 && w.stride(0) == 1, "bmm_wgmma: w [K, N] K-major (unit stride in K)");
  check(out, "bmm_wgmma out");
  TORCH_CHECK(x.scalar_type() == at::kBFloat16 && w.scalar_type() == at::kBFloat16 &&
                  out.scalar_type() == at::kBFloat16,
              "bmm_wgmma: bfloat16 only");
  TORCH_CHECK(x.size(-1) == w.size(0), "bmm_wgmma: w [K, N]");
  const int64_t K = w.size(0), N = w.size(1);
  TORCH_CHECK(out.numel() == rows * N && lda >= K && w.stride(1) >= K && rows < (int64_t(1) << 31),
              "bmm_wgmma: out [rows, N], lda >= K, ldb >= K");
  C10_CUDA_CHECK(launch_bmm_wgmma(x.data_ptr(), w.data_ptr(), w.stride(1), bmm_bias(bias, x, N), out.data_ptr(),
                                  static_cast<int>(rows), static_cast<int>(K), static_cast<int>(N), lda, act,
                                  static_cast<int>(bn), static_cast<int>(pairs), at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void s2dconv_args(const torch::Tensor& x, const torch::Tensor& b, const torch::Tensor& out, int64_t taps,
                  at::ScalarType act) {
  TORCH_CHECK(x.is_cuda() && x.dim() == 4 && x.size(3) == 32 && x.stride(3) == 1 &&
                  x.stride(1) == x.size(2) * x.stride(2),
              "s2dconv: x [B,H,W,32], channels contiguous, pixels of a row evenly strided");
  for (auto* p : {&b, &out}) check(*p, "s2dconv");
  for (auto* p : {&x, &b, &out}) TORCH_CHECK(p->scalar_type() == act, "s2dconv: dtype");
  TORCH_CHECK(b.numel() == 32 && out.sizes() == x.sizes(), "s2dconv: b, out shapes");
  TORCH_CHECK(taps >= 0 && taps < 256, "s2dconv: taps, 8 bits");
}

void s2dconv(torch::Tensor x, torch::Tensor w, torch::Tensor b, torch::Tensor out, int64_t taps) {
  s2dconv_args(x, b, out, taps, at::kFloat);
  check(w, "s2dconv w");
  TORCH_CHECK(w.scalar_type() == at::kFloat && w.numel() == 4 * 128 * 128, "s2dconv: w [4,128,128] float32");
  C10_CUDA_CHECK(launch_s2dconv(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), x.size(0), x.size(1),
                                x.size(2), x.stride(0), x.stride(2), static_cast<int>(taps),
                                at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void s2dconv_wgmma(torch::Tensor x, torch::Tensor wk, torch::Tensor b, torch::Tensor out, int64_t taps) {
  s2dconv_args(x, b, out, taps, at::kBFloat16);
  check(wk, "s2dconv_wgmma wk");
  TORCH_CHECK(wk.scalar_type() == at::kBFloat16 && wk.dim() == 2 && wk.size(0) == 128 && wk.size(1) == 512,
              "s2dconv_wgmma: wk [128, 512] bfloat16 (K-major)");
  C10_CUDA_CHECK(launch_s2dconv_wgmma(x.data_ptr(), wk.data_ptr(), b.data_ptr(), out.data_ptr(), x.size(0),
                                      x.size(1), x.size(2), x.stride(0), x.stride(2), static_cast<int>(taps),
                                      at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}


void max_argmax(std::vector<torch::Tensor> levels, torch::Tensor vals, torch::Tensor idx, bool canon_zero) {
  TORCH_CHECK(!levels.empty() && levels.size() <= ARGMAX_MAX_LEVELS, "max_argmax: 1 to 4 levels");
  const torch::Tensor& x0 = levels[0];
  const bool bf16 = act_is_bf16(x0, "max_argmax x");
  TORCH_CHECK(x0.dim() == 3, "max_argmax: levels [B, rows, n]");
  const int64_t B = x0.size(0), n = x0.size(2);
  ArgmaxLevels lv{};
  lv.count = static_cast<int>(levels.size());
  int64_t a = 0;
  for (size_t l = 0; l < levels.size(); ++l) {
    const torch::Tensor& x = levels[l];
    TORCH_CHECK(x.is_cuda() && x.dim() == 3 && x.stride(2) == 1, "max_argmax: a level [B, rows, n] on the card, "
                "unit stride in n");
    TORCH_CHECK(x.scalar_type() == x0.scalar_type() && x.size(0) == B && x.size(2) == n,
                "max_argmax: levels differ in dtype, batch or n");
    lv.x[l] = x.data_ptr();
    lv.sb[l] = x.stride(0);
    lv.ld[l] = x.stride(1);
    lv.start[l] = static_cast<int>(a);
    a += x.size(1);
  }
  lv.start[lv.count] = static_cast<int>(a);
  for (auto* p : {&vals, &idx}) check(*p, "max_argmax out");
  const bool vals_bf16 = vals.scalar_type() == at::kBFloat16;
  TORCH_CHECK(vals_bf16 ? (bf16 && canon_zero) : vals.scalar_type() == at::kFloat,
              "max_argmax: vals bf16 (bf16 input, canon_zero) or float32");
  TORCH_CHECK(idx.scalar_type() == at::kInt, "max_argmax: idx int32");
  TORCH_CHECK(vals.dim() == 2 && vals.size(0) == B && vals.size(1) == a && idx.sizes() == vals.sizes(),
              "max_argmax: vals, idx [B, sum rows]");
  TORCH_CHECK(B * a < (int64_t(1) << 31) && n > 0 && n < (int64_t(1) << 31), "max_argmax: B * rows below 2^31, n > 0");
  C10_CUDA_CHECK(launch_argmax(lv, static_cast<int>(B), static_cast<int>(n), bf16, canon_zero, vals.data_ptr(),
                               vals_bf16, idx.data_ptr<int32_t>(), at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

const void* nms_input(const std::optional<torch::Tensor>& t, const torch::Tensor& boxes, const char* name) {
  if (!t) return nullptr;
  check(*t, name);
  TORCH_CHECK(t->scalar_type() == boxes.scalar_type() && t->dim() == 2 && t->size(0) == boxes.size(0) &&
                  t->size(1) == boxes.size(1),
              name, ": [B, n] in the boxes' dtype");
  return t->data_ptr();
}

std::tuple<torch::Tensor, torch::Tensor, torch::Tensor> nms(torch::Tensor boxes, std::optional<torch::Tensor> scores,
                                                            std::optional<torch::Tensor> cls,
                                                            std::optional<torch::Tensor> valid, double iou_thresh,
                                                            bool use_conf, double conf_thresh, bool class_wise,
                                                            double group_offset, bool want_keep, int64_t max_det) {
  check(boxes, "nms boxes");
  const bool bf16 = act_is_bf16(boxes, "nms boxes");
  TORCH_CHECK(boxes.dim() == 3 && boxes.size(2) == 4, "nms: boxes [B, n, 4]");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(boxes.data_ptr()) % (4 * boxes.element_size()) == 0,
              "nms: boxes aligned to a box");
  const int64_t B = boxes.size(0), n = boxes.size(1);
  TORCH_CHECK(B < (int64_t(1) << 31) && n < (int64_t(1) << 31), "nms: B and n below 2^31");
  const void* s = nms_input(scores, boxes, "nms scores");
  const void* c = nms_input(cls, boxes, "nms cls");
  const uint8_t* v = nullptr;
  if (valid) {
    check(*valid, "nms valid");
    TORCH_CHECK((valid->scalar_type() == at::kByte || valid->scalar_type() == at::kBool) && valid->dim() == 2 &&
                    valid->size(0) == B && valid->size(1) == n,
                "nms: valid [B, n] bool or uint8");
    v = static_cast<const uint8_t*>(valid->data_ptr());
  }
  TORCH_CHECK(!use_conf || s, "nms: use_conf needs scores");
  TORCH_CHECK(!class_wise || c, "nms: class_wise needs cls");
  TORCH_CHECK(want_keep || (s && c), "nms: the compaction needs scores and cls");
  TORCH_CHECK(max_det >= 0 && max_det < (int64_t(1) << 31), "nms: 0 <= max_det < 2^31");
  auto opts = boxes.options();
  auto keep = torch::empty({want_keep ? B : 0, n}, opts.dtype(at::kBool));
  // With no candidates the kernel does not run: zero rows and counts.
  auto dets = torch::empty({want_keep ? 0 : B, want_keep ? 0 : max_det, 6}, opts.dtype(at::kFloat));
  auto num = torch::empty({want_keep ? 0 : B}, opts.dtype(at::kInt));
  if (n == 0) dets.zero_(), num.zero_();
  const size_t scratch_bytes = nms_scratch_bytes(static_cast<int>(B), static_cast<int>(n));
  torch::Tensor scratch;  // only past 1.8 million candidates an image
  if (scratch_bytes) scratch = torch::empty({static_cast<int64_t>(scratch_bytes)}, opts.dtype(at::kByte));
  uint8_t* k = want_keep ? static_cast<uint8_t*>(keep.data_ptr()) : nullptr;  // bool: one 0/1 byte each
  C10_CUDA_CHECK(launch_nms(boxes.data_ptr(), s, c, v, static_cast<int>(B), static_cast<int>(n),
                            static_cast<float>(iou_thresh), use_conf, static_cast<float>(conf_thresh), class_wise,
                            static_cast<float>(group_offset), k, want_keep ? nullptr : dets.data_ptr<float>(),
                            want_keep ? nullptr : num.data_ptr<int32_t>(), static_cast<int>(max_det), bf16,
                            scratch_bytes ? scratch.data_ptr() : nullptr, at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {keep, dets, num};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("stem", &stem, "fused stem: conv3x3 s2 + bias + SiLU, twice (fp32)");
  m.def("stem_tc", &stem_tc, "fused stem on the tensor cores (bf16, packed weights)");
  m.def("dw7x7", &dw7x7, "depthwise 7x7 + bias + SiLU");
  m.def("topk", &topk, "exact per-row top-k: (values, int32 indices), allocated here");
  m.def("mpbwd", &mpbwd, "backward of the k x k stride-1 same max pool");
  m.def("bmm", &bmm, "matrix product with an fp32 sum and the folded conv epilogue (mma.sync)");
  m.def("bmm_wgmma", &bmm_wgmma, "matrix product with an fp32 sum and the folded conv epilogue (TMA + wgmma)");
  m.def("s2dconv", &s2dconv, "3x3 conv 32->32 + bias + SiLU over the space-to-depth form (fp32)");
  m.def("max_argmax", &max_argmax, "per-row (max, first argmax) of up to four levels, into [B, sum rows] outputs");
  m.def("nms", &nms, "exact greedy NMS over score-sorted candidates: (keep, dets, num), allocated here");
  m.def("s2dconv_wgmma", &s2dconv_wgmma, "3x3 conv 32->32 + bias + SiLU over the space-to-depth form (bf16, wgmma)");
}
