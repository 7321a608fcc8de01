// PyTorch binding of the port's kernels: the one source that includes
// PyTorch's headers. It checks what the Python wrappers already checked
// (device, dtype, contiguity), launches on the current stream and checks
// the launch.
#include <torch/extension.h>
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <optional>
#include <tuple>
#include <utility>
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

// y's sizes and strides for the bn_moments launchers; sizes must fit an int.
void bn_shape(const torch::Tensor& y, int* size, long long* stride, const char* name) {
  TORCH_CHECK(y.is_cuda() && y.dim() == 4, name, ": y must be a 4-D CUDA tensor");
  for (int i = 0; i < 4; ++i) {
    TORCH_CHECK(y.size(i) < (int64_t(1) << 31), name, ": size too large");
    size[i] = static_cast<int>(y.size(i));
    stride[i] = y.stride(i);
  }
}

bool bn_vec_ok(const torch::Tensor& t) {
  return t.is_contiguous(at::MemoryFormat::ChannelsLast) && t.size(1) % (16 / t.element_size()) == 0 &&
         reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0;
}

// bn_moments' ticket counters for the current device and stream, at least
// `need` of them: zeroed once, left at 0 by every launch, kept (never freed)
// for the process's life; launches on one stream never overlap.
torch::Tensor bn_tickets(const torch::Tensor& y, int64_t need) {
  static std::mutex mu;
  static auto* cache = new std::map<std::pair<int, cudaStream_t>, torch::Tensor>();
  const std::pair<int, cudaStream_t> key{y.get_device(), at::cuda::getCurrentCUDAStream().stream()};
  std::lock_guard<std::mutex> lock(mu);
  torch::Tensor& t = (*cache)[key];
  if (!t.defined() || t.numel() < need) t = torch::zeros({std::max<int64_t>(64, need)}, y.options().dtype(at::kInt));
  return t;
}

void bn_moments(torch::Tensor y, torch::Tensor partials, torch::Tensor s1, torch::Tensor s2, int64_t slots, bool vec) {
  int size[4];
  long long stride[4];
  bn_shape(y, size, stride, "bn_moments");
  const bool bf16 = act_is_bf16(y, "bn_moments y");
  for (auto* p : {&partials, &s1, &s2}) {
    check(*p, "bn_moments");
    TORCH_CHECK(p->scalar_type() == at::kFloat, "bn_moments: fp32 sums and partials");
  }
  TORCH_CHECK(reinterpret_cast<uintptr_t>(partials.data_ptr()) % 16 == 0, "bn_moments: partials 16-byte aligned");
  const int64_t C = y.size(1);
  TORCH_CHECK(slots >= 1 && slots <= 256 && (slots & (slots - 1)) == 0,
              "bn_moments: slots a power of two in [1, 256]");
  TORCH_CHECK(s1.numel() == C && s2.numel() == C, "bn_moments: s1, s2 [C]");
  TORCH_CHECK(partials.numel() >= 2 * slots * C, "bn_moments: partials too small");
  TORCH_CHECK(!vec || bn_vec_ok(y), "bn_moments: the 16-byte route needs y channels_last, dense and aligned");
  const torch::Tensor tickets = bn_tickets(y, C);  // a channel tile takes one; C is always enough
  C10_CUDA_CHECK(launch_bn_moments(y.data_ptr(), size, stride, static_cast<int>(slots), bf16, vec,
                                   partials.data_ptr<float>(), reinterpret_cast<unsigned*>(tickets.data_ptr<int32_t>()),
                                   static_cast<int>(tickets.numel()), s1.data_ptr<float>(), s2.data_ptr<float>(),
                                   at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void bn_moments_bwd(torch::Tensor y, torch::Tensor g_s1, torch::Tensor g_s2, torch::Tensor dy, bool vec) {
  int size[4];
  long long stride[4], dstride[4];
  bn_shape(y, size, stride, "bn_moments_bwd");
  const bool bf16 = act_is_bf16(y, "bn_moments_bwd y");
  for (auto* p : {&g_s1, &g_s2}) {
    check(*p, "bn_moments_bwd");
    TORCH_CHECK(p->scalar_type() == at::kFloat && p->numel() == y.size(1), "bn_moments_bwd: g_s1, g_s2 fp32 [C]");
  }
  TORCH_CHECK(dy.is_cuda() && dy.scalar_type() == y.scalar_type() && dy.sizes() == y.sizes(),
              "bn_moments_bwd: dy like y");
  for (int i = 0; i < 4; ++i) dstride[i] = dy.stride(i);
  TORCH_CHECK(!vec || (bn_vec_ok(y) && dy.strides() == y.strides() && bn_vec_ok(dy)),
              "bn_moments_bwd: the 16-byte route needs y and dy channels_last, dense and aligned");
  C10_CUDA_CHECK(launch_bn_moments_bwd(y.data_ptr(), g_s1.data_ptr<float>(), g_s2.data_ptr<float>(), dy.data_ptr(),
                                       size, stride, dstride, bf16, vec, at::cuda::getCurrentCUDAStream()));
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


ArgmaxLevels argmax_levels(const std::vector<torch::Tensor>& levels, const torch::Tensor& x0, int64_t n,
                           const char* name) {
  TORCH_CHECK(!levels.empty() && levels.size() <= ARGMAX_MAX_LEVELS, name, ": 1 to 4 levels");
  ArgmaxLevels lv{};
  lv.count = static_cast<int>(levels.size());
  int64_t a = 0;
  for (size_t l = 0; l < levels.size(); ++l) {
    const torch::Tensor& x = levels[l];
    TORCH_CHECK(x.is_cuda() && x.dim() == 3 && x.stride(2) == 1, name, ": a level [B, rows, n] on the card, "
                "unit stride in n");
    TORCH_CHECK(x.scalar_type() == x0.scalar_type() && x.size(0) == x0.size(0) && x.size(2) == n, name,
                ": levels differ in dtype, batch or n");
    lv.x[l] = x.data_ptr();
    lv.sb[l] = x.stride(0);
    lv.ld[l] = x.stride(1);
    lv.start[l] = static_cast<int>(a);
    a += x.size(1);
  }
  lv.start[lv.count] = static_cast<int>(a);
  return lv;
}

// The decodes' non-finite flags (kernels.h DecodeFlags): int32 [B, 3 nc + 4]
// on the card, of nc classes (any where nc < 0). Returns nc.
int64_t check_decode_flags(const torch::Tensor& flags, int64_t B, int64_t nc, const char* name) {
  check(flags, name);
  const int64_t got = flags.dim() == 2 ? DecodeFlags::classes(flags.size(1)) : -1;
  TORCH_CHECK(flags.scalar_type() == at::kInt && flags.dim() == 2 && flags.size(0) == B && got >= 0 &&
                  (nc < 0 || got == nc),
              name, ": int32 [B, 3 nc + 4]");
  return got;
}

void max_argmax_into(const std::vector<torch::Tensor>& levels, const std::vector<torch::Tensor>* reg,
                     torch::Tensor vals, torch::Tensor idx, torch::Tensor* flags, bool canon_zero) {
  TORCH_CHECK(!levels.empty(), "max_argmax: 1 to 4 levels");
  const torch::Tensor& x0 = levels[0];
  const bool bf16 = act_is_bf16(x0, "max_argmax x");
  TORCH_CHECK(x0.dim() == 3, "max_argmax: levels [B, rows, n]");
  const int64_t B = x0.size(0), n = x0.size(2);
  const ArgmaxLevels lv = argmax_levels(levels, x0, n, "max_argmax");
  const int64_t a = lv.start[lv.count];
  ArgmaxLevels rl{};
  if (reg) {
    TORCH_CHECK(reg->size() == levels.size(), "max_argmax_flags: a reg map a level");
    const torch::Tensor& r0 = (*reg)[0];
    TORCH_CHECK(r0.scalar_type() == x0.scalar_type() && r0.dim() == 3 && r0.size(0) == B,
                "max_argmax_flags: reg maps [B, rows, 64] in the class maps' dtype");
    rl = argmax_levels(*reg, r0, 64, "max_argmax_flags reg");
    for (size_t l = 0; l < levels.size(); ++l)
      TORCH_CHECK((*reg)[l].size(1) == levels[l].size(1), "max_argmax_flags: a reg row a class row");
    check_decode_flags(*flags, B, n, "max_argmax_flags flags");
  }
  for (auto* p : {&vals, &idx}) check(*p, "max_argmax out");
  const bool vals_bf16 = vals.scalar_type() == at::kBFloat16;
  TORCH_CHECK(vals_bf16 ? (bf16 && canon_zero) : vals.scalar_type() == at::kFloat,
              "max_argmax: vals bf16 (bf16 input, canon_zero) or float32");
  TORCH_CHECK(idx.scalar_type() == at::kInt, "max_argmax: idx int32");
  TORCH_CHECK(vals.dim() == 2 && vals.size(0) == B && vals.size(1) == a && idx.sizes() == vals.sizes(),
              "max_argmax: vals, idx [B, sum rows]");
  TORCH_CHECK(B * a < (int64_t(1) << 31) && n > 0 && n < (int64_t(1) << 28), "max_argmax: B * rows below 2^31, n > 0");
  C10_CUDA_CHECK(launch_argmax(lv, reg ? &rl : nullptr, static_cast<int>(B), static_cast<int>(n), bf16, canon_zero,
                               vals.data_ptr(), vals_bf16, idx.data_ptr<int32_t>(),
                               reg ? flags->data_ptr<int32_t>() : nullptr, at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void max_argmax(std::vector<torch::Tensor> levels, torch::Tensor vals, torch::Tensor idx, bool canon_zero) {
  max_argmax_into(levels, nullptr, vals, idx, nullptr, canon_zero);
}

void max_argmax_flags(std::vector<torch::Tensor> levels, std::vector<torch::Tensor> reg, torch::Tensor vals,
                      torch::Tensor idx, torch::Tensor flags, bool canon_zero) {
  max_argmax_into(levels, &reg, vals, idx, &flags, canon_zero);
}

DecodeLevels decode_levels(const std::vector<torch::Tensor>& levels, const char* name, bool& bf16, int64_t& B,
                           int64_t& n) {
  TORCH_CHECK(!levels.empty() && levels.size() <= DECODE_MAX_LEVELS, name, ": 1 to 4 levels");
  const torch::Tensor& x0 = levels[0];
  bf16 = act_is_bf16(x0, name);
  TORCH_CHECK(x0.dim() == 3, name, ": levels [B, rows, n]");
  B = x0.size(0), n = x0.size(2);
  DecodeLevels lv{};
  lv.count = static_cast<int>(levels.size());
  int64_t a = 0;
  for (size_t l = 0; l < levels.size(); ++l) {
    const torch::Tensor& x = levels[l];
    TORCH_CHECK(x.is_cuda() && x.dim() == 3 && x.stride(2) == 1, name, ": a level [B, rows, n] on the card, unit "
                "stride in n");
    TORCH_CHECK(x.scalar_type() == x0.scalar_type() && x.size(0) == B && x.size(2) == n, name,
                ": levels differ in dtype, batch or n");
    lv.x[l] = x.data_ptr();
    lv.sb[l] = x.stride(0);
    lv.ld[l] = x.stride(1);
    lv.start[l] = static_cast<int>(a);
    a += x.size(1);
  }
  lv.start[lv.count] = static_cast<int>(a);
  TORCH_CHECK(a < (int64_t(1) << 31) && n > 0, name, ": fewer than 2^31 anchors, n > 0");
  return lv;
}

void check_idx(const torch::Tensor& idx, int64_t B, const char* name) {
  check(idx, name);
  TORCH_CHECK(idx.scalar_type() == at::kInt && idx.dim() == 2 && idx.size(0) == B && idx.size(1) > 0, name,
              ": int32 [B, k], k > 0");
}

void set_cells(DecodeLevels& lv, const std::vector<torch::Tensor>& levels, const std::vector<int64_t>& widths,
               const std::vector<double>& strides, const char* name) {
  TORCH_CHECK(widths.size() == levels.size() && strides.size() == levels.size(), name, ": a width and a stride a "
              "level");
  for (size_t l = 0; l < levels.size(); ++l) {
    TORCH_CHECK(widths[l] > 0 && levels[l].size(1) % widths[l] == 0, name, ": a level's rows are h x w cells");
    lv.w[l] = static_cast<int>(widths[l]);
    lv.stride[l] = static_cast<float>(strides[l]);
  }
}


void dfl_boxes(std::vector<torch::Tensor> levels, std::vector<int64_t> widths, std::vector<double> strides,
               torch::Tensor anchor_idx, std::optional<torch::Tensor> flags, torch::Tensor out) {
  bool bf16;
  int64_t B, n;
  DecodeLevels lv = decode_levels(levels, "dfl_boxes", bf16, B, n);
  TORCH_CHECK(n == 64, "dfl_boxes: reg rows of 4 x 16 bins");
  set_cells(lv, levels, widths, strides, "dfl_boxes");
  check_idx(anchor_idx, B, "dfl_boxes anchor_idx");
  const int64_t k = anchor_idx.size(1);
  const int64_t nc = flags ? check_decode_flags(*flags, B, -1, "dfl_boxes flags") : 0;
  check(out, "dfl_boxes out");
  TORCH_CHECK(out.scalar_type() == at::kFloat && out.dim() == 3 && out.size(0) == B && out.size(1) == k &&
                  out.size(2) == 4,
              "dfl_boxes: out float32 [B, k, 4]");
  TORCH_CHECK(4 * B * k < (int64_t(1) << 40), "dfl_boxes: output too large");
  C10_CUDA_CHECK(launch_dfl_boxes(lv, static_cast<int>(B), anchor_idx.data_ptr<int32_t>(), static_cast<int>(k),
                                  flags ? flags->data_ptr<int32_t>() : nullptr, static_cast<int>(nc), bf16,
                                  out.data_ptr<float>(), at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void topk_decode(std::vector<torch::Tensor> cls_levels, std::vector<torch::Tensor> reg_levels,
                 std::vector<int64_t> widths, std::vector<double> strides, torch::Tensor anchor_idx, int64_t k,
                 bool canon_zero, torch::Tensor flags, torch::Tensor out) {
  bool bf16, reg_bf16;
  int64_t B, nc, rb, rn;
  TopkDecodeArgs args{};
  args.cls = decode_levels(cls_levels, "topk_decode cls", bf16, B, nc);
  args.reg = decode_levels(reg_levels, "topk_decode reg", reg_bf16, rb, rn);
  TORCH_CHECK(reg_bf16 == bf16 && rb == B && rn == 64 && reg_levels.size() == cls_levels.size(),
              "topk_decode: reg maps [B, rows, 64] in the class maps' dtype, a level each");
  for (size_t l = 0; l < cls_levels.size(); ++l)
    TORCH_CHECK(reg_levels[l].size(1) == cls_levels[l].size(1), "topk_decode: a reg row a class row");
  set_cells(args.reg, reg_levels, widths, strides, "topk_decode");
  check_idx(anchor_idx, B, "topk_decode anchor_idx");
  const int64_t k1 = anchor_idx.size(1);
  TORCH_CHECK(k1 * nc < (int64_t(1) << 31) && k >= 1 && k <= k1 * nc, "topk_decode: 1 <= k <= k1 * nc < 2^31");
  check_decode_flags(flags, B, nc, "topk_decode flags");
  check(out, "topk_decode out");
  TORCH_CHECK(out.scalar_type() == at::kFloat && out.dim() == 3 && out.size(0) == B && out.size(1) == k &&
                  out.size(2) == 6,
              "topk_decode: out float32 [B, k, 6]");
  args.anchor_idx = anchor_idx.data_ptr<int32_t>();
  args.k1 = static_cast<int>(k1);
  args.nc = static_cast<int>(nc);
  args.flags = flags.data_ptr<int32_t>();
  args.dets = out.data_ptr<float>();
  const int n = static_cast<int>(k1 * nc);
  auto scratch = torch::empty({static_cast<int64_t>(topk_scratch_bytes(B, n, static_cast<int>(k), bf16))},
                              anchor_idx.options().dtype(at::kByte));
  C10_CUDA_CHECK(launch_topk_decode(args, static_cast<int>(B), static_cast<int>(k), canon_zero, bf16,
                                    scratch.data_ptr(), at::cuda::getCurrentCUDAStream()));
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

bool aligned16(const torch::Tensor& t) { return reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0; }

// The assignment's GT inputs (tal.cu) into `a`, checked against pd_bboxes
// [B, A, 4] and the anchors [A, 2].
void tal_inputs(TalArgs& a, const torch::Tensor& pd, const torch::Tensor& anc, const torch::Tensor& labels,
                const torch::Tensor& gt, const torch::Tensor& mask, int64_t k, bool all_members) {
  check(pd, "tal pd_bboxes");
  check(anc, "tal anc_points");
  check(labels, "tal gt_labels");
  check(gt, "tal gt_bboxes");
  check(mask, "tal mask_gt");
  for (const torch::Tensor* t : {&anc, &labels, &gt, &mask})
    TORCH_CHECK(t->device() == pd.device(), "tal: every tensor on one device");
  TORCH_CHECK(pd.scalar_type() == at::kFloat && pd.dim() == 3 && pd.size(2) == 4 && aligned16(pd),
              "tal: pd_bboxes float32 [B, A, 4], 16-byte aligned");
  const int64_t B = pd.size(0), A = pd.size(1), N = labels.dim() == 2 ? labels.size(1) : 0;
  TORCH_CHECK(anc.scalar_type() == at::kFloat && anc.dim() == 2 && anc.size(0) == A && anc.size(1) == 2,
              "tal: anc_points float32 [A, 2]");
  TORCH_CHECK(labels.scalar_type() == at::kInt && labels.dim() == 2 && labels.size(0) == B,
              "tal: gt_labels int32 [B, N]");
  TORCH_CHECK(gt.scalar_type() == at::kFloat && gt.dim() == 3 && gt.size(0) == B && gt.size(1) == N &&
                  gt.size(2) == 4 && aligned16(gt),
              "tal: gt_bboxes float32 [B, N, 4], 16-byte aligned");
  TORCH_CHECK((mask.scalar_type() == at::kBool || mask.scalar_type() == at::kByte) && mask.dim() == 2 &&
                  mask.size(0) == B && mask.size(1) == N,
              "tal: mask_gt bool [B, N]");
  TORCH_CHECK(B >= 1 && B < 65536 && N >= 1 && N < (int64_t(1) << 31) && A >= 1 && A < (int64_t(1) << 31),
              "tal: 1 <= B < 2^16, 1 <= N, A < 2^31");
  TORCH_CHECK(all_members || (k >= 0 && k <= TAL_MAX_K && k < A), "tal: 0 <= k <= ", TAL_MAX_K,
              " and k < A, or every anchor a member");
  a.pd = pd.data_ptr<float>();
  a.anc = anc.data_ptr<float>();
  a.labels = labels.data_ptr<int32_t>();
  a.gt = gt.data_ptr<float>();
  a.mask = static_cast<const uint8_t*>(mask.data_ptr());
  a.B = static_cast<int>(B), a.N = static_cast<int>(N), a.A = static_cast<int>(A);
  a.k = static_cast<int>(all_members ? 0 : k);
  a.all_members = all_members;
}

// The candidates kernel: (winners, has_any), then overlaps and align in
// check mode, allocated here.
std::vector<torch::Tensor> tal_candidates(torch::Tensor scores, torch::Tensor pd, torch::Tensor anc,
                                          torch::Tensor labels, torch::Tensor gt, torch::Tensor mask, int64_t k,
                                          bool all_members, double beta, double eps, double cv, bool check_mode) {
  TalArgs a{};
  tal_inputs(a, pd, anc, labels, gt, mask, k, all_members);
  TORCH_CHECK(scores.is_cuda() && scores.device() == pd.device() && scores.scalar_type() == at::kFloat &&
                  scores.dim() == 3 && scores.size(0) == a.B && scores.size(1) == a.A && scores.stride(2) == 1 &&
                  scores.size(2) >= 1 && scores.size(2) < (int64_t(1) << 31),
              "tal_candidates: pd_scores float32 [B, A, C] beside pd_bboxes, unit stride in C");
  TORCH_CHECK(a.A <= TAL_CLUSTER * TAL_MAX_CHUNK, "tal_candidates: A at most ", TAL_CLUSTER * TAL_MAX_CHUNK);
  TORCH_CHECK(int64_t((a.A + TAL_CLUSTER - 1) / TAL_CLUSTER) * scores.size(2) < (int64_t(1) << 30),
              "tal_candidates: a chunk's logits (A / ", TAL_CLUSTER, " x C) under 2^30");
  const auto f = scores.options();
  std::vector<torch::Tensor> out{torch::empty({a.B, a.N, TAL_MAX_K}, f.dtype(at::kInt)),
                                 torch::empty({a.B, a.N}, f.dtype(at::kByte))};
  if (check_mode) {
    out.push_back(torch::empty({a.B, a.N, a.A}, f));
    out.push_back(torch::empty({a.B, a.N, a.A}, f));
    a.overlaps = out[2].data_ptr<float>();
    a.align = out[3].data_ptr<float>();
  }
  a.scores = scores.data_ptr<float>();
  a.score_sb = scores.stride(0);
  a.score_sa = scores.stride(1);
  a.C = static_cast<int>(scores.size(2));
  a.beta = static_cast<float>(beta), a.eps = static_cast<float>(eps), a.cv = static_cast<float>(cv);
  a.winners = out[0].data_ptr<int32_t>();
  a.has_any = out[1].data_ptr<uint8_t>();
  C10_CUDA_CHECK(launch_tal_candidates(a, at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// The targets kernel over the candidates kernel's (winners, has_any):
// (labels, bboxes, scores, fg, gt_idx), allocated here.
std::vector<torch::Tensor> tal_targets(torch::Tensor pd, torch::Tensor anc, torch::Tensor labels, torch::Tensor gt,
                                       torch::Tensor mask, torch::Tensor winners, torch::Tensor has_any, int64_t k,
                                       bool all_members, int64_t num_classes, double cv) {
  TalArgs a{};
  tal_inputs(a, pd, anc, labels, gt, mask, k, all_members);
  check(winners, "tal_targets winners");
  check(has_any, "tal_targets has_any");
  TORCH_CHECK(winners.scalar_type() == at::kInt && winners.dim() == 3 && winners.size(0) == a.B &&
                  winners.size(1) == a.N && winners.size(2) == TAL_MAX_K && winners.device() == pd.device(),
              "tal_targets: winners int32 [B, N, ", TAL_MAX_K, "]");
  TORCH_CHECK(has_any.scalar_type() == at::kByte && has_any.dim() == 2 && has_any.size(0) == a.B &&
                  has_any.size(1) == a.N && has_any.device() == pd.device(),
              "tal_targets: has_any uint8 [B, N]");
  TORCH_CHECK(num_classes >= 1 && num_classes < (int64_t(1) << 23), "tal_targets: 1 <= num_classes < 2^23");
  const auto f = pd.options();
  std::vector<torch::Tensor> out{torch::empty({a.B, a.A}, f.dtype(at::kInt)), torch::empty({a.B, a.A, 4}, f),
                                 torch::empty({a.B, a.A, num_classes}, f), torch::empty({a.B, a.A}, f.dtype(at::kBool)),
                                 torch::empty({a.B, a.A}, f.dtype(at::kInt))};
  a.nc = static_cast<int>(num_classes);
  a.cv = static_cast<float>(cv);
  a.winners = winners.data_ptr<int32_t>();
  a.has_any = has_any.data_ptr<uint8_t>();
  a.out_labels = out[0].data_ptr<int32_t>();
  a.out_bboxes = out[1].data_ptr<float>();
  a.out_scores = out[2].data_ptr<float>();
  a.out_fg = static_cast<uint8_t*>(out[3].data_ptr());
  a.out_idx = out[4].data_ptr<int32_t>();
  C10_CUDA_CHECK(launch_tal_targets(a, at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("stem", &stem, "fused stem: conv3x3 s2 + bias + SiLU, twice (fp32)");
  m.def("stem_tc", &stem_tc, "fused stem on the tensor cores (bf16, packed weights)");
  m.def("dw7x7", &dw7x7, "depthwise 7x7 + bias + SiLU");
  m.def("topk", &topk, "exact per-row top-k: (values, int32 indices), allocated here");
  m.def("mpbwd", &mpbwd, "backward of the k x k stride-1 same max pool");
  m.def("bn_moments", &bn_moments, "training BatchNorm batch moments (sum, sum of squares) in a fixed order");
  m.def("tal_candidates", &tal_candidates, "task-aligned assignment, pass 1: each GT row's winners and has_any");
  m.def("tal_targets", &tal_targets, "task-aligned assignment, pass 2: each anchor's GT, label, box and scores");
  m.def("bn_moments_bwd", &bn_moments_bwd, "backward of the batch moments: g_s1 + 2 y g_s2, cast to y's type");
  m.def("bmm", &bmm, "matrix product with an fp32 sum and the folded conv epilogue (mma.sync)");
  m.def("bmm_wgmma", &bmm_wgmma, "matrix product with an fp32 sum and the folded conv epilogue (TMA + wgmma)");
  m.def("s2dconv", &s2dconv, "3x3 conv 32->32 + bias + SiLU over the space-to-depth form (fp32)");
  m.def("max_argmax", &max_argmax, "per-row (max, first argmax) of up to four levels, into [B, sum rows] outputs");
  m.def("max_argmax_flags", &max_argmax_flags, "max_argmax plus the per-image flags of the maps' non-finite values");
  m.def("nms", &nms, "exact greedy NMS over score-sorted candidates: (keep, dets, num), allocated here");
  m.def("dfl_boxes", &dfl_boxes, "DFL expectation and xyxy pixel boxes of the selected anchors");
  m.def("topk_decode", &topk_decode, "the top-k decode's second stage: gather, top-k and box decode in one launch");
  m.def("s2dconv_wgmma", &s2dconv_wgmma, "3x3 conv 32->32 + bias + SiLU over the space-to-depth form (bf16, wgmma)");
}
