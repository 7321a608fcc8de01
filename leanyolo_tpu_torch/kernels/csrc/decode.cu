// The box decode (K3) of the NMS decodes' candidates: one launch for up to
// four levels of reg maps, read in place (strided rows, as the slices of a
// concatenated [B, H, W, 4R+nc] map).
//
// Replaces the dense per-level DFL and box decode of the JAX package,
// leanyolo_tpu/models/yolov10/decode.py:191 _boxes_per_level with
// ops/anchors.py:73 dfl_expectation, :48 dist2bbox and :17 make_anchors, and
// its gather at decode.py:336-337 (and the export's at
// export/serving.py:104): only the k selected anchors are decoded. A thread
// takes one side of one anchor: its reg_max = 16 bins' softmax expectation,
// then the side's coordinate in pixels (decode.cuh's dfl_side, the order of
// operations kernels/dfl.py's plain version fixes, so the two are bit-equal
// on the card). With the per-image flags of argmax.cu a side flagged
// non-finite is NaN in every box of the image, as JAX's one-hot-dot gather
// spreads it; without them (the export, whose JAX wrapper gathers with
// take_along_axis) each box is its own anchor's.
//
// The top-k decode no longer launches this kernel: its boxes are the fused
// second top-k's epilogue (topk.cu), which uses the same dfl_side.
//
// Bound on an H100: bytes (kernels/bounds.py), far below a launch's latency:
// the box decode of [32, 1000] anchors moves 4.7 MB (1.4 us).
#include "decode.cuh"

namespace {

using namespace decode_detail;

constexpr int THREADS = 256;

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
dfl_boxes_kernel(DecodeLevels lv, int A, int k, const int32_t* __restrict__ anchor_idx,
                 const int32_t* __restrict__ flags, int nc, long long total, float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= total) return;
  const long long row = t >> 2;  // b * k + j
  const int side = static_cast<int>(t & 3);
  const int b = static_cast<int>(row / k);
  const int g = __ldg(anchor_idx + row);
  const DecodeFlags fl{nc};
  out[row * 4 + side] = dfl_side<T, VEC>(lv, A, b, g, side, fl.row(flags, b), fl);
}

template <typename T>
cudaError_t dfl_launch(const DecodeLevels& lv, int B, const int32_t* anchor_idx, int k, const int32_t* flags, int nc,
                       float* out, cudaStream_t stream) {
  const long long total = 4LL * B * k;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  const int A = lv.start[lv.count];
  if (rows_vec<T>(lv, 4 * REG_MAX)) {
    dfl_boxes_kernel<T, true><<<blocks, THREADS, 0, stream>>>(lv, A, k, anchor_idx, flags, nc, total, out);
  } else {
    dfl_boxes_kernel<T, false><<<blocks, THREADS, 0, stream>>>(lv, A, k, anchor_idx, flags, nc, total, out);
  }
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_dfl_boxes(const DecodeLevels& lv, int B, const int32_t* anchor_idx, int k, const int32_t* flags,
                             int nc, bool bf16, float* out, cudaStream_t stream) {
  if (lv.count < 1 || lv.count > DECODE_MAX_LEVELS || k < 1 || (flags && nc < 0)) return cudaErrorInvalidValue;
  return bf16 ? dfl_launch<__nv_bfloat16>(lv, B, anchor_idx, k, flags, nc, out, stream)
              : dfl_launch<float>(lv, B, anchor_idx, k, flags, nc, out, stream);
}
