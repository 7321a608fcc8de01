// Exact greedy NMS over score-sorted candidates, a cluster of CTAs an
// image, with the compaction of the survivors into [max_det, 6] rows and a
// count.
//
// Replaces the JAX package's lax program leanyolo_tpu/ops/boxes.py:163
// _alive_blocked (through :250 nms_fixed(presorted=True, valid=)) and the
// compaction of leanyolo_tpu/models/yolov10/decode.py:205 _nms_single. On
// the TPU the triangular solve ran as blocked Jacobi sweeps of 0/1 matvecs
// on the MXU; greedy NMS is a scan in rank order, and on Hopper it is one:
//
// 1. Each CTA of the image's cluster loads the n boxes into shared memory
//    (class-wise: shifted by cls * group_offset in fp32 first, as the JAX
//    decode shifts them, so IoUs are those of the shifted boxes), their
//    areas, and the valid bits (valid input, and score > conf_thresh where
//    asked).
// 2. The cluster's warps build the strict-upper-triangular suppression
//    bitmask, a row a warp: lane k computes iou(i, 32 w + k) > thresh and
//    a ballot makes word w. Rows of invalid candidates are skipped (they
//    never suppress). IoU is boxes.py:37-46's sequence in IEEE single
//    precision with explicit roundings (__fadd_rn and friends), so no
//    multiply and add contract into an FMA: the keep set is JAX's bit for
//    bit, also at an IoU exactly at the threshold. In the bf16 mode (the
//    JAX decode's NMS on bf16 maps) the shift, the areas and each IoU
//    operation are rounded to bf16 where JAX's bf16 arithmetic rounds them
//    (__float2bfloat16_rn after each IEEE fp32 operation, which is how XLA
//    computes a bf16 operation), eps bf16(1e-9). The words go to the
//    leader CTA's shared memory through distributed shared memory (n =
//    1000: 125 KB), or, where that does not fit, to a device-memory scratch
//    that also holds the boxes and areas, so n has no cap.
// 3. The leader's first warp walks the ranks 32 at a time: within a word
//    the survivors are settled by shuffles of the word's own diagonal block
//    (the lowest live rank survives and clears what its row removes), then
//    their rows are ORed into the removed words after it, a word a lane,
//    and their ranks take the next slots while slots remain. Nothing on
//    this path waits on device memory (a first cut that wrote each
//    survivor's row here spent a load's latency a survivor).
// 4. The leader's threads write the survivors' [box, score, cls] rows (the
//    unshifted boxes) in slot order, zero rows after, and the count.
//
// Bound on an H100: at [32, 1000] the bytes (1.0 MB) and the fp32 IoU
// operations (14 a pair over at most n(n-1)/2 pairs, 0.22 GFLOP) take a
// few microseconds (kernels/bounds.py nms_work). The IoUs are spread over
// up to 8 CTAs an image (as many as fill the SMs); the serial scan is
// latency (tens of cycles a survivor) that no bound covers.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <algorithm>

#include "kernels.h"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_BUDGET = 200 * 1024;

__host__ __device__ inline int words(int n) { return (n + 31) / 32; }

// An fp32 result rounded as the mode's dtype rounds it: the identity in
// fp32, round-to-nearest-even to bf16 in the bf16 mode.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// The table: an image's boxes (float4), areas, survivors' slots and
// suppression mask, in shared memory where it fits, else an image's
// 16-byte-aligned share of the scratch. After it in shared memory: the
// valid bits and removed words.
__host__ __device__ inline size_t table_bytes(int n) {
  return (size_t(n) * (16 + 4 + 4) + size_t(n) * words(n) * 4 + 15) / 16 * 16;
}
__host__ inline size_t smem_bytes(int n, bool in_smem) {
  return (in_smem ? table_bytes(n) : 0) + size_t(words(n)) * 8;
}
__host__ inline bool mask_in_smem(int n) { return smem_bytes(n, true) <= SMEM_BUDGET; }

struct Out {
  uint8_t* keep;  // [B, n] or nullptr
  float* dets;    // [B, max_det, 6] or nullptr
  int32_t* num;   // [B] or nullptr
  int max_det, k_out;
};

template <bool SMEM_MASK, bool BF16>
__global__ void __launch_bounds__(THREADS)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores, const float* __restrict__ cls,
           const uint8_t* __restrict__ valid, int n, float iou_thresh, bool use_conf, float conf_thresh,
           bool class_wise, float group_offset, Out out, unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const bool leader = rank == 0;
  const int W = words(n);
  const int b = blockIdx.x / cl;
  unsigned char* table = SMEM_MASK ? smem : scratch + size_t(b) * table_bytes(n);
  uint32_t* vbits = reinterpret_cast<uint32_t*>(SMEM_MASK ? smem + table_bytes(n) : smem);
  uint32_t* removed = vbits + W;
  float4* box = reinterpret_cast<float4*>(table);
  float* area = reinterpret_cast<float*>(box + n);
  int* slot = reinterpret_cast<int*>(area + n);  // slot j: the j-th survivor's rank
  uint32_t* mask = reinterpret_cast<uint32_t*>(slot + n);
  __shared__ int kept_count;

  const float* bx = boxes + size_t(b) * n * 4;
  if (SMEM_MASK || leader) {  // in device memory the leader's table serves the cluster
    for (int i = threadIdx.x; i < n; i += THREADS) {
      float4 q = make_float4(bx[4 * i], bx[4 * i + 1], bx[4 * i + 2], bx[4 * i + 3]);
      if (class_wise) {
        const float off = rnd<BF16>(__fmul_rn(cls[size_t(b) * n + i], group_offset));
        q = make_float4(rnd<BF16>(__fadd_rn(q.x, off)), rnd<BF16>(__fadd_rn(q.y, off)),
                        rnd<BF16>(__fadd_rn(q.z, off)), rnd<BF16>(__fadd_rn(q.w, off)));
      }
      box[i] = q;
      area[i] = rnd<BF16>(__fmul_rn(fmaxf(rnd<BF16>(__fsub_rn(q.z, q.x)), 0.0f),
                                    fmaxf(rnd<BF16>(__fsub_rn(q.w, q.y)), 0.0f)));
      if (leader && out.keep) out.keep[size_t(b) * n + i] = 0;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i0 = warp * 32; i0 < n; i0 += THREADS) {  // a word a warp: a candidate a lane, one ballot
    const int i = i0 + lane;
    bool v = i < n && (valid == nullptr || valid[size_t(b) * n + i]);
    if (use_conf) v = v && scores[size_t(b) * n + i] > conf_thresh;
    const uint32_t bits = __ballot_sync(0xFFFFFFFFu, v);
    if (lane == 0) vbits[i0 / 32] = bits, removed[i0 / 32] = 0;
  }
  __syncthreads();
  cluster.sync();  // every CTA of the cluster runs (its shared memory may be written), the table is ready

  // The suppression mask, in the leader's table: word w of row i holds
  // iou(i, 32 w + k) > thresh for the candidates j = 32 w + k > i. The
  // cluster's warps take every (cl * WARPS)-th row.
  uint32_t* lmask = SMEM_MASK ? cluster.map_shared_rank(mask, 0) : mask;
  for (int i = rank * WARPS + warp; i < n; i += cl * WARPS) {
    if (!((vbits[i / 32] >> (i % 32)) & 1u)) continue;  // an invalid row is never read
    const float4 a = box[i];
    const float ai = area[i];
    // bf16(1e-9) in the bf16 mode, fp32(1e-9) in fp32.
    const float eps = rnd<BF16>(1e-9f);
    auto suppresses = [&](int j) -> bool {  // boxes.py:37-46, rounded as JAX rounds it
      if (j <= i || j >= n) return false;
      const float4 c = box[j];
      const float iw = fmaxf(rnd<BF16>(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x))), 0.0f);
      const float ih = fmaxf(rnd<BF16>(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y))), 0.0f);
      const float inter = rnd<BF16>(__fmul_rn(iw, ih));
      const float uni = rnd<BF16>(__fsub_rn(rnd<BF16>(__fadd_rn(ai, area[j])), inter));
      return rnd<BF16>(__fdiv_rn(inter, rnd<BF16>(__fadd_rn(uni, eps)))) > iou_thresh;
    };
    for (int w = i / 32; w < W; w += 2) {  // two words an iteration, for the latency
      const bool s0 = suppresses(w * 32 + lane), s1 = suppresses((w + 1) * 32 + lane);
      const uint32_t w0 = __ballot_sync(0xFFFFFFFFu, s0), w1 = __ballot_sync(0xFFFFFFFFu, s1);
      if (lane == 0) {
        lmask[size_t(i) * W + w] = w0;
        if (w + 1 < W) lmask[size_t(i) * W + w + 1] = w1;
      }
    }
  }
  cluster.sync();  // the mask is whole; the leader walks it alone
  if (!leader) return;

  // The greedy scan in rank order, on one warp, a word (32 ranks) at a
  // time: lane k holds the word's own bits of row 32 w + k; the survivors
  // among the word's live ranks are settled by shuffles, one rank after
  // another; then their rows are ORed into the removed words after w, each
  // lane a word, and their ranks take the next slots.
  if (warp == 0) {
    int count = 0;
    for (int w = 0; w < W; ++w) {
      uint32_t live = vbits[w] & ~removed[w];
      const int me = w * 32 + lane;
      const uint32_t diag = (live >> lane) & 1u ? mask[size_t(me) * W + w] : 0u;
      uint32_t kept = 0;
      while (live) {
        const int k = __ffs(live) - 1;
        kept |= 1u << k;
        live &= ~(1u << k) & ~__shfl_sync(0xFFFFFFFFu, diag, k);
      }
      for (int v = w + 1 + lane; v < W; v += 32) {
        uint32_t acc = removed[v];
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          if ((kept >> k) & 1u) acc |= mask[size_t(w * 32 + k) * W + v];
        }
        removed[v] = acc;
      }
      if ((kept >> lane) & 1u) {
        const int pos = count + __popc(kept & ((1u << lane) - 1u));
        if (out.keep) out.keep[size_t(b) * n + me] = 1;
        if (pos < out.k_out) slot[pos] = me;
      }
      count += __popc(kept);
      __syncwarp();  // removed[w + 1] was written by another lane
    }
    if (lane == 0) kept_count = count;
  }
  __syncthreads();

  // The survivors' rows, gathered by all threads (off the scan's path:
  // its warp would wait on each load), then zero rows.
  if (out.dets) {
    const int num = min(kept_count, out.k_out);
    float* d = out.dets + size_t(b) * out.max_det * 6;
    for (int e = threadIdx.x; e < out.max_det * 6; e += THREADS) {
      const int j = e / 6, c = e % 6;
      float v = 0.0f;
      if (j < num) {
        const int i = slot[j];
        v = c < 4 ? bx[4 * i + c] : c == 4 ? scores[size_t(b) * n + i] : cls[size_t(b) * n + i];
      }
      d[e] = v;
    }
    if (threadIdx.x == 0 && out.num) out.num[b] = num;
  }
}

}  // namespace

size_t nms_scratch_bytes(int B, int n) { return mask_in_smem(n) ? 0 : size_t(B) * table_bytes(n); }

cudaError_t launch_nms(const float* boxes, const float* scores, const float* cls, const uint8_t* valid, int B, int n,
                       float iou_thresh, bool use_conf, float conf_thresh, bool class_wise, float group_offset,
                       uint8_t* keep, float* dets, int32_t* num, int max_det, int k_out, bool bf16,
                       void* scratch, cudaStream_t stream) {
  if (B == 0 || n == 0) return cudaSuccess;
  const Out out{keep, dets, num, max_det, k_out};
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  const bool in_smem = mask_in_smem(n);
  const size_t bytes = smem_bytes(n, in_smem);
  if (bytes > SMEM_BUDGET) return cudaErrorInvalidValue;  // n past 6.5 million
  auto kernel = in_smem ? (bf16 ? &nms_kernel<true, true> : &nms_kernel<true, false>)
                        : (bf16 ? &nms_kernel<false, true> : &nms_kernel<false, false>);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  // CTAs an image: enough clusters to cover the SMs, at most the portable 8.
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int cl = n < 64 ? 1 : std::max(1, std::min(8, sms / B));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(B) * unsigned(cl));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cl);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, boxes, scores, cls, valid, n, iou_thresh, use_conf,
                                                  conf_thresh, class_wise, group_offset, out, sc);
  if (launched != cudaSuccess) return launched;
  return cudaGetLastError();
}
