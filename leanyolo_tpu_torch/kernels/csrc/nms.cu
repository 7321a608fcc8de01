// Exact greedy NMS over score-sorted candidates, with the compaction of the
// survivors into [max_det, 6] rows and a count: one CTA an image.
//
// Replaces the JAX package's lax program leanyolo_tpu/ops/boxes.py:163
// _alive_blocked (through :250 nms_fixed(presorted=True, valid=)) and the
// compaction of leanyolo_tpu/models/yolov10/decode.py:205 _nms_single. On
// the TPU the triangular solve ran as blocked Jacobi sweeps of 0/1 matvecs
// on the MXU over every pair; greedy NMS only needs the IoU rows of the
// candidates that survive, and on Hopper it computes just those:
//
// 1. The CTA loads the image's boxes into shared memory (class-wise:
//    shifted by cls * group_offset first, as the JAX decode shifts them, so
//    IoUs are those of the shifted boxes) with their areas, and computes
//    every diagonal word: bit m of rank i's word is iou(i, m) > thresh for
//    the later ranks m of i's block of 32. That is 24 bytes a candidate;
//    past shared memory (n above about 9,600) the boxes are read from
//    device memory (L2), shifted again at each read, and a block's
//    diagonal words are computed one step ahead. A dead bit a candidate
//    starts set where the candidate is invalid (valid input, and score >
//    conf_thresh where asked): invalid candidates never suppress and never
//    survive.
// 2. The ranks are walked 32 at a time, a block a step. A step starts at a
//    barrier; then every warp settles the block's survivors by itself from
//    the block's live bits and diagonal words, in registers (Jacobi sweeps
//    of one warp OR-reduction each, to their fixed point), so that nothing
//    is broadcast and the chain from one block to the next is a barrier and
//    this settle. Then each thread takes a later candidate that is still
//    live and tests it against the block's survivors, four at a time (boxes
//    that do not overlap leave after four comparisons); a ballot a word sets
//    the dead bits. IoUs are thus computed for the diagonal blocks and for
//    the survivors' rows against live candidates only: no n x n mask.
// 3. The last warp writes the keep flags, or the survivors' [box, score,
//    cls] rows (the unshifted boxes, read in the input's type a step ahead,
//    so that no load waits on the chain) in rank order as they are settled;
//    nms_compact stops once min(max_det, n) slots are filled, then writes
//    the zero rows and the count.
//
// IoU is boxes.py:37-46's sequence in IEEE single precision with explicit
// roundings (__fadd_rn and friends), so no multiply and add contract into
// an FMA: the keep set is JAX's bit for bit, also at an IoU exactly at the
// threshold. In the bf16 mode (bf16 candidates, read as they are) the
// shift, the areas and each IoU operation are rounded to bf16 where JAX's
// bf16 arithmetic rounds them (__float2bfloat16_rn after each IEEE fp32
// operation, which is how XLA computes a bf16 operation), eps bf16(1e-9).
//
// One CTA an image: a cluster of 2 to 8 CTAs an image, splitting the rows,
// was measured against it at 1, 32, 66 and 140 images; its barrier (800 to
// 1,400 cycles a step) cost more than the split saved, but where survivors
// crowd a block (PERF.md).
//
// Bound on an H100: at [32, 1000] the bytes (1.0 MB) and the fp32 IoU
// operations (14 a pair over the survivors' rows) take about half a
// microsecond (kernels/bounds.py nms_work). The kernel is latency: a chain
// of n / 32 steps, each a barrier, a settle (a warp reduction a sweep) and
// the survivors' rows, which no bound covers.
#include <cuda_bf16.h>

#include <atomic>
#include <type_traits>

#include "kernels.h"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_LIMIT = 227 * 1024;  // dynamic shared memory a CTA may take on sm_90
constexpr unsigned FULL = 0xFFFFFFFFu;

__host__ __device__ inline int words(int n) { return (n + 31) / 32; }

// Shared memory: the dead bits (unless they are in device memory), then the
// table (boxes, areas and every diagonal word, the last block's padded to
// 32) where it fits, else the diagonal words of two blocks.
__host__ __device__ inline size_t dead_bytes(int n) { return (size_t(words(n)) * 4 + 15) / 16 * 16; }
__host__ inline size_t table_bytes(int n) { return size_t(n) * 20 + size_t(words(n)) * 128; }
__host__ inline bool dead_in_smem(int n) { return dead_bytes(n) + 256 <= size_t(SMEM_LIMIT); }
__host__ inline bool table_in_smem(int n) { return dead_bytes(n) + table_bytes(n) <= size_t(SMEM_LIMIT); }

// An fp32 result rounded as the mode's dtype rounds it: the identity in
// fp32, round-to-nearest-even to bf16 in the bf16 mode.
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float4 load_box(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load_box(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, c.x, c.y);
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
struct Args {
  const T* boxes;   // [B, n, 4]
  const T* scores;  // [B, n] or nullptr
  const T* cls;     // [B, n] or nullptr
  const uint8_t* valid;
  int n;
  float iou_thresh, conf_thresh, group_offset;
  bool use_conf, class_wise;
  uint8_t* keep;      // [B, n] or nullptr
  float* dets;        // [B, max_det, 6], with num
  int32_t* num;       // [B] or nullptr: compaction
  int max_det, k_out;
  uint32_t* dead;     // [B, words(n)] in device memory, or nullptr: in shared memory
};

// A candidate as the IoU reads it: its box (shifted class-wise) and area.
struct Cand {
  float4 box;
  float area;
};

template <typename T>
__device__ __forceinline__ Cand prepare(const Args<T>& a, size_t i) {
  float4 q = load_box(a.boxes + 4 * i);
  if (a.class_wise) {
    const float off = rnd<T>(__fmul_rn(load1(a.cls + i), a.group_offset));
    q = make_float4(rnd<T>(__fadd_rn(q.x, off)), rnd<T>(__fadd_rn(q.y, off)), rnd<T>(__fadd_rn(q.z, off)),
                    rnd<T>(__fadd_rn(q.w, off)));
  }
  return {q, rnd<T>(__fmul_rn(fmaxf(rnd<T>(__fsub_rn(q.z, q.x)), 0.0f), fmaxf(rnd<T>(__fsub_rn(q.w, q.y)), 0.0f)))};
}

// iou(p, c) > thresh, boxes.py:37-46 rounded as JAX rounds it (p the
// higher-ranked candidate; the sum of the areas commutes exactly). Boxes
// that do not overlap return after four comparisons: where the right edges'
// min is not above the left edges' max (or the same in y), the width (or
// height) clamps to 0 and the IoU is 0 / (union + eps) = +-0, not above a
// threshold >= 0. (A difference of two distinct values rounds to nonzero in
// either type, so the test is exact.)
template <typename T>
__device__ __forceinline__ bool suppresses(const Cand& p, const Cand& c, float thresh) {
  const float x1 = fmaxf(p.box.x, c.box.x), x2 = fminf(p.box.z, c.box.z);
  const float y1 = fmaxf(p.box.y, c.box.y), y2 = fminf(p.box.w, c.box.w);
  if (!(x2 > x1 && y2 > y1) && thresh >= 0.0f) return false;
  const float eps = rnd<T>(1e-9f);  // bf16(1e-9) in the bf16 mode
  const float iw = fmaxf(rnd<T>(__fsub_rn(x2, x1)), 0.0f), ih = fmaxf(rnd<T>(__fsub_rn(y2, y1)), 0.0f);
  const float inter = rnd<T>(__fmul_rn(iw, ih));
  const float uni = rnd<T>(__fsub_rn(rnd<T>(__fadd_rn(p.area, c.area)), inter));
  return rnd<T>(__fdiv_rn(inter, rnd<T>(__fadd_rn(uni, eps)))) > thresh;
}

template <typename T, bool TABLE>
__global__ void __launch_bounds__(THREADS) nms_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, n = a.n, W = words(n);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = size_t(b) * n;
  uint32_t* dead = a.dead ? a.dead + size_t(b) * W : reinterpret_cast<uint32_t*>(smem);
  float4* box = reinterpret_cast<float4*>(smem + (a.dead ? 0 : dead_bytes(n)));
  float* area = reinterpret_cast<float*>(box + (TABLE ? n : 0));
  // TABLE: rank i's diagonal word at diag[i]; else block w's at diag[(w & 1) * 32 + k].
  uint32_t* diag = reinterpret_cast<uint32_t*>(area + (TABLE ? n : 0));
  const auto cand = [&](int i) -> Cand {
    if constexpr (TABLE) {
      return {box[i], area[i]};
    } else {
      return prepare(a, base + i);
    }
  };
  // Block w's diagonal words (bit m of word k: iou(32 w + k, 32 w + m) >
  // thresh, m > k) into out[0..31], in 16 warp tests with no idle lane:
  // item k < 15 tests row k on lanes below 31 - k and row 30 - k on the
  // rest; item 15 tests row 15 on lanes below 16 (row 31 is empty).
  const auto diag_item = [&](int w, int k, uint32_t* out) {
    const bool first = lane < 31 - k;
    const int i = w * 32 + (first ? k : 30 - k), j = w * 32 + (first ? k + 1 + lane : lane);
    const bool hit = (first || k < 15) && j < n && suppresses<T>(cand(i), cand(j), a.iou_thresh);
    const uint32_t bits = __ballot_sync(FULL, hit), low = (1u << (31 - k)) - 1u;
    if (lane == 0) {
      out[k] = (bits & low) << (k + 1);
      out[k < 15 ? 30 - k : 31] = k < 15 ? bits & ~low : 0u;
    }
  };

  if constexpr (TABLE) {
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const Cand c = prepare(a, base + i);
      box[i] = c.box;
      area[i] = c.area;
    }
  }
  for (int v = warp; v < W; v += WARPS) {  // a word a warp: a candidate a lane, one ballot
    const int i = v * 32 + lane;
    bool ok = i < n && (a.valid == nullptr || a.valid[base + i]);
    if (a.use_conf) ok = ok && load1(a.scores + base + i) > a.conf_thresh;
    const uint32_t live = __ballot_sync(FULL, ok);
    if (lane == 0) dead[v] = ~live;  // ranks past n are dead from the start
  }
  if constexpr (TABLE) {
    __syncthreads();  // the table is whole
#pragma unroll 2
    for (int t = warp; t < W * 16; t += WARPS) diag_item(t / 16, t % 16, diag + t / 16 * 32);
  } else if (warp < 16) {
    diag_item(0, warp, diag);
  }
  // The payload of the next block's ranks, read a step ahead by the writer,
  // the last warp, which tests no candidates while the later words number
  // fewer than the warps.
  const bool writer = warp == WARPS - 1;
  float4 pq = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float ps = 0.0f, pc = 0.0f;
  if (writer && a.num && lane < n) pq = load_box(a.boxes + 4 * (base + lane)), ps = load1(a.scores + base + lane),
                                   pc = load1(a.cls + base + lane);

  int count = 0;
  for (int w = 0; w < W; ++w) {
    __syncthreads();  // dead[w] and block w's diagonal words are final
    const int s = w * 32;
    // The settle, the same in every warp (no broadcast, no barrier): the
    // survivors are the live ranks no survivor's diagonal word names. From
    // kept = live, kept = live & ~OR(words of kept) until it holds (the JAX
    // package's Jacobi sweeps, one warp reduction each): the first fixed
    // point is greedy's, since the lowest rank where they differ would
    // see the same survivors below it in both.
    const uint32_t d = TABLE ? diag[s + lane] : diag[(w & 1) * 32 + lane];
    const uint32_t live = ~dead[w];
    uint32_t kept = live;
    for (;;) {
      const uint32_t next = live & ~__reduce_or_sync(FULL, (kept >> lane) & 1u ? d : 0u);
      if (next == kept) break;
      kept = next;
    }
    if (writer) {
      const int i = s + lane;
      const bool kp = (kept >> lane) & 1u;
      if (a.keep && i < n) a.keep[base + i] = kp;
      const int pos = count + __popc(kept & ((1u << lane) - 1u));
      if (a.num && kp && pos < a.k_out) {
        float* row = a.dets + (size_t(b) * a.max_det + pos) * 6;
        row[0] = pq.x, row[1] = pq.y, row[2] = pq.z, row[3] = pq.w, row[4] = ps, row[5] = pc;
      }
    }
    count += __popc(kept);
    if ((a.num && count >= a.k_out) || w + 1 == W) break;  // every slot filled, or the last block
    if (writer && a.num && s + 32 + lane < n) {
      const size_t i = base + s + 32 + lane;
      pq = load_box(a.boxes + 4 * i), ps = load1(a.scores + i), pc = load1(a.cls + i);
    }

    // The survivors' rows against the later live candidates, a word a warp,
    // the survivors four at a time (independent tests, for the latency).
    if (kept) {
      for (int v = w + 1 + warp; v < W; v += WARPS) {
        const uint32_t dv = dead[v];
        bool hit = false;
        if (!((dv >> lane) & 1u)) {
          const Cand c = cand(v * 32 + lane);
          for (uint32_t m = kept; m;) {
            int k[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) k[u] = m ? s + __ffs(m) - 1 : -1, m &= m - 1;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (k[u] >= 0) hit |= suppresses<T>(cand(k[u]), c, a.iou_thresh);
            }
          }
        }
        const uint32_t word = __ballot_sync(FULL, hit);
        if (lane == 0 && word) dead[v] = dv | word;
      }
    }
    if constexpr (!TABLE) {
      if (warp < 16) diag_item(w + 1, warp, diag + ((w + 1) & 1) * 32);
    }
  }
  if (a.num) {
    const int num = min(count, a.k_out);
    float* d = a.dets + size_t(b) * a.max_det * 6;
    for (int e = num * 6 + threadIdx.x; e < a.max_det * 6; e += THREADS) d[e] = 0.0f;
    if (threadIdx.x == 0) a.num[b] = num;
  }
}

// The dynamic shared memory attribute, set once for each kernel instance on
// each device.
constexpr int MAX_DEVICES = 64;

cudaError_t configure(const void* kernel, int instance) {
  static std::atomic<bool> done[4][MAX_DEVICES];
  int device = 0;
  const cudaError_t got = cudaGetDevice(&device);
  if (got != cudaSuccess) return got;
  const bool cached = device < MAX_DEVICES;
  if (cached && done[instance][device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (e == cudaSuccess && cached) done[instance][device].store(true, std::memory_order_release);
  return e;
}

template <typename T>
cudaError_t launch(const Args<T>& a, int B, cudaStream_t stream) {
  const bool table = table_in_smem(a.n);
  auto kernel = table ? &nms_kernel<T, true> : &nms_kernel<T, false>;
  const cudaError_t err =
      configure(reinterpret_cast<const void*>(kernel), 2 * std::is_same_v<T, __nv_bfloat16> + table);
  if (err != cudaSuccess) return err;
  kernel<<<B, THREADS, (a.dead ? 0 : dead_bytes(a.n)) + (table ? table_bytes(a.n) : 256), stream>>>(a);
  return cudaSuccess;
}

}  // namespace

size_t nms_scratch_bytes(int B, int n) { return dead_in_smem(n) ? 0 : size_t(B) * words(n) * 4; }

cudaError_t launch_nms(const void* boxes, const void* scores, const void* cls, const uint8_t* valid, int B, int n,
                       float iou_thresh, bool use_conf, float conf_thresh, bool class_wise, float group_offset,
                       uint8_t* keep, float* dets, int32_t* num, int max_det, bool bf16, void* scratch,
                       cudaStream_t stream) {
  if (B == 0 || n == 0) return cudaSuccess;
  if ((use_conf && !scores) || (class_wise && !cls) || (num && (!scores || !cls || (max_det && !dets))) ||
      (!dead_in_smem(n) && !scratch))
    return cudaErrorInvalidValue;
  uint32_t* dead = dead_in_smem(n) ? nullptr : static_cast<uint32_t*>(scratch);
  const int k_out = max_det < n ? max_det : n;
  if (bf16) {
    using H = __nv_bfloat16;
    return launch(Args<H>{static_cast<const H*>(boxes), static_cast<const H*>(scores), static_cast<const H*>(cls),
                          valid, n, iou_thresh, conf_thresh, group_offset, use_conf, class_wise, keep, dets, num,
                          max_det, k_out, dead},
                  B, stream);
  }
  return launch(Args<float>{static_cast<const float*>(boxes), static_cast<const float*>(scores),
                            static_cast<const float*>(cls), valid, n, iou_thresh, conf_thresh, group_offset,
                            use_conf, class_wise, keep, dets, num, max_det, k_out, dead},
                B, stream);
}
