// Linear soft-NMS, all rounds in one launch.
//
// Replaces no TPU kernel: the JAX package runs soft-NMS as an XLA
// `fori_loop` (htd_tpu/ops/nms.py, `soft_nms`). The port's plain version,
// `ops/nms.py::soft_nms_plain`, dispatches about 25 tensor ops a round from
// the host; this kernel runs every round in one thread block.
//
// Function (the plain version's, bit for bit on the same CUDA tensors):
// boxes (N, 4) x1 y1 x2 y2 and scores (N,), float32. Scores below
// `min_score` start dead (-inf). Each of `max_out` rounds emits the highest
// live score, first index on ties, with NaN above every number as
// `torch.argmax` orders them; if that score is above -inf, every live score
// is multiplied by (1 - IoU) where its box's IoU with the emitted box exceeds
// `iou_threshold`, and set to -inf where the product falls below
// `min_score`; the emitted entry is then set to -inf. Outputs per round:
// keep_idx (int64, 0 unless valid), keep_score (the emitted score) and
// keep_valid (score > -inf). Each operation is one correctly rounded float32
// operation in the plain version's order (`__fadd_rn` and friends, so that
// nothing is fused into an FMA); max, min and the clamps pass NaN on as
// PyTorch's do.
//
// Bound on the H100: the serial rounds, not bytes or operations. Round r
// needs round r-1's choice, so the work is max_out block-wide argmax
// reductions in a row over N entries (N = 2,048 candidates, max_out = 100
// on the R-101-DCN test settings: 3.3 MFLOP and 50 KB, microseconds of the
// card's throughput), all on the one SM that runs the block: a round costs
// N entries' updates at that SM's issue rate (128 lanes a cycle) plus the
// dependent chain from the round's pick to the next. Design: one block, a
// thread per entry in whole warps up to 1,024 threads (on the H100 faster
// than 512 at N = 2,048 and more so above, with the 32 warps hiding the
// updates' latencies); each thread owns
// entries t, t + blockDim, ... Every entry's box, area and live score sit in
// shared memory (six arrays of N floats, up to kSharedEntries entries;
// beyond that the same arrays in a device-memory workspace). A round is one
// pass and one barrier: each thread updates its live scores (the IoU's
// division only where the boxes meet) and keeps its best entry (score, index
// and box) in registers; a warp's best is picked by two `redux` instructions
// on an order key and handed, box and all, to a shared slot by the lane that
// holds it; after the barrier every warp reduces the slots the same way and
// reads the round's box from the winning slot. Nothing on the chain from one
// round's pick to the next touches device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSharedEntries = 9216;   // 6 x 4 bytes each: 216 KiB of the H100's 227
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// torch.argmax's order as an unsigned key: a NaN above every number, -0 equal
// to +0, and -inf (0x007fffff) above a thread with no entry (0); ties go to
// the lower index
__device__ __forceinline__ unsigned order_key(float v) {
  if (v != v) return kFull;
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// torch.maximum / torch.minimum / clamp(min=): NaN passes through
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

struct Entry {
  unsigned key;
  unsigned idx;
  float x1, y1, x2, y2, area, score;
};

__device__ __forceinline__ Entry no_entry() {
  return {0u, kFull, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, neg_inf()};
}

// entries come in increasing index, so a tie keeps the earlier one
__device__ __forceinline__ void consider(Entry& best, float v, int k, float x1, float y1,
                                         float x2, float y2, float a) {
  const unsigned key = order_key(v);
  if (key > best.key) best = {key, (unsigned)k, x1, y1, x2, y2, a, v};
}

// the entry of the warp's highest key, lowest index on ties: its lane
__device__ __forceinline__ bool warp_first(unsigned key, unsigned idx) {
  const unsigned top = __reduce_max_sync(kFull, key);
  const unsigned low = __reduce_min_sync(kFull, key == top ? idx : kFull);
  return key == top && idx == low;
}

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
soft_nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores, const int n,
                const float iou_threshold, const float min_score, const int max_out,
                float* __restrict__ workspace, int64_t* __restrict__ keep_idx,
                float* __restrict__ keep_score, bool* __restrict__ keep_valid) {
  extern __shared__ float smem[];
  __shared__ unsigned slot_key[2][32], slot_idx[2][32];
  __shared__ Entry slot[2][32];
  float* const st = kShared ? smem : workspace;
  const int64_t m = n;
  float* const X1 = st;
  float* const Y1 = st + m;
  float* const X2 = st + 2 * m;
  float* const Y2 = st + 3 * m;
  float* const AREA = st + 4 * m;
  float* const LIVE = st + 5 * m;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float eps = static_cast<float>(1e-6);   // the plain version's union clamp

  Entry best = no_entry();
  for (int k = tid; k < n; k += blockDim.x) {
    const float* b = boxes + 4 * (int64_t)k;
    const float x1 = b[0], y1 = b[1], x2 = b[2], y2 = b[3];
    const float a = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
    const float s = scores[k] < min_score ? neg_inf() : scores[k];
    X1[k] = x1;
    Y1[k] = y1;
    X2[k] = x2;
    Y2[k] = y2;
    AREA[k] = a;
    LIVE[k] = s;
    consider(best, s, k, x1, y1, x2, y2, a);
  }

  for (int r = 0;; ++r) {
    const int buf = r & 1;   // a slot is written again two barriers after it is read
    if (warp_first(best.key, best.idx)) {
      slot_key[buf][warp] = best.key;
      slot_idx[buf][warp] = best.idx;
      slot[buf][warp] = best;
    }
    __syncthreads();
    const unsigned wk = lane < nwarps ? slot_key[buf][lane] : 0u;
    const unsigned wi = lane < nwarps ? slot_idx[buf][lane] : kFull;
    const Entry p = slot[buf][__ffs(__ballot_sync(kFull, warp_first(wk, wi))) - 1];
    if (tid == 0) {
      const bool valid = p.score > neg_inf();
      keep_idx[r] = valid ? (int64_t)p.idx : 0;
      keep_score[r] = p.score;
      keep_valid[r] = valid;
    }
    if (r + 1 == max_out) return;
    const bool decay = p.score > neg_inf();   // false for a NaN
    best = no_entry();
    for (int k = tid; k < n; k += blockDim.x) {
      const float x1 = X1[k], y1 = Y1[k], x2 = X2[k], y2 = Y2[k], a = AREA[k];
      float v = LIVE[k];
      if (decay) {
        const float w = clamp_min(__fsub_rn(tmin(p.x2, x2), tmax(p.x1, x1)), 0.0f);
        const float h = clamp_min(__fsub_rn(tmin(p.y2, y2), tmax(p.y1, y1)), 0.0f);
        const float inter = __fmul_rn(w, h);
        float d = 1.0f;   // no intersection: an IoU of 0 (or NaN), a decay of 1
        if (inter != 0.0f) {
          const float uni = clamp_min(__fsub_rn(__fadd_rn(p.area, a), inter), eps);
          const float iou = __fdiv_rn(inter, uni);
          if (iou > iou_threshold) d = __fsub_rn(1.0f, iou);
        }
        v = __fmul_rn(v, d);
        if (v < min_score) v = neg_inf();
      }
      if ((unsigned)k == p.idx) v = neg_inf();
      LIVE[k] = v;
      consider(best, v, k, x1, y1, x2, y2, a);
    }
  }
}

}  // namespace

// boxes (n, 4) and scores (n,) float32, contiguous; keep_idx (max_out,)
// int64, keep_score (max_out,) float32, keep_valid (max_out,) bool;
// `workspace` 6 n float32, used only when n > 9,216 (may be null otherwise).
// Returns cudaGetLastError() after the launch (0 on success); -1 on bad
// arguments.
extern "C" int htd_soft_nms(const void* boxes, const void* scores, int n, float iou_threshold,
                            float min_score, int max_out, void* workspace, void* keep_idx,
                            void* keep_score, void* keep_valid, cudaStream_t stream) {
  if (n < 1 || max_out < 1) return -1;
  const int warps = (n + 31) / 32;
  const int threads = warps < kMaxThreads / 32 ? warps * 32 : kMaxThreads;
  const float* b = static_cast<const float*>(boxes);
  const float* s = static_cast<const float*>(scores);
  int64_t* ki = static_cast<int64_t*>(keep_idx);
  float* ks = static_cast<float*>(keep_score);
  bool* kv = static_cast<bool*>(keep_valid);
  if (n <= kSharedEntries) {
    // more than 48 KB of dynamic shared memory needs the kernel's opt-in
    const int bytes = 6 * n * (int)sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        soft_nms_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    soft_nms_kernel<true><<<1, threads, bytes, stream>>>(b, s, n, iou_threshold, min_score,
                                                          max_out, nullptr, ki, ks, kv);
  } else {
    if (workspace == nullptr) return -1;
    soft_nms_kernel<false><<<1, threads, 0, stream>>>(b, s, n, iou_threshold, min_score,
                                                       max_out, static_cast<float*>(workspace),
                                                       ki, ks, kv);
  }
  return (int)cudaGetLastError();
}
