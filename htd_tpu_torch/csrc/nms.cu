// Greedy hard NMS over score-sorted boxes: two launches, no host
// synchronisation.
//
// Replaces no TPU kernel: the JAX package resolves the greedy pass with
// tiled XLA loops (htd_tpu/ops/nms.py, `nms_blocked`). The port's plain
// version, `ops/nms.py::nms_plain`, builds the N x N suppression matrix in
// about 15 tensor ops and iterates `keep = valid & ~(keep @ sup)` to its
// fixpoint, with a host synchronisation every 8 steps to test convergence;
// this kernel pair needs neither, so it can run inside a CUDA graph.
//
// Function (the plain version's, bit for bit on the same CUDA tensors): the
// launcher sorts the scores in descending order (stable) and gathers the
// boxes (N, 4) x1 y1 x2 y2 and scores in that order. Box i is valid when its
// score is above -inf (a NaN is not). The greedy keep set: box i is kept
// when it is valid and no kept box j < i has IoU(j, i) > iou_threshold. The
// IoU is `_sorted_iou`'s, one correctly rounded float32 operation at a time
// in its order (`__fadd_rn` and friends, so that nothing is fused into an
// FMA): area = (x2 - x1)(y2 - y1), w and h = clamp(min(x2) - max(x1), 0),
// inter = w h, union = clamp((area_i + area_j) - inter, 1e-6), inter /
// union; max, min and the clamps pass NaN on as PyTorch's do, and a NaN IoU
// suppresses nothing. Outputs, in keep order: the first `max_out` kept
// boxes' original indices (int64), scores and validity (true), then 0, -inf
// and false. The greedy set is prefix-stable (box i's fate depends only on
// boxes before it), so the scan stops once `max_out` boxes are kept.
//
// Bound on the H100: the scan's serial chain, not bytes or operations.
// The mask launch is parallel: N^2 / 2 IoUs (11.6 M at the RPN's N = 4,819,
// about 13 operations each) and N^2 / 8 bytes of mask written (2.9 MB), a
// few microseconds of the card. The scan is one block walking 64-box tiles
// in order, each tile waiting for the tiles before it.
// Design:
//  - Mask launch (`nms_mask_kernel`): a block of 64 threads per 64 x 64 tile
//    of the upper triangle (a one-dimensional grid over those tiles alone);
//    the tile's column boxes and areas in shared memory, one row per
//    thread; bit k of row i's word t set where box j = 64 t + k comes after
//    i and IoU(i, j) > iou_threshold. Tiles below the diagonal are never
//    written, and nothing reads them.
//  - Scan launch (`nms_scan_kernel`): one block. The `removed` words (a bit
//    per box: absent, or suppressed by a kept box) live in shared memory,
//    starting from the invalid boxes and those past N. Warp 0 resolves the
//    tiles in order, with nothing from device memory on its chain: its
//    lanes hold the tile's 64 rows' words for this tile and the next, their
//    indices and scores in registers, loaded a tile ahead. It finds the
//    tile's keep set as the fixpoint of its own suppressions (each step the
//    OR of the kept rows' words over the lanes, two `redux` steps; as many
//    steps as the tile's longest chain of suppressions, where visiting the
//    kept boxes one at a time took a shuffle each, about 48 a tile at the
//    RPN's size), writes their outputs, and ORs their next-tile words into
//    a carry for the next tile. Meanwhile the other warps OR the previous
//    tile's kept rows into the removed words two tiles on and beyond, every
//    (row, word) pair a load and a shared-memory atomicOr, sixteen loads in
//    flight a thread. One barrier a tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // boxes per tile: one 64-bit mask word
constexpr int kScanThreads = 256;
constexpr int kMaxWords = 2048;      // the scan's removed words: N <= 131,072
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// torch.maximum / torch.minimum / clamp(min=): NaN passes through
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

__device__ __forceinline__ float area_of(const float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(a, b) > thr in `_sorted_iou`'s operations; a NaN IoU is false. Where
// the boxes do not meet, inter is 0 and the IoU 0 (or NaN for a NaN union),
// so the division is skipped.
// A box with a NaN corner has a NaN area, so where both areas are numbers
// fmaxf / fminf equal torch.maximum / torch.minimum and take their place.
__device__ __forceinline__ bool suppresses(const float4 a, const float area_a, const float4 b,
                                           const float area_b, const float thr) {
  float x1, y1, x2, y2;
  if (area_a == area_a && area_b == area_b) {
    x1 = fmaxf(a.x, b.x);
    y1 = fmaxf(a.y, b.y);
    x2 = fminf(a.z, b.z);
    y2 = fminf(a.w, b.w);
  } else {
    x1 = tmax(a.x, b.x);
    y1 = tmax(a.y, b.y);
    x2 = tmin(a.z, b.z);
    y2 = tmin(a.w, b.w);
  }
  const float w = clamp_min(__fsub_rn(x2, x1), 0.0f);
  const float h = clamp_min(__fsub_rn(y2, y1), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = clamp_min(__fsub_rn(__fadd_rn(area_a, area_b), inter),
                              static_cast<float>(1e-6));
  if (inter == 0.0f) return uni == uni && 0.0f > thr;
  return __fdiv_rn(inter, uni) > thr;
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes, const int n, const int words, const float thr,
                unsigned long long* __restrict__ mask) {
  // block b -> the tile (row_tile, col_tile), col_tile >= row_tile, row-major
  // over the upper triangle: row r starts at r (2 words - r + 1) / 2
  const long long b = blockIdx.x;
  const double w2 = 2.0 * words + 1.0;
  int row_tile = (int)((w2 - sqrt(w2 * w2 - 8.0 * (double)b)) * 0.5);
  auto start = [words](long long r) { return r * (2LL * words - r + 1) / 2; };
  while (row_tile > 0 && start(row_tile) > b) --row_tile;
  while (start(row_tile + 1) <= b) ++row_tile;
  const int col_tile = row_tile + (int)(b - start(row_tile));
  __shared__ float4 col_box[kTile];
  __shared__ float col_area[kTile];
  const int t = threadIdx.x;
  const int j0 = col_tile * kTile;
  if (j0 + t < n) {
    const float4 bx = boxes[j0 + t];
    col_box[t] = bx;
    col_area[t] = area_of(bx);
  }
  __syncthreads();
  const int i = row_tile * kTile + t;
  if (i >= n) return;
  const float4 a = boxes[i];
  const float area_a = area_of(a);
  const int cols = min(kTile, n - j0);
  unsigned long long bits = 0;
  for (int k = col_tile == row_tile ? t + 1 : 0; k < cols; ++k) {
    if (suppresses(a, area_a, col_box[k], col_area[k], thr)) bits |= 1ull << k;
  }
  mask[(int64_t)i * words + col_tile] = bits;
}

// the OR of a 64-bit value over the warp's lanes
__device__ __forceinline__ unsigned long long or_across(const unsigned long long v) {
  return (unsigned long long)__reduce_or_sync(kFull, (unsigned)(v >> 32)) << 32 |
         __reduce_or_sync(kFull, (unsigned)v);
}

// warp 0's registers for one tile: lane l holds rows 64 c + l and 64 c + 32 + l
struct TileRows {
  unsigned long long diag[2];   // their words c: suppressions inside the tile
  unsigned long long next[2];   // their words c + 1
  int64_t idx[2];               // their original indices
  float score[2];
};

__device__ __forceinline__ void fetch_rows(TileRows& t, const int c, const int lane,
                                           const float* __restrict__ scores,
                                           const int64_t* __restrict__ order,
                                           const unsigned long long* __restrict__ mask,
                                           const int n, const int words) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = c * kTile + 32 * h + lane;
    const bool in = r < n;
    const int64_t row = (int64_t)r * words;
    t.diag[h] = in ? mask[row + c] : 0;
    t.next[h] = in && c + 1 < words ? mask[row + c + 1] : 0;
    t.idx[h] = in ? order[r] : 0;
    t.score[h] = in ? scores[r] : 0.0f;
  }
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const float* __restrict__ scores, const int64_t* __restrict__ order,
                const unsigned long long* __restrict__ mask, const int n, const int words,
                const int max_out, int64_t* __restrict__ keep_idx,
                float* __restrict__ keep_score, bool* __restrict__ keep_valid) {
  constexpr int kHelpers = kScanThreads - 32;   // warps 1..: the later words
  constexpr int kInFlight = 16;
  __shared__ unsigned long long removed[kMaxWords];
  // by tile parity: warp 0 writes slot c & 1 at tile c; every thread reads
  // s_total after tile c's barrier, the helpers kept_rows and s_kept at
  // tile c + 1; the slot is written again at tile c + 2, past a barrier
  __shared__ int kept_rows[2][kTile];
  __shared__ int s_kept[2], s_total[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool scanner = tid < 32;   // warp 0

  // absent boxes (score not above -inf) and those past n start removed;
  // bit k of word w is box 64 w + k, and each warp fills 32 bits a step
  unsigned* const halves = reinterpret_cast<unsigned*>(removed);
  for (int i = tid; i < words * kTile; i += kScanThreads) {
    const unsigned bits = __ballot_sync(kFull, i >= n || !(scores[i] > neg_inf()));
    if (lane == 0) halves[i >> 5] = bits;
  }
  TileRows cur = {}, nxt = {};
  if (scanner && words > 0) fetch_rows(cur, 0, lane, scores, order, mask, n, words);
  unsigned long long carry = 0;   // the previous tile's kept rows' bits in this one
  __syncthreads();

  int total = 0;   // boxes kept so far, the same in every thread
  for (int c = 0; c < words; ++c) {
    const int slot = c & 1;
    if (scanner) {
      if (c + 1 < words) fetch_rows(nxt, c + 1, lane, scores, order, mask, n, words);
      // the tile's greedy keep set: the fixpoint of kept = open & ~(boxes a
      // kept one suppresses), reached from kept = open in as many steps as
      // its longest chain of suppressions (a box's fate depends only on the
      // boxes before it), each step the OR of the kept rows' words
      const unsigned long long open = ~(removed[c] | carry);
      unsigned long long kept = open;
      for (;;) {
        const unsigned long long mine = ((kept >> lane) & 1 ? cur.diag[0] : 0) |
                                        ((kept >> (32 + lane)) & 1 ? cur.diag[1] : 0);
        const unsigned long long next = open & ~or_across(mine);
        if (next == kept) break;
        kept = next;
      }
      // the greedy set is prefix-stable: past max_out, keep its lowest boxes
      for (int extra = total + __popcll(kept) - max_out; extra > 0; --extra) {
        kept &= ~(1ull << (63 - __clzll((long long)kept)));
      }
      const int count = total + __popcll(kept);
      unsigned long long ahead = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 32 * h + lane;
        if ((kept >> k) & 1) {
          const int rank = __popcll(kept & ((1ull << k) - 1));
          const int r = total + rank;
          keep_idx[r] = cur.idx[h];
          keep_score[r] = cur.score[h];
          keep_valid[r] = true;
          kept_rows[slot][rank] = c * kTile + k;
          ahead |= cur.next[h];
        }
      }
      carry = or_across(ahead);
      if (lane == 0) {
        s_kept[slot] = count - total;
        s_total[slot] = count;
      }
      cur = nxt;
    } else if (c > 0) {
      // the previous tile's kept rows in the words after this tile's next
      // pair p = (kept row p / span, word w0 + p % span); this thread takes
      // p = tid - 32 + j kHelpers, stepping row and word without a division
      const int nk = s_kept[slot ^ 1];
      const int w0 = c + 1;
      const int span = words - w0;
      const int pairs = nk * span;
      if (tid - 32 < pairs) {
        const int step_q = kHelpers / span, step_w = kHelpers % span;
        int q = (tid - 32) / span, w = (tid - 32) % span;
        for (int p0 = tid - 32; p0 < pairs; p0 += kHelpers * kInFlight) {
          unsigned long long v[kInFlight];
          int at[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            at[u] = w0 + w;
            v[u] = q < nk ? mask[(int64_t)kept_rows[slot ^ 1][q] * words + at[u]] : 0;
            q += step_q;
            w += step_w;
            if (w >= span) {
              w -= span;
              ++q;
            }
          }
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            if (v[u] != 0) atomicOr(&removed[at[u]], v[u]);
          }
        }
      }
    }
    __syncthreads();
    total = s_total[slot];
    if (total >= max_out) break;
  }
  for (int r = total + tid; r < max_out; r += kScanThreads) {
    keep_idx[r] = 0;
    keep_score[r] = neg_inf();
    keep_valid[r] = false;
  }
}

}  // namespace

// sorted_boxes (n, 4) and sorted_scores (n,) float32 and order (n,) int64
// (the sort's indices), contiguous, boxes 16-byte aligned; mask n x words
// int64 with words = ceil(n / 64) (scratch); keep_idx (max_out,) int64,
// keep_score (max_out,) float32, keep_valid (max_out,) bool. Returns
// cudaGetLastError() after the launches (0 on success); -1 on bad arguments.
extern "C" int htd_nms(const void* sorted_boxes, const void* sorted_scores, const void* order,
                       int n, float iou_threshold, int max_out, void* mask, void* keep_idx,
                       void* keep_score, void* keep_valid, cudaStream_t stream) {
  const int words = (n + kTile - 1) / kTile;
  if (n < 0 || max_out < 1 || words > kMaxWords) return -1;
  unsigned long long* m = static_cast<unsigned long long*>(mask);
  if (n > 0) {
    const unsigned tiles = (unsigned)words * (words + 1) / 2;   // the upper triangle's
    nms_mask_kernel<<<tiles, kTile, 0, stream>>>(static_cast<const float4*>(sorted_boxes), n,
                                                  words, iou_threshold, m);
  }
  nms_scan_kernel<<<1, kScanThreads, 0, stream>>>(
      static_cast<const float*>(sorted_scores), static_cast<const int64_t*>(order), m, n, words,
      max_out, static_cast<int64_t*>(keep_idx), static_cast<float*>(keep_score),
      static_cast<bool*>(keep_valid));
  return (int)cudaGetLastError();
}
