// Shared by K2 (roi_align.cu) and K4 (roi_align_bwd.cu): the pyramid's
// level table, channel vectors, the RoIAlign sample geometry, and the
// per-roi corner tables that both kernels fold their samples through.
//
// Geometry (mmcv RoIAlign, aligned=True; the JAX `_sample_geometry`):
//   start = x1 * scale - 0.5;  bin = (x2 - x1) * scale / out
//   grid  = sampling_ratio > 0 ? sampling_ratio : clamp(ceil(bin), 0, max_samples)
//   sample p, i: start + (p + (i + 0.5) / max(grid, 1)) * bin
//   inside when coord in [-1, size]; cc = max(coord, 0);
//   low = min(floor(cc), size - 1); high = min(low + 1, size - 1);
//   frac = cc >= size - 1 ? 0 : cc - low
// It uses the round-to-nearest intrinsics so that nvcc cannot contract it
// into FMAs: ceil(bin) is discontinuous, and a one-ulp change would change
// the grid count. K2 and K4 share it, so K4 is the exact transpose of K2.
//
// The fold. A corner's bilinear weight is w_y * w_x and a sample is live
// when it is inside on both axes, so for one roi
//   out[ph, pw, :] = (1 / count) * sum_r Wy[ph, r] * sum_x Wx[pw, x] * F[r, x, :]
// where r and x run over the roi's distinct corner rows and columns and
// Wy[ph, r] sums the weights of bin ph's live y-samples whose corner is row
// r (Wx likewise). `build_tables` computes each axis's out * grid samples
// once per block with `axis_sample` and keeps, in shared memory, the
// distinct live corner indices (sorted) and per bin its run of them with
// the folded weights; K4 also gets the transpose, per index its (bin,
// weight) entries.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;

struct LevelGeom {
  float scale;
  int h, w, row_off;
};

struct AlignParams {
  LevelGeom lv[kMaxLevels];
  int num_levels, n_rois, rois_per_img, img_rows, w_pad, channels;
  int out_size, sampling_ratio, max_samples;
  int samples;  // the grid's largest value on either axis: sampling_ratio, or max_samples
};

constexpr int kThreads = 256;      // both kernels; threads [0, 128) build y, [128, 256) x
constexpr int kAxisThreads = 128;  // so an axis has at most 128 corner candidates
constexpr int kMaxOut = 8;         // out_size <= 8 and out_size * samples <= 64

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ __forceinline__ static Raw load_raw(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  // s += w * x, channel by channel
  __device__ __forceinline__ static void fma(float (&s)[N], float w, const Raw& x) {
    s[0] += w * x.x; s[1] += w * x.y; s[2] += w * x.z; s[3] += w * x.w;
  }
  __device__ __forceinline__ static void load(const float* p, float (&v)[N]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ __forceinline__ static Raw load_raw(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void fma(float (&s)[N], float w, const Raw& x) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      s[2 * k] += w * f.x;
      s[2 * k + 1] += w * f.y;
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&v)[N]) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = x;
  }
};

// One axis of one sample: corner indices, weights, inside flag.
struct AxisSample {
  int low, high;
  float w_low, w_high;
  bool inside;
};

__device__ __forceinline__ AxisSample axis_sample(float start, float bin, int p, int i,
                                                  float g, float size) {
  const float t = __fadd_rn((float)p, __fdiv_rn(__fadd_rn((float)i, 0.5f), g));
  const float coord = __fadd_rn(start, __fmul_rn(t, bin));
  AxisSample a;
  a.inside = coord >= -1.0f && coord <= size;
  const float cc = fmaxf(coord, 0.0f);
  const float low = fminf(floorf(cc), __fsub_rn(size, 1.0f));
  const float high = fminf(__fadd_rn(low, 1.0f), __fsub_rn(size, 1.0f));
  const float frac = cc >= __fsub_rn(size, 1.0f) ? 0.0f : __fsub_rn(cc, low);
  a.low = (int)low;
  a.high = (int)high;
  a.w_low = __fsub_rn(1.0f, frac);
  a.w_high = frac;
  return a;
}

// One roi on one level: sample origin, bin extent, grid, and the level's
// size and first pyramid row of the roi's image.
struct RoiGeom {
  float start_w, start_h, bin_w, bin_h, gw, gh, count, inv_count, size_w, size_h;
  int grid_w, grid_h;
  int64_t row_base;
};

__device__ __forceinline__ RoiGeom roi_geom(const float* __restrict__ rois, int n, int level,
                                            const AlignParams& p) {
  // select with constant indices: indexing the parameter struct by `level`
  // would copy it to local memory in every thread
  LevelGeom g = p.lv[0];
#pragma unroll
  for (int k = 1; k < kMaxLevels; ++k) {
    if (k == level) g = p.lv[k];
  }
  const float x1 = rois[4 * n + 0], y1 = rois[4 * n + 1];
  const float x2 = rois[4 * n + 2], y2 = rois[4 * n + 3];
  const float o = (float)p.out_size;
  RoiGeom r;
  r.start_w = __fsub_rn(__fmul_rn(x1, g.scale), 0.5f);
  r.start_h = __fsub_rn(__fmul_rn(y1, g.scale), 0.5f);
  r.bin_w = __fdiv_rn(__fmul_rn(__fsub_rn(x2, x1), g.scale), o);
  r.bin_h = __fdiv_rn(__fmul_rn(__fsub_rn(y2, y1), g.scale), o);
  if (p.sampling_ratio > 0) {
    r.grid_w = r.grid_h = p.sampling_ratio;
  } else {
    const float smax = (float)p.max_samples;
    r.grid_w = (int)fminf(fmaxf(ceilf(r.bin_w), 0.0f), smax);
    r.grid_h = (int)fminf(fmaxf(ceilf(r.bin_h), 0.0f), smax);
  }
  r.gw = (float)max(r.grid_w, 1);
  r.gh = (float)max(r.grid_h, 1);
  r.count = (float)max(r.grid_h * r.grid_w, 1);
  r.inv_count = __frcp_rn(r.count);
  r.size_w = (float)g.w;
  r.size_h = (float)g.h;
  r.row_base = (int64_t)(n / p.rois_per_img) * p.img_rows + g.row_off;
  return r;
}

// x / count: the product with count's correctly rounded reciprocal and one
// FMA correction of its residual (Markstein), within an ulp of the correctly
// rounded quotient at a few instructions, where __fdiv_rn takes a dozen.
__device__ __forceinline__ float div_count(float x, const RoiGeom& r) {
  const float q = __fmul_rn(x, r.inv_count);
  return __fmaf_rn(__fmaf_rn(-q, r.count, x), r.inv_count, q);
}

// One axis's corner tables in shared memory, for one roi. `nc` = 2 * out *
// samples candidates (sample p * grid + i, corner low / high).
//
// The sample coordinates of an axis are monotone in sample order
// (non-decreasing where bin >= 0, else non-increasing; round-to-nearest
// keeps that), and so are the corners. With each sample's corners taken in
// the same direction (low, high where bin >= 0; high, low otherwise), the
// distinct indices, in order of first appearance, come out sorted, and the
// live corners of one bin cover a contiguous run of them: a bin's entries
// are the slots b_lo[p] .. b_lo[p] + e_n[p] - 1.
struct AxisTables {
  int* cand;     // [nc] each candidate's row or column
  float* w;      // [nc] its weight, 0 for a dead sample
  int* slot;     // [nc] the slot of its index in `idx` (live candidates)
  int* idx;      // [nc] the distinct indices of live candidates, `*n` of them
  int* n;
  int* b_lo;     // [out] per bin: its first slot
  int* e_n;      // [out] per bin: its number of slots
  float* e_w;    // [out][2 * samples] per bin: the folded weight of each slot
  int* t_bin;    // [nc][out] per slot: the bins that read it (transposed only)
  float* t_w;    // [nc][out]
  int* t_n;      // [nc]
};

// 4-byte words of one axis's tables; the host sizes shared memory with it.
__host__ __device__ inline int axis_words(int out, int samples, bool transposed) {
  const int nc = 2 * out * samples;
  return 5 * nc + 1 + 2 * out + (transposed ? 2 * nc * out + nc : 0);
}

__device__ inline AxisTables carve_axis(int*& p, int out, int samples, bool transposed) {
  const int nc = 2 * out * samples;
  AxisTables a;
  a.cand = p; p += nc;
  a.w = reinterpret_cast<float*>(p); p += nc;
  a.slot = p; p += nc;
  a.idx = p; p += nc;
  a.n = p; p += 1;
  a.b_lo = p; p += out;
  a.e_n = p; p += out;
  a.e_w = reinterpret_cast<float*>(p); p += nc;
  a.t_bin = a.t_n = nullptr;
  a.t_w = nullptr;
  if (transposed) {
    a.t_bin = p; p += nc * out;
    a.t_w = reinterpret_cast<float*>(p); p += nc * out;
    a.t_n = p; p += nc;
  }
  return a;
}

// Builds both axes' tables; every thread of the (kThreads-thread) block
// calls it. warp_n holds kThreads / 32 ints of scratch. The geometry of
// each sample is computed once, by one thread, with `axis_sample`.
__device__ inline void build_tables(const AxisTables ya, const AxisTables xa,
                                    const RoiGeom& r, int out, int samples,
                                    bool transposed, int* warp_n) {
  const int t = threadIdx.x;
  const bool is_x = t >= kAxisThreads;
  const int j = is_x ? t - kAxisThreads : t;
  // a copy, selected field by field in registers: a reference to one of
  // two structs would put both in local memory
  const AxisTables a = is_x ? xa : ya;
  const int grid = is_x ? r.grid_w : r.grid_h;
  const bool asc = (is_x ? r.bin_w : r.bin_h) >= 0.0f;
  const int nsamp = out * grid, nc = 2 * nsamp, cap = 2 * samples;
  if (j < nsamp) {
    const int p = j / grid, i = j - p * grid;
    const AxisSample s = is_x ? axis_sample(r.start_w, r.bin_w, p, i, r.gw, r.size_w)
                              : axis_sample(r.start_h, r.bin_h, p, i, r.gh, r.size_h);
    // the corners in the axis's direction: low first where asc, else high
    const int f = asc ? 0 : 1;
    a.cand[2 * j + f] = s.low;
    a.cand[2 * j + 1 - f] = s.high;
    a.w[2 * j + f] = s.inside ? s.w_low : 0.0f;
    a.w[2 * j + 1 - f] = s.inside ? s.w_high : 0.0f;
  }
  __syncthreads();
  // a live candidate leads its index if no earlier live candidate has it;
  // scanning back, no sample before one whose second corner lies past the
  // index (below it where asc, above it otherwise) has it either
  bool leader = false;
  int v = 0;
  if (j < nc && a.w[j] != 0.0f) {
    v = a.cand[j];
    leader = !((j & 1) && a.w[j - 1] != 0.0f && a.cand[j - 1] == v);
    for (int k = (j >> 1) - 1; leader && k >= 0; --k) {
      const int c0 = a.cand[2 * k], c1 = a.cand[2 * k + 1];
      if ((c0 == v && a.w[2 * k] != 0.0f) || (c1 == v && a.w[2 * k + 1] != 0.0f)) {
        leader = false;
      } else if (asc ? c1 < v : c1 > v) {
        break;
      }
    }
  }
  const unsigned ball = __ballot_sync(0xffffffffu, leader);
  const int lane = t & 31, warp = t >> 5;
  if (lane == 0) warp_n[warp] = __popc(ball);
  __syncthreads();
  const int w0 = is_x ? kAxisThreads / 32 : 0;
  int n = 0;
  for (int w = w0; w < w0 + kAxisThreads / 32; ++w) {
    if (w == warp) n += __popc(ball & ((1u << lane) - 1u));
    else if (w < warp) n += warp_n[w];
  }
  if (leader) {
    a.slot[j] = n;
    a.idx[n] = v;
  }
  if (j == 0) {
    int total = 0;
    for (int w = w0; w < w0 + kAxisThreads / 32; ++w) total += warp_n[w];
    *a.n = total;
  }
  __syncthreads();
  // the others find their index's slot in the sorted idx
  if (j < nc && a.w[j] != 0.0f && !leader) {
    int lo = 0, hi = *a.n - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (asc ? a.idx[mid] < v : a.idx[mid] > v) lo = mid + 1;
      else hi = mid;
    }
    a.slot[j] = lo;
  }
  __syncthreads();
  // per bin: the run of slots its live candidates cover
  if (j < out) {
    int lo = 0x7fffffff, hi = -1;
    for (int k = 2 * j * grid; k < 2 * (j + 1) * grid; ++k) {
      if (a.w[k] == 0.0f) continue;
      lo = min(lo, a.slot[k]);
      hi = max(hi, a.slot[k]);
    }
    a.b_lo[j] = hi < 0 ? 0 : lo;
    a.e_n[j] = hi < 0 ? 0 : hi - lo + 1;
  }
  __syncthreads();
  // per (bin, slot of the run): the bin's weights on it, in sample order
  if (j < out * cap) {
    const int p = j / cap, e = j - p * cap;
    if (e < a.e_n[p]) {
      const int sl = a.b_lo[p] + e;
      float sum = 0.0f;
      for (int k = 2 * p * grid; k < 2 * (p + 1) * grid; ++k) {
        if (a.w[k] != 0.0f && a.slot[k] == sl) sum = __fadd_rn(sum, a.w[k]);
      }
      a.e_w[j] = sum;
    }
  }
  if (transposed) {
    __syncthreads();
    if (j < *a.n) {
      int m = 0;
      for (int p = 0; p < out; ++p) {
        const int e = j - a.b_lo[p];
        if (e >= 0 && e < a.e_n[p]) {
          a.t_bin[j * out + m] = p;
          a.t_w[j * out + m] = a.e_w[p * cap + e];
          ++m;
        }
      }
      a.t_n[j] = m;
    }
  }
  __syncthreads();
}

// Fills the kernel parameters from the host's per-level arrays; false on
// arguments the kernels do not take.
inline bool fill_params(AlignParams& p, const float* level_scale, const int* level_h,
                        const int* level_w, const int* level_row_off, int num_levels,
                        int n_rois, int rois_per_img, int img_rows, int w_pad, int channels,
                        int out_size, int sampling_ratio, int max_samples, int dtype) {
  if (num_levels < 1 || num_levels > kMaxLevels || n_rois < 1 || rois_per_img < 1) return false;
  const int vec = dtype == 0 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  if (channels % vec != 0 || (dtype != 0 && dtype != 1)) return false;
  const int samples = sampling_ratio > 0 ? sampling_ratio : max_samples;
  if (out_size < 1 || out_size > kMaxOut || samples < 1 || out_size * samples > 64) return false;
  for (int k = 0; k < num_levels; ++k) {
    p.lv[k].scale = level_scale[k];
    p.lv[k].h = level_h[k];
    p.lv[k].w = level_w[k];
    p.lv[k].row_off = level_row_off[k];
  }
  p.num_levels = num_levels;
  p.n_rois = n_rois;
  p.rois_per_img = rois_per_img;
  p.img_rows = img_rows;
  p.w_pad = w_pad;
  p.channels = channels;
  p.out_size = out_size;
  p.sampling_ratio = sampling_ratio;
  p.max_samples = max_samples;
  p.samples = samples;
  return true;
}

}  // namespace
