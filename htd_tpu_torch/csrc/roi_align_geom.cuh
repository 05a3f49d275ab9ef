// Shared by K2 (roi_align.cu) and K4 (roi_align_bwd.cu): the pyramid's
// level table, channel vectors, and the RoIAlign sample geometry.
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
};

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
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
  float start_w, start_h, bin_w, bin_h, gw, gh, count, size_w, size_h;
  int grid_w, grid_h;
  int64_t row_base;
};

__device__ __forceinline__ RoiGeom roi_geom(const float* __restrict__ rois, int n, int level,
                                            const AlignParams& p) {
  const LevelGeom g = p.lv[level];
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
  r.size_w = (float)g.w;
  r.size_h = (float)g.h;
  r.row_base = (int64_t)(n / p.rois_per_img) * p.img_rows + g.row_off;
  return r;
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
  return true;
}

}  // namespace
