// K2: exact level-mapped RoIAlign forward, read from the K1 pyramid.
//
// Replaces the TPU kernel `roi_align_pallas_v4` (htd_tpu/ops/roi_align_pallas.py,
// wrapped by `roi_align_fused_batched`). The TPU kernel walked spatial bins of
// the pyramid with a fixed number of roi slots per bin, spill bins and a
// capped gather fallback for rois that did not fit. None of that carries
// over: here each roi is computed on its own, so the result is exact for
// every roi. The same kernel serves the BA extractor's every-roi-on-every-
// level pass (an XLA gather on the TPU, `_levels_pyramid_impl`) when no
// per-roi levels are given: grid.y then runs over the levels.
//
// Function (mmcv RoIAlign, aligned=True; the JAX `_sample_geometry`):
//   start = x1 * scale - 0.5;  bin = (x2 - x1) * scale / out
//   grid  = sampling_ratio > 0 ? sampling_ratio : clamp(ceil(bin), 0, max_samples)
//   sample p, i: start + (p + (i + 0.5) / max(grid, 1)) * bin
//   inside when coord in [-1, size]; cc = max(coord, 0);
//   low = min(floor(cc), size - 1); high = min(low + 1, size - 1);
//   frac = cc >= size - 1 ? 0 : cc - low
//   out = sum of bilinear samples / max(grid_h * grid_w, 1)
// The geometry uses the round-to-nearest intrinsics so that nvcc cannot
// contract it into FMAs: ceil(bin) is discontinuous, and a one-ulp change
// would change the grid count.
//
// Bound on the H100: bytes. Per output element it does up to 4 * S^2
// multiply-adds (S <= 4), far below the card's float32 rate, while every
// sample reads four corner pixels of C channels. Design: one block per roi
// (per (roi, level) in the all-level pass); threads along (bin, channel
// vector) so that a warp reads each corner pixel's channels as contiguous
// 16-byte vectors; sums in float32 registers; the corner rows of neighbouring
// samples and rois mostly hit L1/L2, so DRAM traffic is close to the output
// plus the distinct feature pixels touched.

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

template <typename T>
__global__ void __launch_bounds__(256)
roi_align_fwd_kernel(const T* __restrict__ pyr, const float* __restrict__ rois,
                     const int* __restrict__ roi_levels, T* __restrict__ out,
                     const AlignParams p) {
  constexpr int N = Vec<T>::N;
  const int n = blockIdx.x;
  const int level = roi_levels != nullptr ? roi_levels[n] : (int)blockIdx.y;
  const LevelGeom g = p.lv[level];
  const int img = n / p.rois_per_img;
  const float x1 = rois[4 * n + 0], y1 = rois[4 * n + 1];
  const float x2 = rois[4 * n + 2], y2 = rois[4 * n + 3];
  const float o = (float)p.out_size;
  const float start_w = __fsub_rn(__fmul_rn(x1, g.scale), 0.5f);
  const float start_h = __fsub_rn(__fmul_rn(y1, g.scale), 0.5f);
  const float bin_w = __fdiv_rn(__fmul_rn(__fsub_rn(x2, x1), g.scale), o);
  const float bin_h = __fdiv_rn(__fmul_rn(__fsub_rn(y2, y1), g.scale), o);
  int grid_w, grid_h;
  if (p.sampling_ratio > 0) {
    grid_w = grid_h = p.sampling_ratio;
  } else {
    const float smax = (float)p.max_samples;
    grid_w = (int)fminf(fmaxf(ceilf(bin_w), 0.0f), smax);
    grid_h = (int)fminf(fmaxf(ceilf(bin_h), 0.0f), smax);
  }
  const float gw = (float)max(grid_w, 1), gh = (float)max(grid_h, 1);
  const float count = (float)max(grid_h * grid_w, 1);
  const float size_w = (float)g.w, size_h = (float)g.h;
  const int64_t row_base = (int64_t)img * p.img_rows + g.row_off;
  const int C = p.channels;
  const int cvecs = C / N;
  const int nbins = p.out_size * p.out_size;
  const int64_t out_roi = roi_levels != nullptr ? n : (int64_t)level * p.n_rois + n;
  T* dst = out + out_roi * nbins * C;

  for (int t = threadIdx.x; t < nbins * cvecs; t += blockDim.x) {
    const int bin = t / cvecs;
    const int c0 = (t - bin * cvecs) * N;
    const int ph = bin / p.out_size, pw = bin - ph * p.out_size;
    float acc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = 0.0f;
    for (int iy = 0; iy < grid_h; ++iy) {
      const AxisSample ay = axis_sample(start_h, bin_h, ph, iy, gh, size_h);
      if (!ay.inside) continue;
      const T* row_lo = pyr + ((row_base + ay.low) * p.w_pad) * C + c0;
      const T* row_hi = pyr + ((row_base + ay.high) * p.w_pad) * C + c0;
      for (int ix = 0; ix < grid_w; ++ix) {
        const AxisSample ax = axis_sample(start_w, bin_w, pw, ix, gw, size_w);
        if (!ax.inside) continue;
        const float w00 = __fmul_rn(ay.w_low, ax.w_low);
        const float w01 = __fmul_rn(ay.w_low, ax.w_high);
        const float w10 = __fmul_rn(ay.w_high, ax.w_low);
        const float w11 = __fmul_rn(ay.w_high, ax.w_high);
        float v00[N], v01[N], v10[N], v11[N];
        Vec<T>::load(row_lo + (int64_t)ax.low * C, v00);
        Vec<T>::load(row_lo + (int64_t)ax.high * C, v01);
        Vec<T>::load(row_hi + (int64_t)ax.low * C, v10);
        Vec<T>::load(row_hi + (int64_t)ax.high * C, v11);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          acc[k] += w00 * v00[k] + w01 * v01[k] + w10 * v10[k] + w11 * v11[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = __fdiv_rn(acc[k], count);
    Vec<T>::store(dst + (int64_t)bin * C + c0, acc);
  }
}

}  // namespace

// roi_levels == nullptr selects the all-level pass: out is then
// (num_levels, n_rois, out, out, C), else (n_rois, out, out, C).
// dtype: 0 = float32, 1 = bfloat16. Host arrays hold one entry per level.
// Returns cudaGetLastError() after the launch (0 on success); -1 on bad
// arguments.
extern "C" int htd_roi_align_fwd(const void* pyr, const float* rois, const int* roi_levels,
                                 void* out, int n_rois, int rois_per_img,
                                 const float* level_scale, const int* level_h,
                                 const int* level_w, const int* level_row_off,
                                 int num_levels, int img_rows, int w_pad, int channels,
                                 int out_size, int sampling_ratio, int max_samples,
                                 int dtype, cudaStream_t stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || n_rois < 1 || rois_per_img < 1) return -1;
  const int vec = dtype == 0 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  if (channels % vec != 0 || (dtype != 0 && dtype != 1)) return -1;
  AlignParams p;
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
  dim3 grid(n_rois, roi_levels != nullptr ? 1 : num_levels);
  const int threads = 256;
  if (dtype == 0) {
    roi_align_fwd_kernel<float><<<grid, threads, 0, stream>>>(
        static_cast<const float*>(pyr), rois, roi_levels, static_cast<float*>(out), p);
  } else {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(pyr), rois, roi_levels,
        static_cast<__nv_bfloat16*>(out), p);
  }
  return (int)cudaGetLastError();
}
