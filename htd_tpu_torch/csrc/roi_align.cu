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
// Function: mmcv RoIAlign (aligned=True) with the adaptive grid clamped at
// max_samples, each bin the sum of its bilinear samples / max(grid_h *
// grid_w, 1). The sample geometry is in roi_align_geom.cuh, shared with the
// backward kernel K4 (roi_align_bwd.cu).
//
// Bound on the H100: bytes. Per output element it does up to 4 * S^2
// multiply-adds (S <= 4), far below the card's float32 rate, while every
// sample reads four corner pixels of C channels. Design: one block per roi
// (per (roi, level) in the all-level pass); threads along (bin, channel
// vector) so that a warp reads each corner pixel's channels as contiguous
// 16-byte vectors; sums in float32 registers; the corner rows of neighbouring
// samples and rois mostly hit L1/L2, so DRAM traffic is close to the output
// plus the distinct feature pixels touched.

#include "roi_align_geom.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
roi_align_fwd_kernel(const T* __restrict__ pyr, const float* __restrict__ rois,
                     const int* __restrict__ roi_levels, T* __restrict__ out,
                     const AlignParams p) {
  constexpr int N = Vec<T>::N;
  const int n = blockIdx.x;
  const int level = roi_levels != nullptr ? roi_levels[n] : (int)blockIdx.y;
  const RoiGeom r = roi_geom(rois, n, level, p);
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
    for (int iy = 0; iy < r.grid_h; ++iy) {
      const AxisSample ay = axis_sample(r.start_h, r.bin_h, ph, iy, r.gh, r.size_h);
      if (!ay.inside) continue;
      const T* row_lo = pyr + ((r.row_base + ay.low) * p.w_pad) * C + c0;
      const T* row_hi = pyr + ((r.row_base + ay.high) * p.w_pad) * C + c0;
      for (int ix = 0; ix < r.grid_w; ++ix) {
        const AxisSample ax = axis_sample(r.start_w, r.bin_w, pw, ix, r.gw, r.size_w);
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
    for (int k = 0; k < N; ++k) acc[k] = __fdiv_rn(acc[k], r.count);
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
  AlignParams p;
  if (!fill_params(p, level_scale, level_h, level_w, level_row_off, num_levels, n_rois,
                   rois_per_img, img_rows, w_pad, channels, out_size, sampling_ratio,
                   max_samples, dtype)) {
    return -1;
  }
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
