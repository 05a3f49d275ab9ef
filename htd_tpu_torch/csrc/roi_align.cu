// K2: exact level-mapped RoIAlign forward, read from the K1 pyramid.
//
// Replaces the TPU kernel `roi_align_pallas_v4` (htd_tpu/ops/roi_align_pallas.py,
// wrapped by `roi_align_fused_batched`). The TPU kernel walked spatial bins of
// the pyramid with a fixed number of roi slots per bin, spill bins and a
// capped gather fallback for rois that did not fit. None of that carries
// over: here each roi is computed on its own, so the result is exact for
// every roi. The same kernel serves the BA extractor's every-roi-on-every-
// level pass (an XLA gather on the TPU, `_levels_pyramid_impl`) when no
// per-roi levels are given: grid.z then runs over the levels.
//
// Function: mmcv RoIAlign (aligned=True) with the adaptive grid clamped at
// max_samples, each bin the sum of its bilinear samples / max(grid_h *
// grid_w, 1). The sample geometry and the corner tables are in
// roi_align_geom.cuh, shared with the backward kernel K4 (roi_align_bwd.cu).
//
// Design: the sample geometry once per roi, then each bin folded over its
// distinct corners. One block per roi (per (roi, level) in the all-level
// pass), all channels. The block computes the roi's out * grid samples per
// axis once (`build_tables`, roi_align_geom.cuh) into shared memory: the
// distinct corner rows and columns and, per bin, its run of them with the
// folded weights Wy[ph, r] (the sum of the bin's live y-sample weights on
// row r) and Wx[pw, x]. Each thread then takes one bin and two 16-byte
// channel vectors and sums Wy[ph, r] * Wx[pw, x] * F[r, x, :] over the
// bin's distinct rows r and columns x, four corners' loads issued together,
// and divides by the count. Because w_corner = w_y * w_x and a sample is
// live when it is inside on both axes, this is the plain version's sum over
// live sample corners with equal corners merged: the same function, only
// the float32 rounding order differs. A bin whose samples lie under a pixel
// apart has far fewer distinct corners than sample corners: about 25 where
// S = 4 has 64.
//
// Why not the separable form that the fold also allows (an x-pass of every
// distinct row into a float32 tile in shared memory, then a y-pass), which
// loads each of a roi's pixels about once: on the card it ran at less than
// half this kernel's speed, its tile costing occupancy and its extra
// barriers and passes more than the loads it saved (PERF.md).
//
// Bound on the H100: bytes. The work is at most 4 * S^2 multiply-adds per
// output element, far below the float32 rate; DRAM must see the outputs
// and each distinct feature pixel once. The kernel stays above that: the
// corner loads come from L2 (rois overlap, and a bin's corners are loaded
// once per bin, neighbouring bins sharing their border rows and columns),
// and the per-roi table build (a few barriers) is a fixed cost per block,
// which the all-level pass pays per (roi, level).

#include "roi_align_geom.cuh"

namespace {

// One block per roi (per (roi, level)) and all channels; each (bin, V
// channel vectors C / V apart) sums its bin's distinct corners, the run of
// distinct rows times the run of distinct columns, with weight Wy * Wx,
// kLoads corners (V loads each) issued together.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(const T* __restrict__ pyr, const float* __restrict__ rois,
                     const int* __restrict__ roi_levels, T* __restrict__ out,
                     const AlignParams p) {
  using Raw = typename Vec<T>::Raw;
  constexpr int N = Vec<T>::N;
  constexpr int kLoads = 4;
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x;
  const int level = roi_levels != nullptr ? roi_levels[n] : (int)blockIdx.z;
  const RoiGeom r = roi_geom(rois, n, level, p);
  const int C = p.channels, o = p.out_size, cap = 2 * p.samples;
  const int cstep = C / V, groups = cstep / N, nbins = o * o;

  int* words = reinterpret_cast<int*>(smem);
  int* warp_n = words;
  words += kThreads / 32;
  const AxisTables ya = carve_axis(words, o, p.samples, false);
  const AxisTables xa = carve_axis(words, o, p.samples, false);
  build_tables(ya, xa, r, o, p.samples, false, warp_n);

  const T* base = pyr + r.row_base * p.w_pad * C;
  const int64_t out_roi = roi_levels != nullptr ? n : (int64_t)level * p.n_rois + n;
  T* dst = out + out_roi * nbins * C;
  for (int it = threadIdx.x; it < nbins * groups; it += kThreads) {
    const int bin = it / groups, c0 = (it - bin * groups) * N;
    const int ph = bin / o, pw = bin - ph * o;
    const int y0 = ya.b_lo[ph], x0 = xa.b_lo[pw], xn = xa.e_n[pw];
    const int nk = ya.e_n[ph] * xn;
    float acc[V][N];
#pragma unroll
    for (int c = 0; c < V; ++c)
#pragma unroll
      for (int k = 0; k < N; ++k) acc[c][k] = 0.0f;
    int a = 0, b = 0;  // row and column (within the runs) of the next corner
    for (int k0 = 0; k0 < nk; k0 += kLoads) {
      Raw v[kLoads][V];
      float w[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (k0 + u < nk) {
          const T* px = base + ((int64_t)ya.idx[y0 + a] * p.w_pad + xa.idx[x0 + b]) * C + c0;
          w[u] = ya.e_w[ph * cap + a] * xa.e_w[pw * cap + b];
#pragma unroll
          for (int c = 0; c < V; ++c) v[u][c] = Vec<T>::load_raw(px + c * cstep);
          if (++b == xn) {
            b = 0;
            ++a;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (k0 + u < nk) {
#pragma unroll
          for (int c = 0; c < V; ++c) Vec<T>::fma(acc[c], w[u], v[u][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < V; ++c) {
#pragma unroll
      for (int k = 0; k < N; ++k) acc[c][k] = div_count(acc[c][k], r);
      Vec<T>::store(dst + (int64_t)bin * C + c0 + c * cstep, acc[c]);
    }
  }
}

template <typename T>
int launch_fwd(const T* pyr, const float* rois, const int* roi_levels, T* out,
               const AlignParams& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kThreads / 32 + 2 * axis_words(p.out_size, p.samples, false));
  dim3 grid(p.n_rois, 1, roi_levels != nullptr ? 1 : p.num_levels);
  if ((p.channels / Vec<T>::N) % 2 == 0) {
    roi_align_fwd_kernel<T, 2><<<grid, kThreads, smem, stream>>>(pyr, rois, roi_levels, out, p);
  } else {
    roi_align_fwd_kernel<T, 1><<<grid, kThreads, smem, stream>>>(pyr, rois, roi_levels, out, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// roi_levels == nullptr selects the all-level pass: out is then
// (num_levels, n_rois, out, out, C), else (n_rois, out, out, C).
// dtype: 0 = float32, 1 = bfloat16. Host arrays hold one entry per level.
// Takes out_size <= 8 and out_size * samples <= 64 (samples: sampling_ratio
// if > 0, else max_samples). Returns cudaGetLastError() after the launch (0
// on success); -1 on bad arguments.
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
  if (dtype == 0) {
    return launch_fwd(static_cast<const float*>(pyr), rois, roi_levels,
                      static_cast<float*>(out), p, stream);
  }
  return launch_fwd(static_cast<const __nv_bfloat16*>(pyr), rois, roi_levels,
                    static_cast<__nv_bfloat16*>(out), p, stream);
}
