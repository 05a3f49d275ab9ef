// K4: the feature gradient of K2 (RoIAlign backward), accumulated into a
// float32 gradient of the K1 pyramid.
//
// Replaces the TPU kernel `roi_align_pallas_v4_bwd`
// (htd_tpu/ops/roi_align_pallas.py, used by
// `roi_align_fused_batched_grad_feats`) and, in the all-level mode, the BA
// pass's corner-folded XLA scatter (`levels_pyramid_grad_feats`,
// htd_tpu/ops/roi_align.py). The TPU kernel re-gridded the transposed tent
// matrices over output blocks with 16 roi slots per bin, a window-coverage
// limit and a capped folded-scatter fallback; the rois beyond the cap lost
// their gradient. Here nothing is capped: every sample corner of every roi
// adds its share with an atomic, so the result is exact for every roi.
//
// Function: for roi n on level l(n), bin (ph, pw) and each sample (iy <
// grid_h, ix < grid_w) inside [-1, size], add w_corner * g[n, ph, pw, :] /
// max(grid_h * grid_w, 1) to each of its 4 bilinear corners. The geometry
// (roi_align_geom.cuh) is K2's, so K4 is K2's exact transpose in float32.
// With roi_levels == nullptr, g is (L, n_rois, out, out, C) and grid.y runs
// over the levels, as in K2's all-level pass.
//
// Bound on the H100: bytes. Per corner it does one multiply and one add per
// channel; it must read g once, zero the float32 accumulation buffer, and
// read and write each distinct touched pyramid pixel once. Design: one block
// per roi (per (roi, level) in the all-level pass), threads along (bin,
// channel vector) as in K2: a thread loads its bin's channel vector of g
// once, divides it by the count, then for each sample corner with a
// non-zero weight adds weight * g with 16-byte vector atomics (float4
// `atomicAdd` in global memory, sm_90) into neighbouring channels of one
// pixel, so a warp's atomics hit contiguous 512-byte rows in L2. Bins whose
// cotangent vector is all zero (padding and zero-weight rois) add nothing.
// The atomics sum in an order that changes from run to run; the result
// agrees with the plain version to float32 rounding. The accumulator is a
// float32 copy of the whole padded pyramid rather than per-level buffers:
// it is the gradient of the buffer K2 read, with K2's addressing, and its
// padding costs about 0.07 ms more zeroing per call at batch 2, 800x1344.

#include "roi_align_geom.cuh"

namespace {

template <int N>
__device__ __forceinline__ void add_scaled(float* __restrict__ dst, float w, const float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N; q += 4) {
    // float4 atomicAdd on global memory: sm_90, CUDA 12.1 and later
    atomicAdd(reinterpret_cast<float4*>(dst + q),
              make_float4(__fmul_rn(w, v[q]), __fmul_rn(w, v[q + 1]),
                          __fmul_rn(w, v[q + 2]), __fmul_rn(w, v[q + 3])));
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
roi_align_bwd_kernel(const T* __restrict__ g, const float* __restrict__ rois,
                     const int* __restrict__ roi_levels, float* __restrict__ d_pyr,
                     const AlignParams p) {
  constexpr int N = Vec<T>::N;
  const int n = blockIdx.x;
  const int level = roi_levels != nullptr ? roi_levels[n] : (int)blockIdx.y;
  const RoiGeom r = roi_geom(rois, n, level, p);
  if (r.grid_w == 0 || r.grid_h == 0) return;
  const int C = p.channels;
  const int cvecs = C / N;
  const int nbins = p.out_size * p.out_size;
  const int64_t g_roi = roi_levels != nullptr ? n : (int64_t)level * p.n_rois + n;
  const T* src = g + g_roi * nbins * C;

  for (int t = threadIdx.x; t < nbins * cvecs; t += blockDim.x) {
    const int bin = t / cvecs;
    const int c0 = (t - bin * cvecs) * N;
    const int ph = bin / p.out_size, pw = bin - ph * p.out_size;
    float gv[N];
    Vec<T>::load(src + (int64_t)bin * C + c0, gv);
    bool any = false;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      gv[k] = __fdiv_rn(gv[k], r.count);
      any |= gv[k] != 0.0f;
    }
    if (!any) continue;
    for (int iy = 0; iy < r.grid_h; ++iy) {
      const AxisSample ay = axis_sample(r.start_h, r.bin_h, ph, iy, r.gh, r.size_h);
      if (!ay.inside) continue;
      float* row_lo = d_pyr + ((r.row_base + ay.low) * p.w_pad) * C + c0;
      float* row_hi = d_pyr + ((r.row_base + ay.high) * p.w_pad) * C + c0;
      for (int ix = 0; ix < r.grid_w; ++ix) {
        const AxisSample ax = axis_sample(r.start_w, r.bin_w, pw, ix, r.gw, r.size_w);
        if (!ax.inside) continue;
        const float w00 = __fmul_rn(ay.w_low, ax.w_low);
        const float w01 = __fmul_rn(ay.w_low, ax.w_high);
        const float w10 = __fmul_rn(ay.w_high, ax.w_low);
        const float w11 = __fmul_rn(ay.w_high, ax.w_high);
        if (w00 != 0.0f) add_scaled<N>(row_lo + (int64_t)ax.low * C, w00, gv);
        if (w01 != 0.0f) add_scaled<N>(row_lo + (int64_t)ax.high * C, w01, gv);
        if (w10 != 0.0f) add_scaled<N>(row_hi + (int64_t)ax.low * C, w10, gv);
        if (w11 != 0.0f) add_scaled<N>(row_hi + (int64_t)ax.high * C, w11, gv);
      }
    }
  }
}

}  // namespace

// g: (n_rois, out, out, C), or with roi_levels == nullptr (num_levels, n_rois,
// out, out, C), in `dtype` (0 = float32, 1 = bfloat16). d_pyr: the float32
// (rows_pad, w_pad, C) pyramid gradient, zeroed by the caller; K4 adds into
// it. Returns cudaGetLastError() after the launch (0 on success); -1 on bad
// arguments.
extern "C" int htd_roi_align_bwd(const void* g, const float* rois, const int* roi_levels,
                                 float* d_pyr, int n_rois, int rois_per_img,
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
    roi_align_bwd_kernel<float><<<grid, threads, 0, stream>>>(
        static_cast<const float*>(g), rois, roi_levels, d_pyr, p);
  } else {
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(g), rois, roi_levels, d_pyr, p);
  }
  return (int)cudaGetLastError();
}
