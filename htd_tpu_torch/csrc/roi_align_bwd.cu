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
// their gradient. Here nothing is capped, so the result is exact for every
// roi.
//
// Function: for roi n on level l(n), bin (ph, pw) and each sample (iy <
// grid_h, ix < grid_w) inside [-1, size], add w_corner * g[n, ph, pw, :] /
// max(grid_h * grid_w, 1) to each of its 4 bilinear corners. The geometry
// and the corner tables (roi_align_geom.cuh) are K2's. With roi_levels ==
// nullptr, g is (L, n_rois, out, out, C) and grid.z runs over the levels,
// as in K2's all-level pass.
//
// Design: the transpose of the fold (roi_align_geom.cuh), in its separable
// form. One block per (roi, 64-channel slice), per (roi, level, slice) in
// the all-level mode; the roi's samples are computed once per block
// (`build_tables`, with the transposed tables: per distinct row or column,
// the bins that read it). The block loads its g slice once, divided by the
// count, into shared memory; then, in chunks of distinct corner columns x,
//   U[ph][x][c] = sum_pw Wx[pw, x] * g[ph, pw, c] / count   (shared memory)
//   v[r][x][c]  = sum_ph Wy[ph, r] * U[ph][x][c]
// and adds v to pixel (r, x) of the float32 buffer with one 16-byte float4
// `atomicAdd` (sm_90) per (distinct pixel of the roi, 4 channels), where
// one per live sample corner would be about 4.5 times as many on a training
// step's rois (PERF.md). A v
// that is zero in all four channels (a zero cotangent: padding rois, bins
// with no gradient) adds nothing, and a slice whose cotangent is all zero
// returns before the folds. In exact arithmetic v is the plain version's
// sum of w_y * w_x * g / count over the live corners on (r, x), regrouped by
// row and column; only the float32 rounding order differs, and the atomics
// add the rois in an order that changes from run to run. The accumulator is
// a float32 copy of the whole padded pyramid rather than per-level buffers:
// it is the gradient of the buffer K2 read, with K2's addressing.
//
// Bound on the H100: bytes. It must read g once, zero the float32 buffer,
// and read and write each distinct touched pixel once; the multiply-adds
// are far below the float32 rate. What bounds the kernel now is the rate
// of its vector atomics in L2, one per (distinct pixel of a roi, 4
// channels): with every sample outside the image (g read, tables built, no
// atomics) it takes a fifth of its time (PERF.md). The caller's
// zeroing of the buffer (409 MB at batch 2, 800x1344) costs two thirds of
// a stage call's kernel time.

#include "roi_align_geom.cuh"

namespace {

constexpr int kSlice = 64;  // channels per block (fewer in a ragged last slice)

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_bwd_kernel(const T* __restrict__ g, const float* __restrict__ rois,
                     const int* __restrict__ roi_levels, float* __restrict__ d_pyr,
                     const AlignParams p, const int cols_chunk) {
  constexpr int N = Vec<T>::N;
  constexpr int kCv = kSlice / N;        // g's channel vectors in a full slice
  constexpr int kQ = kSlice / 4;         // float4 groups in a full slice
  constexpr int kPairs = kThreads / kQ;  // items of one float4 group per pass
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x;
  const int level = roi_levels != nullptr ? roi_levels[n] : (int)blockIdx.z;
  const RoiGeom r = roi_geom(rois, n, level, p);
  if (r.grid_w == 0 || r.grid_h == 0) return;
  const int C = p.channels, o = p.out_size, nbins = o * o;
  const int c_base = blockIdx.y * kSlice;
  const int slice_n = min(kSlice, C - c_base);
  const int q = threadIdx.x % kQ, pair0 = threadIdx.x / kQ;
  const bool q_live = 4 * q < slice_n;   // a ragged last slice leaves some idle

  float* gs = smem;                        // [nbins][kSlice]: g / count
  float* u = gs + nbins * kSlice;          // [o][cols_chunk][kSlice]
  int* words = reinterpret_cast<int*>(u + o * cols_chunk * kSlice);
  int* warp_n = words;
  words += kThreads / 32;
  const AxisTables ya = carve_axis(words, o, p.samples, true);
  const AxisTables xa = carve_axis(words, o, p.samples, true);

  const int64_t g_roi = roi_levels != nullptr ? n : (int64_t)level * p.n_rois + n;
  const T* src = g + g_roi * nbins * C + c_base;
  bool any = false;
  {
    const int cv = threadIdx.x % kCv;
    if (cv * N < slice_n) {
      for (int bin = threadIdx.x / kCv; bin < nbins; bin += kThreads / kCv) {
        float v[N];
        Vec<T>::load(src + (int64_t)bin * C + cv * N, v);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          v[k] = div_count(v[k], r);
          any |= v[k] != 0.0f;
        }
        float4* dst = reinterpret_cast<float4*>(gs + bin * kSlice + cv * N);
#pragma unroll
        for (int k = 0; k < N; k += 4) dst[k / 4] = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      }
    }
  }
  if (!__syncthreads_or(any)) return;
  build_tables(ya, xa, r, o, p.samples, true, warp_n);

  const int ny = *ya.n, nx = *xa.n;
  float* base = d_pyr + r.row_base * p.w_pad * C + c_base + 4 * q;
  for (int c0 = 0; c0 < nx; c0 += cols_chunk) {
    const int cn = min(cols_chunk, nx - c0);
    // U: one (bin row, column) per item
    for (int pr = pair0; pr < o * cn; pr += kPairs) {
      if (!q_live) break;
      const int ph = pr / cn, xc = pr - ph * cn;
      const int sl = c0 + xc;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int e = 0; e < xa.t_n[sl]; ++e) {
        const int pw = xa.t_bin[sl * o + e];
        const float w = xa.t_w[sl * o + e];
        const float4 v = *reinterpret_cast<const float4*>(gs + (ph * o + pw) * kSlice + 4 * q);
        acc.x += w * v.x;
        acc.y += w * v.y;
        acc.z += w * v.z;
        acc.w += w * v.w;
      }
      *reinterpret_cast<float4*>(u + (ph * cols_chunk + xc) * kSlice + 4 * q) = acc;
    }
    __syncthreads();
    // one atomic per (distinct pixel, 4 channels)
    for (int pr = pair0; pr < ny * cn; pr += kPairs) {
      if (!q_live) break;
      const int rr = pr / cn, xc = pr - rr * cn;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int e = 0; e < ya.t_n[rr]; ++e) {
        const int ph = ya.t_bin[rr * o + e];
        const float w = ya.t_w[rr * o + e];
        const float4 v =
            *reinterpret_cast<const float4*>(u + (ph * cols_chunk + xc) * kSlice + 4 * q);
        acc.x += w * v.x;
        acc.y += w * v.y;
        acc.z += w * v.z;
        acc.w += w * v.w;
      }
      if (acc.x == 0.0f && acc.y == 0.0f && acc.z == 0.0f && acc.w == 0.0f) continue;
      float* dst = base + ((int64_t)ya.idx[rr] * p.w_pad + xa.idx[c0 + xc]) * C;
      // float4 atomicAdd on global memory: sm_90, CUDA 12.1 and later
      atomicAdd(reinterpret_cast<float4*>(dst), acc);
    }
    __syncthreads();
  }
}

// Columns of U per chunk: 2 * out * samples (every column a roi can have)
// up to 16.
int bwd_cols_chunk(const AlignParams& p) {
  const int cols = 2 * p.out_size * p.samples;
  return cols < 16 ? cols : 16;
}

size_t bwd_smem_bytes(const AlignParams& p) {
  const size_t o = p.out_size;
  return sizeof(float) * ((o * o + o * bwd_cols_chunk(p)) * kSlice + kThreads / 32 +
                          2 * axis_words(p.out_size, p.samples, true));
}

template <typename T>
int launch_bwd(const T* g, const float* rois, const int* roi_levels, float* d_pyr,
               const AlignParams& p, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(p);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(p.n_rois, (p.channels + kSlice - 1) / kSlice,
            roi_levels != nullptr ? 1 : p.num_levels);
  roi_align_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(g, rois, roi_levels, d_pyr, p,
                                                             bwd_cols_chunk(p));
  return (int)cudaGetLastError();
}

}  // namespace

// g: (n_rois, out, out, C), or with roi_levels == nullptr (num_levels, n_rois,
// out, out, C), in `dtype` (0 = float32, 1 = bfloat16). d_pyr: the float32
// (rows_pad, w_pad, C) pyramid gradient, zeroed by the caller; K4 adds into
// it. Takes out_size <= 8 and out_size * samples <= 64, as K2. Returns
// cudaGetLastError() after the launch (0 on success); -1 on bad arguments.
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
  if (dtype == 0) {
    return launch_bwd(static_cast<const float*>(g), rois, roi_levels, d_pyr, p, stream);
  }
  return launch_bwd(static_cast<const __nv_bfloat16*>(g), rois, roi_levels, d_pyr, p, stream);
}
