// K3: deformable convolution v1 forward (mmcv DeformConv2d), 3x3.
//
// Replaces the TPU kernel `dcn_sample_conv_pallas`
// (htd_tpu/ops/dcn_pallas.py:131, reached through `dcn_conv_windowed` from
// `htd_tpu/ops/dcn.py::deform_conv2d`). The TPU kernel sampled by a
// windowed select-MAC over statically shifted VMEM views; samples whose
// floor left the window were only flagged, and the caller resolved at most
// FB_CAP flagged pixels per image exactly. None of that carries over: K3
// gathers the four bilinear corners of every sample directly, so it is
// exact for every offset.
//
// Function (the JAX `_dcn_xla_impl(impl="gather")`): each tap's bilinear
//   sample, with the corners and weights of deform_geom.cuh (shared with
//   the backward kernels K5 and K6, so that all three decide floor() and
//   the corner bounds alike); out[o] = sum_k sum_c sample(k, c) *
//   W[k][c - g*cg][o] over the input channels c of o's weight group g.
//   Layouts: x (N, H, W, Cin), offsets (N, Ho, Wo, 18) [tap][(y, x)],
//   weight in (Cout, 3, 3, Cin/groups) memory order (the channels_last
//   memory of the mmcv (Cout, Cin/groups, 3, 3) parameter, so the kernel
//   reads the module's weight as it is), out (N, Ho, Wo, Cout).
//   float32 or bfloat16 in and out, float32 sums.
//
// Bound on the H100: operations. Each output element takes 9 * Cin/groups
// multiply-adds; for R-101-DCN's 3x3 convs that is 1152-4608 per element
// against about 3 bytes moved, far above the card's ratio of operations to
// bytes. Design (CUDA cores, right first): one block per tile of 64 output
// pixels x 64 output channels of one image. For each tap, 64 threads
// compute the tile's corner indices and weights into shared memory; then,
// per chunk of 32 input channels, the block samples the tile's (pixel,
// channel) values into shared memory in float32 (16-byte corner loads)
// and stages the weight chunk beside them, and each thread accumulates a
// 4-pixel x 4-channel tile in registers. The sampled (Ho, Wo, 9, Cin)
// tensor never reaches device memory, which is what the TPU kernel fused
// too. With weight groups a block's input channels are the union of its
// output channels' groups, and each thread only runs over its own group.
// Tensor cores (mma / wgmma), TMA and pipelining are later work.

#include "deform_geom.cuh"

namespace {

constexpr int kPix = 64;      // output pixels per block
constexpr int kOut = 64;      // output channels per block
constexpr int kChunk = 32;    // input channels per shared-memory chunk
constexpr int kThreads = 256; // 16 pixel quads x 16 channel quads
static_assert(kChunk == 32 && kOut % 4 == 0 && kChunk * kOut % kThreads == 0,
              "the weight staging maps 8 channels x 4 out channels onto a warp");

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ offsets,
                       const T* __restrict__ weight, T* __restrict__ out,
                       const DcnParams p) {
  constexpr int V = Vec<T>::N;
  __shared__ __align__(16) float samp[kChunk][kPix];   // [channel][pixel]
  // [channel][out channel], rows padded by 4 so that the weight staging
  // below stores without bank conflicts
  __shared__ __align__(16) float wsm[kChunk][kOut + 4];
  __shared__ int corner_idx[4][kPix];
  __shared__ float corner_w[4][kPix];

  const int tid = threadIdx.x;
  const int img = blockIdx.z;
  const int npix = p.ho * p.wo;
  const int pix0 = blockIdx.x * kPix;
  const int co0 = blockIdx.y * kOut;
  const int co_end = min(co0 + kOut, p.cout);
  // input channels of the groups this block's output channels belong to
  const int ci_lo = (co0 / p.og) * p.cg;
  const int ci_hi = ((co_end - 1) / p.og + 1) * p.cg;

  // this thread's accumulator tile: pixels pq*4.., channels cq*4..
  const int pq = tid >> 4, cq = tid & 15;
  const int my_co = co0 + cq * 4;
  const bool co_ok = my_co < p.cout;
  const int my_g = co_ok ? my_co / p.og : 0;
  const int g_lo = my_g * p.cg, g_hi = g_lo + p.cg;

  const T* ximg = x + (int64_t)img * p.h * p.w * p.cin;
  const T* oimg = offsets + (int64_t)img * npix * (2 * kTaps);
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  for (int tap = 0; tap < kTaps; ++tap) {
    const int ky = tap / 3, kx = tap - ky * 3;
    if (tid < kPix) {
      const int pix = pix0 + tid;
      Corners c = no_corners();
      if (pix < npix) {
        const int oy = pix / p.wo, ox = pix - oy * p.wo;
        const float dy = Vec<T>::one(oimg + (int64_t)pix * (2 * kTaps) + 2 * tap);
        const float dx = Vec<T>::one(oimg + (int64_t)pix * (2 * kTaps) + 2 * tap + 1);
        c = sample_corners(oy, ox, ky, kx, dy, dx, p);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        corner_idx[q][tid] = c.idx[q];
        corner_w[q][tid] = c.w[q];
      }
    }
    __syncthreads();

    for (int c0 = ci_lo; c0 < ci_hi; c0 += kChunk) {
      // sample the chunk: item = (pixel fastest, channel vector)
      for (int item = tid; item < kPix * (kChunk / V); item += kThreads) {
        const int px = item % kPix, cv = item / kPix;
        const int c = c0 + cv * V;
        float s[V];
#pragma unroll
        for (int v = 0; v < V; ++v) s[v] = 0.0f;
        if (c < ci_hi) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float wq = corner_w[q][px];
            if (wq != 0.0f) {
              float val[V];
              Vec<T>::load(ximg + (int64_t)corner_idx[q][px] * p.cin + c, val);
#pragma unroll
              for (int v = 0; v < V; ++v) s[v] += wq * val[v];
            }
          }
        }
#pragma unroll
        for (int v = 0; v < V; ++v) samp[cv * V + v][px] = s[v];
      }
      // stage the weight chunk: a warp reads 8 consecutive input channels
      // of 4 output channels; entries outside an output channel's group
      // are never read
#pragma unroll
      for (int i = 0; i < kChunk * kOut / kThreads; ++i) {
        const int e = i * kThreads + tid;
        const int lane = e & 31, wv = e >> 5;
        const int cc = (wv & 3) * 8 + (lane & 7);
        const int col = (wv >> 2) * 4 + (lane >> 3);
        const int ci = c0 + cc, co = co0 + col;
        float wgt = 0.0f;
        if (ci < ci_hi && co < p.cout) {
          const int cil = ci - (co / p.og) * p.cg;
          if (cil >= 0 && cil < p.cg)
            wgt = Vec<T>::one(weight + ((int64_t)co * kTaps + tap) * p.cg + cil);
        }
        wsm[cc][col] = wgt;
      }
      __syncthreads();

      if (co_ok) {
        const int lo = max(c0, g_lo) - c0;
        const int hi = min(min(c0 + kChunk, ci_hi), g_hi) - c0;
#pragma unroll 4
        for (int cc = lo; cc < hi; ++cc) {
          const float4 a = *reinterpret_cast<const float4*>(&samp[cc][pq * 4]);
          const float4 b = *reinterpret_cast<const float4*>(&wsm[cc][cq * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
        }
      }
      __syncthreads();
    }
  }

  if (!co_ok) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pix = pix0 + pq * 4 + i;
    if (pix < npix)
      Vec<T>::store4(out + ((int64_t)img * npix + pix) * p.cout + my_co, acc[i]);
  }
}

}  // namespace

// x (n, h, w, cin), offsets (n, ho, wo, 18), weight (cout, 3, 3, cin/groups),
// out (n, ho, wo, cout), all contiguous, one dtype: 0 = float32,
// 1 = bfloat16. Needs cin/groups a multiple of the 16-byte vector
// (4 float32, 8 bfloat16) and cout/groups a multiple of 4.
// Returns cudaGetLastError() after the launch (0 on success); -1 on bad
// arguments.
extern "C" int htd_deform_conv_fwd(const void* x, const void* offsets, const void* weight,
                                   void* out, int n, int h, int w, int cin, int ho, int wo,
                                   int cout, int groups, int stride, int pad, int dil,
                                   int dtype, cudaStream_t stream) {
  DcnParams p;
  if (!fill_params(p, n, h, w, cin, ho, wo, cout, groups, stride, pad, dil, dtype)) return -1;
  const int vec = dtype == 0 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  if (p.cg % vec || p.og % 4) return -1;
  dim3 grid((ho * wo + kPix - 1) / kPix, (cout + kOut - 1) / kOut, n);
  if (dtype == 0) {
    deform_conv_fwd_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(offsets),
        static_cast<const float*>(weight), static_cast<float*>(out), p);
  } else {
    deform_conv_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(offsets),
        static_cast<const __nv_bfloat16*>(weight), static_cast<__nv_bfloat16*>(out), p);
  }
  return (int)cudaGetLastError();
}
