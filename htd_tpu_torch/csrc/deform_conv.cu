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
// Function (the JAX `_dcn_xla_impl(impl="gather")`):
//   y = (oy*stride - pad + ky*dil) + off_y;  x likewise with off_x
//   (one correctly rounded float32 add, so floor() agrees bit for bit)
//   inside = y > -1 && y < H && x > -1 && x < W
//   corners (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1) with weights
//   (1-ly)(1-lx), (1-ly)lx, ly(1-lx), ly*lx; a corner outside the map
//   weighs 0; out[o] = sum_k sum_c sample(k, c) * W[k][c - g*cg][o] over the
//   input channels c of o's weight group g.
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 9;
constexpr int kPix = 64;      // output pixels per block
constexpr int kOut = 64;      // output channels per block
constexpr int kChunk = 32;    // input channels per shared-memory chunk
constexpr int kThreads = 256; // 16 pixel quads x 16 channel quads
static_assert(kChunk == 32 && kOut % 4 == 0 && kChunk * kOut % kThreads == 0,
              "the weight staging maps 8 channels x 4 out channels onto a warp");

struct DcnParams {
  int h, w, cin, ho, wo, cout, cg, og, stride, pad, dil;
};

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[N]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ __forceinline__ static float one(const float* p) { return *p; }
  __device__ __forceinline__ static void store4(float* p, const float (&v)[4]) {
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
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static void store4(__nv_bfloat16* p, const float (&v)[4]) {
    uint2 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = x;
  }
};

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
      float w00 = 0.0f, w01 = 0.0f, w10 = 0.0f, w11 = 0.0f;
      int i00 = 0, i01 = 0, i10 = 0, i11 = 0;
      if (pix < npix) {
        const int oy = pix / p.wo, ox = pix - oy * p.wo;
        const float dy = Vec<T>::one(oimg + (int64_t)pix * (2 * kTaps) + 2 * tap);
        const float dx = Vec<T>::one(oimg + (int64_t)pix * (2 * kTaps) + 2 * tap + 1);
        const float ys = __fadd_rn((float)(oy * p.stride - p.pad + ky * p.dil), dy);
        const float xs = __fadd_rn((float)(ox * p.stride - p.pad + kx * p.dil), dx);
        if (ys > -1.0f && ys < (float)p.h && xs > -1.0f && xs < (float)p.w) {
          const float y0 = floorf(ys), x0 = floorf(xs);
          const float ly = __fsub_rn(ys, y0), lx = __fsub_rn(xs, x0);
          const float hy = __fsub_rn(1.0f, ly), hx = __fsub_rn(1.0f, lx);
          const int yi = (int)y0, xi = (int)x0;
          const bool y0_ok = yi >= 0, y1_ok = yi + 1 < p.h;
          const bool x0_ok = xi >= 0, x1_ok = xi + 1 < p.w;
          if (y0_ok && x0_ok) { w00 = __fmul_rn(hy, hx); i00 = yi * p.w + xi; }
          if (y0_ok && x1_ok) { w01 = __fmul_rn(hy, lx); i01 = yi * p.w + xi + 1; }
          if (y1_ok && x0_ok) { w10 = __fmul_rn(ly, hx); i10 = (yi + 1) * p.w + xi; }
          if (y1_ok && x1_ok) { w11 = __fmul_rn(ly, lx); i11 = (yi + 1) * p.w + xi + 1; }
        }
      }
      corner_idx[0][tid] = i00; corner_w[0][tid] = w00;
      corner_idx[1][tid] = i01; corner_w[1][tid] = w01;
      corner_idx[2][tid] = i10; corner_w[2][tid] = w10;
      corner_idx[3][tid] = i11; corner_w[3][tid] = w11;
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
  if (dtype != 0 && dtype != 1) return -1;
  if (n < 1 || h < 1 || w < 1 || ho < 1 || wo < 1 || groups < 1) return -1;
  if (cin % groups || cout % groups) return -1;
  const int vec = dtype == 0 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  DcnParams p;
  p.h = h; p.w = w; p.cin = cin; p.ho = ho; p.wo = wo; p.cout = cout;
  p.cg = cin / groups; p.og = cout / groups;
  p.stride = stride; p.pad = pad; p.dil = dil;
  if (p.cg % vec || p.og % 4 || n > 65535) return -1;
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
