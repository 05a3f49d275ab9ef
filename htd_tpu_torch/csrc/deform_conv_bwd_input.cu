// K5: the input gradient of K3 (deformable conv backward, d_x), and the
// column gradient d_col that K6 reads.
//
// Replaces the TPU kernel `dcn_dx_pallas` (htd_tpu/ops/dcn_pallas.py:313,
// reached through `_dcn_dx_pallas` from the custom VJP of
// `htd_tpu/ops/dcn.py::deform_conv2d`) and, for the stride-2 convs that the
// TPU kernel does not take, the XLA corner-folded scatter `_dcn_dx_folded`
// (htd_tpu/ops/dcn.py:324). The TPU kernel formed d_col = g . W_t^T per tap
// in its body and added it back through a select-MAC over statically
// shifted views inside a floor-displacement window; the samples outside
// the window went to a capped exact correction, and those beyond the cap
// lost their gradient. K5 has no window and no cap: it adds every sample's
// share to its four bilinear corners with atomics, so it is exact for
// every offset, at stride 1 and 2.
//
// Function (the JAX `_dcn_dx_folded`, the vjp of the gather form in x):
//   d_col[n, p, k, c] = sum_o g[n, p, o] * W[o][k][c - gi*cg] over the
//   output channels o of c's weight group gi;
//   d_x[n, corner, c] += w_corner(n, p, k) * d_col[n, p, k, c] for the four
//   corners of each sample (deform_geom.cuh: the geometry K3 samples with).
//   Layouts: g (N, Ho, Wo, Cout), offsets (N, Ho, Wo, 18), weight in
//   (Cout, 3, 3, Cin/groups) memory order (K3's), float32 or bfloat16 of
//   one dtype; d_x (N, H, W, Cin) float32, zeroed by the caller;
//   d_col (N, Ho, Wo, 9, Cin) float32. Sums are float32.
//
// Bound on the H100: operations for d_col (2 * Ho * Wo * 9 * Cin/groups *
// Cout per image, 1152-4608 multiply-adds per d_col element in
// R-101-DCN), and the bytes of d_col written in float32 for K6, which in
// R-101-DCN outweigh the d_col product at the bf16 tensor-core rate.
// Design (CUDA cores, right first, the transpose of K3): one block per tile
// of 64 output pixels x 64 input channels of one image. For each tap, 64
// threads compute the tile's corners and weights into shared memory; per
// chunk of 32 output channels the block stages g (64 pixels) and W_t (64
// channels) in float32, and each thread accumulates a 4-pixel x 4-channel
// d_col tile in registers, running only over its own weight group's output
// channels. The finished tile is stored to d_col (K6 reads it rather than
// forming the product again) and added to each sample's four corners with
// 16-byte float4 `atomicAdd` (sm_90): four neighbouring channels of one
// pixel per atomic, so a warp's atomics cover 256 contiguous bytes of two
// pixels. Corners of zero weight add nothing. The atomics sum in an order
// that changes from run to run; the result agrees with the plain version to
// float32 rounding. Tensor cores, TMA and fewer atomics are later work.

#include "deform_geom.cuh"

namespace {

constexpr int kPix = 64;      // output pixels per block
constexpr int kCin = 64;      // input channels per block
constexpr int kChunk = 32;    // output channels per shared-memory chunk
constexpr int kThreads = 256; // 16 pixel quads x 16 channel quads
static_assert(kChunk * kCin % kThreads == 0, "the weight staging covers the chunk evenly");

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_conv_bwd_input_kernel(const T* __restrict__ g, const T* __restrict__ offsets,
                             const T* __restrict__ weight, float* __restrict__ d_x,
                             float* __restrict__ d_col, const DcnParams p) {
  constexpr int V = Vec<T>::N;
  __shared__ __align__(16) float gsm[kChunk][kPix];      // [out channel][pixel]
  __shared__ __align__(16) float wsm[kChunk][kCin + 4];  // [out channel][channel]
  __shared__ int corner_idx[4][kPix];
  __shared__ float corner_w[4][kPix];

  const int tid = threadIdx.x;
  const int img = blockIdx.z;
  const int npix = p.ho * p.wo;
  const int pix0 = blockIdx.x * kPix;
  const int c0 = blockIdx.y * kCin;
  const int c_end = min(c0 + kCin, p.cin);
  // output channels of the groups this block's input channels belong to
  const int o_lo = (c0 / p.cg) * p.og;
  const int o_hi = ((c_end - 1) / p.cg + 1) * p.og;

  // this thread's d_col tile: pixels pq*4.., channels cq*4..
  const int pq = tid >> 4, cq = tid & 15;
  const int my_c = c0 + cq * 4;
  const bool c_ok = my_c < c_end;
  const int my_g = c_ok ? my_c / p.cg : 0;
  const int g_lo = my_g * p.og, g_hi = g_lo + p.og;

  const T* gimg = g + (int64_t)img * npix * p.cout;
  const T* oimg = offsets + (int64_t)img * npix * (2 * kTaps);
  float* dximg = d_x + (int64_t)img * p.h * p.w * p.cin;

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

    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

    for (int oc = o_lo; oc < o_hi; oc += kChunk) {
      // stage g: item = (pixel fastest, out-channel vector)
      for (int item = tid; item < kPix * (kChunk / V); item += kThreads) {
        const int px = item % kPix, ov = item / kPix;
        const int o = oc + ov * V;
        float val[V];
#pragma unroll
        for (int v = 0; v < V; ++v) val[v] = 0.0f;
        if (o < o_hi && pix0 + px < npix)
          Vec<T>::load(gimg + (int64_t)(pix0 + px) * p.cout + o, val);
#pragma unroll
        for (int v = 0; v < V; ++v) gsm[ov * V + v][px] = val[v];
      }
      // stage W_t: consecutive threads read consecutive input channels of
      // one output channel; entries outside the output channel's group are 0
#pragma unroll
      for (int i = 0; i < kChunk * kCin / kThreads; ++i) {
        const int e = i * kThreads + tid;
        const int cc = e % kCin, oo = e / kCin;
        const int c = c0 + cc, o = oc + oo;
        float wgt = 0.0f;
        if (c < c_end && o < o_hi) {
          const int cil = c - (o / p.og) * p.cg;
          if (cil >= 0 && cil < p.cg)
            wgt = Vec<T>::one(weight + ((int64_t)o * kTaps + tap) * p.cg + cil);
        }
        wsm[oo][cc] = wgt;
      }
      __syncthreads();

      if (c_ok) {
        const int lo = max(oc, g_lo) - oc;
        const int hi = min(min(oc + kChunk, o_hi), g_hi) - oc;
#pragma unroll 4
        for (int oo = lo; oo < hi; ++oo) {
          const float4 a = *reinterpret_cast<const float4*>(&gsm[oo][pq * 4]);
          const float4 b = *reinterpret_cast<const float4*>(&wsm[oo][cq * 4]);
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

    if (c_ok) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int px = pq * 4 + i;
        const int pix = pix0 + px;
        if (pix >= npix) continue;
        *reinterpret_cast<float4*>(d_col + (((int64_t)img * npix + pix) * kTaps + tap) * p.cin
                                   + my_c) = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                                         acc[i][3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float wq = corner_w[q][px];
          if (wq == 0.0f) continue;
          // float4 atomicAdd on global memory: sm_90, CUDA 12.1 and later
          atomicAdd(reinterpret_cast<float4*>(dximg + (int64_t)corner_idx[q][px] * p.cin + my_c),
                    make_float4(__fmul_rn(wq, acc[i][0]), __fmul_rn(wq, acc[i][1]),
                                __fmul_rn(wq, acc[i][2]), __fmul_rn(wq, acc[i][3])));
        }
      }
    }
    // the next tap rewrites the corner tables
    __syncthreads();
  }
}

}  // namespace

// g (n, ho, wo, cout), offsets (n, ho, wo, 18), weight (cout, 3, 3,
// cin/groups), all contiguous, one dtype: 0 = float32, 1 = bfloat16.
// d_x (n, h, w, cin) float32, zeroed by the caller, K5 adds into it;
// d_col (n, ho, wo, 9, cin) float32, written. Needs cin/groups a multiple
// of 4 and cout/groups a multiple of the 16-byte vector (4 float32,
// 8 bfloat16). Returns cudaGetLastError() after the launch (0 on success);
// -1 on bad arguments.
extern "C" int htd_deform_conv_bwd_input(const void* g, const void* offsets, const void* weight,
                                         float* d_x, float* d_col, int n, int h, int w,
                                         int cin, int ho, int wo, int cout, int groups,
                                         int stride, int pad, int dil, int dtype,
                                         cudaStream_t stream) {
  DcnParams p;
  if (!fill_params(p, n, h, w, cin, ho, wo, cout, groups, stride, pad, dil, dtype)) return -1;
  const int vec = dtype == 0 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  if (p.cg % 4 || p.og % vec) return -1;
  dim3 grid((ho * wo + kPix - 1) / kPix, (cin + kCin - 1) / kCin, n);
  if (dtype == 0) {
    deform_conv_bwd_input_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(g), static_cast<const float*>(offsets),
        static_cast<const float*>(weight), d_x, d_col, p);
  } else {
    deform_conv_bwd_input_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(offsets),
        static_cast<const __nv_bfloat16*>(weight), d_x, d_col, p);
  }
  return (int)cudaGetLastError();
}
