// K6: the offset and weight gradients of K3 (deformable conv backward,
// d_offsets and d_weight).
//
// Replaces the TPU kernel `dcn_dow_pallas` (htd_tpu/ops/dcn_pallas.py:478,
// reached through `_dcn_dow_pallas` from the custom VJP of
// `htd_tpu/ops/dcn.py::deform_conv2d`) and, for the stride-2 convs that the
// TPU kernel does not take, `jax.vjp` of the gather form. The TPU kernel
// recomputed each stripe's samples and their coordinate derivatives inside
// a floor-displacement window, reduced d_offsets in its body and carried
// d_weight from one grid step to the next in its output block; samples
// outside the window went to a capped exact correction. K6 has no window
// and no cap: exact for every offset, at stride 1 and 2.
//
// Function (`_bilinear_gather_grad` and the vjp of the gather form):
//   d_off[n, p, k, y] = sum_c d_col[n, p, k, c] * sum_corners dwy * x[corner, c]
//   d_off[n, p, k, x] likewise with dwx (deform_geom.cuh: unit slope inside
//   a floor cell, out-of-map corners 0);
//   d_w[o][k][c - gi*cg] = sum_{n, p} sample(n, p, k, c) * g[n, p, o] over
//   the input channels c of o's weight group gi.
//   d_col is K5's float32 output: K6 reads it rather than forming
//   g . W_t^T a second time, which would double the launch's operations.
//   Layouts: x (N, H, W, Cin), offsets (N, Ho, Wo, 18), g (N, Ho, Wo,
//   Cout), one dtype, float32 or bfloat16; d_col (N, Ho, Wo, 9, Cin)
//   float32; d_off (N, Ho, Wo, 18) in the offsets' dtype, written;
//   d_w float32 in (Cout, 3, 3, Cin/groups) memory order (K3's weight
//   order), zeroed by the caller. Sums are float32.
//
// Bound on the H100: operations. d_w is 2 * Ho * Wo * 9 * Cin/groups * Cout
// per image; d_off is about 20 float32 operations per (pixel, tap,
// channel). One call launches two grids on the stream:
// - d_off: one warp per output pixel; for each tap every lane computes the
//   sample's corners, runs over its channels four at a time (x's corners
//   and d_col), and the warp sums its lanes with shuffles. Each value is
//   written once, no atomics.
// - d_w: a split-K product over pixels. CUDA blocks carry nothing from one
//   to the next, so the pixels are cut into ranges; a block takes one tap,
//   64 input channels and 64 output channels of one range, samples 32
//   pixels at a time into shared memory (16-byte corner loads), stages g
//   beside them, accumulates a 4-channel x 4-output tile per thread in
//   registers, and adds its partial tile to d_w with float4 `atomicAdd`:
//   one partial per range for each d_w element. `dw_split` picks the
//   ranges from the card's SM count so that the grid fills it. With weight groups a
//   block's input channels are the union of its output channels' groups,
//   and a thread whose channels and outputs lie in different groups idles.
// Tensor cores (the d_w product), TMA and pipelining are later work.

#include "deform_geom.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPx = 32;     // pixels per d_w sub-tile (the product's depth step)
constexpr int kC = 64;      // input channels per d_w block
constexpr int kO = 64;      // output channels per d_w block

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_conv_bwd_offset_kernel(const T* __restrict__ x, const T* __restrict__ offsets,
                              const float* __restrict__ d_col, T* __restrict__ d_off,
                              const DcnParams p) {
  const int lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int npix = p.ho * p.wo;
  if (q >= (int64_t)p.n * npix) return;
  const int img = (int)(q / npix), pix = (int)(q - (int64_t)img * npix);
  const int oy = pix / p.wo, ox = pix - oy * p.wo;
  const T* ximg = x + (int64_t)img * p.h * p.w * p.cin;
  for (int tap = 0; tap < kTaps; ++tap) {
    const int ky = tap / 3, kx = tap - ky * 3;
    const float dy = Vec<T>::one(offsets + q * (2 * kTaps) + 2 * tap);
    const float dx = Vec<T>::one(offsets + q * (2 * kTaps) + 2 * tap + 1);
    const Corners c = sample_corners(oy, ox, ky, kx, dy, dx, p);
    const float* dc = d_col + (q * kTaps + tap) * p.cin;
    float acc_y = 0.0f, acc_x = 0.0f;
    for (int ch = lane * 4; ch < p.cin; ch += 128) {
      const float4 d4 = *reinterpret_cast<const float4*>(dc + ch);
      const float d[4] = {d4.x, d4.y, d4.z, d4.w};
      float sy[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c.dwy[k] == 0.0f && c.dwx[k] == 0.0f) continue;
        float v[4];
        Vec<T>::load4(ximg + (int64_t)c.idx[k] * p.cin + ch, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sy[j] += c.dwy[k] * v[j];
          sx[j] += c.dwx[k] * v[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc_y += d[j] * sy[j];
        acc_x += d[j] * sx[j];
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      acc_y += __shfl_xor_sync(0xffffffffu, acc_y, s);
      acc_x += __shfl_xor_sync(0xffffffffu, acc_x, s);
    }
    if (lane == 0) {
      d_off[q * (2 * kTaps) + 2 * tap] = Vec<T>::from(acc_y);
      d_off[q * (2 * kTaps) + 2 * tap + 1] = Vec<T>::from(acc_x);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_conv_bwd_weight_kernel(const T* __restrict__ x, const T* __restrict__ offsets,
                              const T* __restrict__ g, float* __restrict__ d_w,
                              const DcnParams p, const int px_per_split) {
  constexpr int V = Vec<T>::N;
  __shared__ __align__(16) float samp[kPx][kC + 4];   // [pixel][input channel]
  __shared__ __align__(16) float gsm[kPx][kO + 4];    // [pixel][output channel]
  __shared__ int corner_row[4][kPx];                  // pixel row of x, image included
  __shared__ float corner_w[4][kPx];

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * kO;
  const int o_end = min(o0 + kO, p.cout);
  const int tap = blockIdx.y % kTaps;
  const int ky = tap / 3, kx = tap - ky * 3;
  // input channels of the groups this block's output channels belong to
  const int ci_lo = (o0 / p.og) * p.cg;
  const int ci_hi = ((o_end - 1) / p.og + 1) * p.cg;
  const int c0 = ci_lo + (blockIdx.y / kTaps) * kC;
  if (c0 >= ci_hi) return;
  const int c_end = min(c0 + kC, ci_hi);
  const int npix = p.ho * p.wo;
  const int64_t total = (int64_t)p.n * npix;
  const int64_t q_begin = (int64_t)blockIdx.z * px_per_split;
  const int64_t q_end = q_begin + px_per_split < total ? q_begin + px_per_split : total;

  // this thread's tile: input channels cq*4.., output channels oq*4..
  const int cq = tid >> 4, oq = tid & 15;
  const int my_c = c0 + cq * 4, my_o = o0 + oq * 4;
  const bool mine = my_c < c_end && my_o < o_end && my_c / p.cg == my_o / p.og;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  for (int64_t q0 = q_begin; q0 < q_end; q0 += kPx) {
    if (tid < kPx) {
      const int64_t q = q0 + tid;
      Corners c = no_corners();
      int row0 = 0;
      if (q < q_end) {
        const int img = (int)(q / npix), pix = (int)(q - (int64_t)img * npix);
        const int oy = pix / p.wo, ox = pix - oy * p.wo;
        const float dy = Vec<T>::one(offsets + q * (2 * kTaps) + 2 * tap);
        const float dx = Vec<T>::one(offsets + q * (2 * kTaps) + 2 * tap + 1);
        c = sample_corners(oy, ox, ky, kx, dy, dx, p);
        row0 = img * p.h * p.w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        corner_row[k][tid] = row0 + c.idx[k];
        corner_w[k][tid] = c.w[k];
      }
    }
    __syncthreads();
    // sample the sub-tile and stage g: item = (channel vector fastest, pixel)
    for (int item = tid; item < kPx * (kC / V); item += kThreads) {
      const int cv = item % (kC / V), px = item / (kC / V);
      const int ch = c0 + cv * V;
      float s[V];
#pragma unroll
      for (int v = 0; v < V; ++v) s[v] = 0.0f;
      if (ch < c_end) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float wk = corner_w[k][px];
          if (wk != 0.0f) {
            float val[V];
            Vec<T>::load(x + (int64_t)corner_row[k][px] * p.cin + ch, val);
#pragma unroll
            for (int v = 0; v < V; ++v) s[v] += wk * val[v];
          }
        }
      }
#pragma unroll
      for (int v = 0; v < V; v += 4)
        *reinterpret_cast<float4*>(&samp[px][cv * V + v]) = make_float4(s[v], s[v + 1],
                                                                        s[v + 2], s[v + 3]);
    }
    for (int item = tid; item < kPx * (kO / V); item += kThreads) {
      const int ov = item % (kO / V), px = item / (kO / V);
      const int o = o0 + ov * V;
      float val[V];
#pragma unroll
      for (int v = 0; v < V; ++v) val[v] = 0.0f;
      if (o < o_end && q0 + px < q_end) Vec<T>::load(g + (q0 + px) * p.cout + o, val);
#pragma unroll
      for (int v = 0; v < V; v += 4)
        *reinterpret_cast<float4*>(&gsm[px][ov * V + v]) = make_float4(val[v], val[v + 1],
                                                                       val[v + 2], val[v + 3]);
    }
    __syncthreads();
    if (mine) {
#pragma unroll 4
      for (int px = 0; px < kPx; ++px) {
        const float4 a = *reinterpret_cast<const float4*>(&samp[px][cq * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&gsm[px][oq * 4]);
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

  if (!mine) return;
  const int cl = my_c - (my_o / p.og) * p.cg;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // float4 atomicAdd on global memory: sm_90, CUDA 12.1 and later
    atomicAdd(reinterpret_cast<float4*>(d_w + ((int64_t)(my_o + j) * kTaps + tap) * p.cg + cl),
              make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]));
  }
}

// K6's d_w split for one call: the pixels (over all images) each partial
// sums, a multiple of kPx chosen so that about 4 blocks per SM run on the
// current device; the number of partials; the d_w grid (x: output tiles,
// y: taps x input-channel tiles, z: partials). False when the shape does
// not fit the grid or the device cannot be read.
struct DwSplit {
  int px_per_split;
  int partials;
  dim3 grid;
};

bool dw_split(const DcnParams& p, DwSplit& out) {
  const int64_t total = (int64_t)p.n * p.ho * p.wo;
  // the widest input-channel span of an output tile's groups
  int span = 0;
  for (int o0 = 0; o0 < p.cout; o0 += kO) {
    const int o_end = o0 + kO < p.cout ? o0 + kO : p.cout;
    const int s = ((o_end - 1) / p.og + 1 - o0 / p.og) * p.cg;
    span = s > span ? s : span;
  }
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return false;
  const int64_t blocks = (int64_t)((p.cout + kO - 1) / kO) * kTaps * ((span + kC - 1) / kC);
  int64_t splits = (4 * (int64_t)sms + blocks - 1) / blocks;
  const int64_t max_splits = (total + kPx - 1) / kPx;
  splits = splits < max_splits ? splits : max_splits;
  splits = splits > 1 ? splits : 1;
  const int64_t px = ((total + splits - 1) / splits + kPx - 1) / kPx * kPx;
  const int64_t partials = (total + px - 1) / px;
  out.grid = dim3((p.cout + kO - 1) / kO, kTaps * ((span + kC - 1) / kC), (unsigned)partials);
  out.px_per_split = (int)px;
  out.partials = (int)partials;
  return px < (1 << 30) && out.grid.y <= 65535 && partials <= 65535;
}

}  // namespace

// x (n, h, w, cin), offsets (n, ho, wo, 18), g (n, ho, wo, cout), all
// contiguous, one dtype: 0 = float32, 1 = bfloat16; d_col (n, ho, wo, 9,
// cin) float32 from K5. d_off (n, ho, wo, 18) in that dtype, written; d_w
// (cout, 3, 3, cin/groups) float32, zeroed by the caller, K6 adds into it.
// Needs cin/groups and cout/groups multiples of the 16-byte vector (4
// float32, 8 bfloat16). Returns cudaGetLastError() after the two launches
// (0 on success); -1 on bad arguments.
extern "C" int htd_deform_conv_bwd_offset_weight(const void* x, const void* offsets,
                                                 const void* g, const float* d_col,
                                                 void* d_off, float* d_w, int n, int h, int w,
                                                 int cin, int ho, int wo, int cout, int groups,
                                                 int stride, int pad, int dil, int dtype,
                                                 cudaStream_t stream) {
  DcnParams p;
  DwSplit split;
  if (!fill_params(p, n, h, w, cin, ho, wo, cout, groups, stride, pad, dil, dtype)) return -1;
  const int vec = dtype == 0 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  if (p.cg % vec || p.og % vec || !dw_split(p, split)) return -1;
  const int64_t total = (int64_t)n * ho * wo;
  const dim3 grid_off((unsigned)((total + kWarps - 1) / kWarps));
  if (dtype == 0) {
    const float *xp = static_cast<const float*>(x), *op = static_cast<const float*>(offsets);
    deform_conv_bwd_offset_kernel<float><<<grid_off, kThreads, 0, stream>>>(
        xp, op, d_col, static_cast<float*>(d_off), p);
    deform_conv_bwd_weight_kernel<float><<<split.grid, kThreads, 0, stream>>>(
        xp, op, static_cast<const float*>(g), d_w, p, split.px_per_split);
  } else {
    const __nv_bfloat16 *xp = static_cast<const __nv_bfloat16*>(x),
                        *op = static_cast<const __nv_bfloat16*>(offsets);
    deform_conv_bwd_offset_kernel<__nv_bfloat16><<<grid_off, kThreads, 0, stream>>>(
        xp, op, d_col, static_cast<__nv_bfloat16*>(d_off), p);
    deform_conv_bwd_weight_kernel<__nv_bfloat16><<<split.grid, kThreads, 0, stream>>>(
        xp, op, static_cast<const __nv_bfloat16*>(g), d_w, p, split.px_per_split);
  }
  return (int)cudaGetLastError();
}

// The number of d_w partials (pixel ranges) a K6 call of this shape adds
// on the current device; -1 when K6 does not take the shape.
extern "C" int htd_deform_conv_bwd_dw_partials(int n, int ho, int wo, int cin, int cout,
                                               int groups) {
  DcnParams p;
  DwSplit split;
  if (!fill_params(p, n, 1, 1, cin, ho, wo, cout, groups, 1, 1, 1, 0) ||
      !dw_split(p, split))
    return -1;
  return split.partials;
}
