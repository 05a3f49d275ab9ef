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
//   output channels o of c's weight group gi, float32 sums of the operands'
//   products (g and W are both in x's dtype, as the JAX package casts
//   them);
//   d_x[n, corner, c] += w_corner(n, p, k) * d_col[n, p, k, c] for the four
//   corners of each sample (deform_geom.cuh: the geometry K3 samples with),
//   at the offsets of c's deform group.
//   Layouts: g (N, Ho, Wo, Cout), offsets (N, Ho, Wo, dg * 18), weight in
//   (Cout, 3, 3, Cin/groups) memory order (K3's), float32 or bfloat16 of
//   one dtype; d_x (N, H, W, Cin) float32, zeroed by the caller;
//   d_col (N, Ho, Wo, 9, Cin) float32.
//
// Bound on the H100: operations for d_col (2 * Ho * Wo * 9 * Cin/groups *
// Cout per image, 1152-4608 multiply-adds per d_col element in
// R-101-DCN), and the bytes of d_col written in float32 for K6, which in
// R-101-DCN outweigh the d_col product at the bf16 tensor-core rate, and
// the float4 atomics of the corner scatter. Both paths store each finished
// d_col tile (K6 reads it rather than forming the product again) and add
// it to each sample's four corners with 16-byte float4 `atomicAdd` (sm_90):
// four neighbouring channels of one pixel per atomic. Corners of zero
// weight add nothing. The atomics sum in an order that changes from run to
// run; the result agrees with the plain version to float32 rounding. Two
// paths, picked statically by dtype and weight groups:
//
// - bfloat16 with one weight group (R-101-DCN training): per tap, d_col =
//   g . W_tap on the tensor cores. A block owns 64 pixels x 64 input
//   channels of one image (one deform group: Cin / dg is a multiple of
//   64), so that each of R-101-DCN's stages launches at least 2 x 132
//   blocks at batch 2 (layer 4: 33 x 8). It runs over (tap, 64-channel
//   chunk of Cout): the g tile (pixels x Cout chunk, row-major in g's NHWC
//   memory) and the W_tap tile (Cout chunk x channels, rows of the
//   weight's memory) arrive by cp.async in a ring of three padded shared
//   tile pairs, two chunks ahead; four warps (32 x 32 each) contract them with mma.sync.m16n8k16,
//   A through ldmatrix and B through ldmatrix.trans, float32 sums. After a
//   tap's last chunk the block stages its float32 d_col tile in shared
//   memory and writes it out and scatters it with float4 atomics, reading
//   the tap's corners from a table written once per block.
// - float32, or grouped weights (X-101-64x4d-DCN): CUDA cores, the
//   transpose of K3's. One block per 64 output pixels x 64 input channels;
//   per tap, 64 threads write the corner table; per chunk of 32 output
//   channels the block stages g and W_t in float32, and each thread
//   accumulates a 4-pixel x 4-channel d_col tile in registers, running
//   only over its own weight group's output channels.

#include "deform_geom.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kPix = 64;      // output pixels per block
constexpr int kCin = 64;      // input channels per block (within one deform group)
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
  const int dgi = c0 / p.cdg;
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
  float* dximg = d_x + (int64_t)img * p.h * p.w * p.cin;

  for (int tap = 0; tap < kTaps; ++tap) {
    const int ky = tap / 3, kx = tap - ky * 3;
    if (tid < kPix) {
      const int pix = pix0 + tid;
      Corners c = no_corners();
      if (pix < npix) {
        const int oy = pix / p.wo, ox = pix - oy * p.wo;
        const float2 d = tap_offset(offsets, (int64_t)img * npix + pix, dgi, tap, p);
        c = sample_corners(oy, ox, ky, kx, d.x, d.y, p);
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

// ---- the tensor-core path: bfloat16, one weight group ----

constexpr int kTcM = 64;          // output pixels per block
constexpr int kTcN = 64;          // input channels per block (d_col columns)
constexpr int kTcK = 64;          // output channels per K chunk
constexpr int kTcThreads = 128;   // 4 warps: 2 (pixels) x 2 (channels), 32 x 32 each
constexpr int kTcRow = 64 + 8;    // padded shared row, bf16 elements (144 bytes)
constexpr int kTcStage = kTcN + 4;  // padded float32 staging row
static_assert(kTcM * kTcK / 8 % kTcThreads == 0 && kTcM * kTcN / 4 % kTcThreads == 0,
              "tile / thread mapping");

constexpr int kTcStages = 3;      // (A, B) tile pairs in flight: chunk k's, k+1's, k+2's

// Dynamic shared memory of one block: a ring of kTcStages g (A) and W_tap
// (B) tiles, the float32 d_col staging tile, and the corner indices and
// weights of the 9 taps for the block's pixels.
constexpr size_t kTcSmem = (size_t)kTcStages * (kTcM + kTcK) * kTcRow * sizeof(__nv_bfloat16) +
                           (size_t)kTcM * kTcStage * sizeof(float) +
                           (size_t)kTaps * 4 * kTcM * (sizeof(int) + sizeof(float));

__global__ void __launch_bounds__(kTcThreads)
deform_conv_bwd_input_tc_kernel(const __nv_bfloat16* __restrict__ g,
                                const __nv_bfloat16* __restrict__ offsets,
                                const __nv_bfloat16* __restrict__ weight,
                                float* __restrict__ d_x, float* __restrict__ d_col,
                                const DcnParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto As = reinterpret_cast<__nv_bfloat16(*)[kTcM][kTcRow]>(smem);        // [pixel][o]
  auto Bs = reinterpret_cast<__nv_bfloat16(*)[kTcK][kTcRow]>(             // [o][channel]
      smem + kTcStages * kTcM * kTcRow * sizeof(__nv_bfloat16));
  auto stage = reinterpret_cast<float(*)[kTcStage]>(
      smem + kTcStages * (kTcM + kTcK) * kTcRow * sizeof(__nv_bfloat16));
  int* cidx = reinterpret_cast<int*>(&stage[kTcM][0]);
  float* cw = reinterpret_cast<float*>(cidx + kTaps * 4 * kTcM);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int img = blockIdx.z;
  const int npix = p.ho * p.wo;
  const int pix0 = blockIdx.x * kTcM;
  const int c0 = blockIdx.y * kTcN;
  const int dgi = c0 / p.cdg;
  const int chunks = (p.cout + kTcK - 1) / kTcK;  // K chunks per tap
  const int kt_total = kTaps * chunks;
  const __nv_bfloat16* gimg = g + (int64_t)img * npix * p.cout;
  float* dximg = d_x + (int64_t)img * p.h * p.w * p.cin;

  // corner tables: entry tap * 4 + corner, per pixel
  for (int e = tid; e < kTaps * kTcM; e += kTcThreads) {
    const int px = e % kTcM, tap = e / kTcM;
    const int pix = pix0 + px;
    Corners c = no_corners();
    if (pix < npix) {
      const int oy = pix / p.wo, ox = pix - oy * p.wo;
      const int ky = tap / 3, kx = tap - ky * 3;
      const float2 d = tap_offset(offsets, (int64_t)img * npix + pix, dgi, tap, p);
      c = sample_corners(oy, ox, ky, kx, d.x, d.y, p);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cidx[(tap * 4 + q) * kTcM + px] = c.idx[q];
      cw[(tap * 4 + q) * kTcM + px] = c.w[q];
    }
  }

  // chunk kt: tap kt / chunks, output channels o0 = (kt % chunks) * kTcK..;
  // rows past the image's pixels or Cout are zero-filled
  auto load = [&](int kt, int buf) {
    const int tap = kt / chunks, o0 = (kt - tap * chunks) * kTcK;
#pragma unroll
    for (int j = 0; j < kTcM * kTcK / 8 / kTcThreads; ++j) {
      const int e = tid + j * kTcThreads;
      const int row = e >> 3, c16 = e & 7;
      const int pix = pix0 + row, o = o0 + c16 * 8;
      const bool ok = pix < npix && o < p.cout;
      cp_async16(&As[buf][row][c16 * 8], ok ? gimg + (int64_t)pix * p.cout + o : g, ok);
    }
#pragma unroll
    for (int j = 0; j < kTcK * kTcN / 8 / kTcThreads; ++j) {
      const int e = tid + j * kTcThreads;
      const int row = e >> 3, c16 = e & 7;
      const int o = o0 + row;
      const bool ok = o < p.cout;
      cp_async16(&Bs[buf][row][c16 * 8],
                 ok ? weight + ((int64_t)o * kTaps + tap) * p.cin + c0 + c16 * 8 : weight, ok);
    }
    cp_async_commit();
  };

  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  // one cp.async group per chunk (empty past the last chunk), so that
  // waiting for all but the newest group waits for the current chunk only
  load(0, 0);
  if (kt_total > 1) load(1, 1); else cp_async_commit();
  for (int kt = 0; kt < kt_total; ++kt) {
    const int buf = kt % kTcStages;
    cp_async_wait<1>();   // chunk kt's tiles have landed
    // after this barrier every warp is done with iteration kt - 1, whose
    // ring slot chunk kt + 2 now takes, and with its staging-tile reads
    __syncthreads();
    if (kt + 2 < kt_total) load(kt + 2, (kt + 2) % kTcStages); else cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 16) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], &As[buf][wm + i * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
      // B is [o][channel] (channel contiguous): matrix l / 8 covers o rows
      // kk + (l / 8 % 2) * 8.., channels + (l / 16) * 8..
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        ldmatrix_x4_trans(b[nb], &Bs[buf][kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                                    [wn + nb * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16_16816(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }

    const int tap = kt / chunks;
    if (kt - tap * chunks != chunks - 1) continue;
    // the tap's d_col tile is complete: stage it, write it, scatter it
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm + i * 16 + (lane >> 2) + half * 8;
          const int c = wn + j * 8 + (lane & 3) * 2;
          *reinterpret_cast<float2*>(&stage[r][c]) =
              make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
          acc[i][j][half * 2] = acc[i][j][half * 2 + 1] = 0.0f;
        }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTcM * kTcN / 4 / kTcThreads; ++j) {
      const int e = tid + j * kTcThreads;
      const int px = e >> 4, c4 = (e & 15) * 4;
      const int pix = pix0 + px;
      if (pix >= npix) continue;
      const float4 v = *reinterpret_cast<const float4*>(&stage[px][c4]);
      *reinterpret_cast<float4*>(d_col + (((int64_t)img * npix + pix) * kTaps + tap) * p.cin
                                 + c0 + c4) = v;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float wq = cw[(tap * 4 + q) * kTcM + px];
        if (wq == 0.0f) continue;
        atomicAdd(reinterpret_cast<float4*>(dximg + (int64_t)cidx[(tap * 4 + q) * kTcM + px]
                                                * p.cin + c0 + c4),
                  make_float4(__fmul_rn(wq, v.x), __fmul_rn(wq, v.y), __fmul_rn(wq, v.z),
                              __fmul_rn(wq, v.w)));
      }
    }
    // the staging tile is rewritten only after the next iteration's barrier
  }
}

}  // namespace

// g (n, ho, wo, cout), offsets (n, ho, wo, deform_groups * 18), weight
// (cout, 3, 3, cin/groups), all contiguous, one dtype: 0 = float32,
// 1 = bfloat16. d_x (n, h, w, cin) float32, zeroed by the caller, K5 adds
// into it; d_col (n, ho, wo, 9, cin) float32, written. bfloat16 with
// groups == 1 takes the tensor-core path (needs cout a multiple of 8),
// everything else the CUDA-core path (needs cin/groups a multiple of 4 and
// cout/groups a multiple of the 16-byte vector, 4 float32 or 8 bfloat16).
// Both need cin/deform_groups a multiple of 64 (a block's 64 input
// channels lie in one deform group), or one deform group and cin a
// multiple of 4 (CUDA cores) or 64 (tensor cores).
// Returns cudaGetLastError() after the launch (0 on success); -1 on bad
// arguments.
extern "C" int htd_deform_conv_bwd_input(const void* g, const void* offsets, const void* weight,
                                         float* d_x, float* d_col, int n, int h, int w,
                                         int cin, int ho, int wo, int cout, int groups,
                                         int deform_groups, int stride, int pad, int dil,
                                         int dtype, cudaStream_t stream) {
  DcnParams p;
  if (!fill_params(p, n, h, w, cin, ho, wo, cout, groups, deform_groups, stride, pad, dil,
                   dtype))
    return -1;
  if (p.dg > 1 && p.cdg % kCin) return -1;
  if (dtype == 1 && groups == 1) {
    if (cin % kTcN || cout % 8) return -1;
    if (cudaFuncSetAttribute(deform_conv_bwd_input_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem)
        != cudaSuccess)
      return (int)cudaGetLastError();
    dim3 grid((ho * wo + kTcM - 1) / kTcM, cin / kTcN, n);
    deform_conv_bwd_input_tc_kernel<<<grid, kTcThreads, kTcSmem, stream>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(offsets),
        static_cast<const __nv_bfloat16*>(weight), d_x, d_col, p);
    return (int)cudaGetLastError();
  }
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
