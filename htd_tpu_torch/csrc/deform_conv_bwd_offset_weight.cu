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
//   the input channels c of o's weight group gi. With deform groups, a
//   group's d_off sums over its own channels, and each channel is sampled
//   at its group's offsets. In bfloat16 each sample is blended in float32
//   from its four corners in the plain order (`add_corner`, no FMAs) and
//   rounded once to bfloat16 before the product, as K3 rounds it, as the
//   plain version does and as the JAX gather vjp contracts `col` in x's
//   dtype; in float32 the sample is the float32 blend.
//   d_col is K5's float32 output: K6 reads it rather than forming
//   g . W_t^T a second time, which would double the launch's operations.
//   Layouts: x (N, H, W, Cin), offsets (N, Ho, Wo, dg * 18), g (N, Ho,
//   Wo, Cout), one dtype, float32 or bfloat16; d_col (N, Ho, Wo, 9, Cin)
//   float32; d_off (N, Ho, Wo, dg * 18) in the offsets' dtype, written;
//   d_w float32 in (Cout, 3, 3, Cin/groups) memory order (K3's weight
//   order), zeroed by the caller. Sums are float32.
//
// Bound on the H100: operations. d_w is 2 * Ho * Wo * 9 * Cin/groups * Cout
// per image, on the tensor cores in bfloat16; d_off is about 20 float32
// operations per (pixel, tap, channel), and its floor is reading K5's
// float32 d_col. One call launches two grids on the stream:
// - d_off: one warp per output pixel; for each tap every lane computes the
//   sample's corners, runs over its channels four at a time (x's corners
//   and d_col), and the warp sums its lanes with shuffles. Each value is
//   written once, no atomics.
// - d_w: a split-K product over pixels. CUDA blocks carry nothing from one
//   to the next, so the pixels are cut into ranges, and each block adds its
//   partial tile to d_w once with vector `atomicAdd`s: one partial per
//   range for each d_w element. Two paths, picked statically by dtype and
//   weight groups (each input takes exactly one):
//   - bfloat16 with one weight group (R-101-DCN / R-50-DCN training): per
//     tap, d_w_tap^T (Cout x Cin) = G^T . S_tap on the tensor cores, the
//     depth running over pixels. A block owns one tap, 64 input channels
//     and 256 output channels (128 when Cout is not a multiple of 256), so
//     that each sample is gathered Cout / 256 times; 8 warps of (BO / 4) x
//     32 contract mma.sync.m16n8k16 with float32 sums, both operands
//     through ldmatrix.trans from [pixel][channel] tiles. It walks its
//     pixel range 32 pixels (two k16 steps) at a time: while the warps
//     multiply chunk k, each thread has issued the four 16-byte corner
//     loads of its (pixel, 8 channels) sample of chunk k + 1, and the g
//     tiles (pixels x outputs, rows of g's NHWC memory) of chunks k + 1 and
//     k + 2 are in flight by cp.async in a ring of three; after the products
//     the thread blends its sample, rounds it to bfloat16 (`pack_bf16x8`) and
//     stores it into the other of two sample tiles. The epilogue adds
//     (output, 2 channels) pairs with float2 atomics. `dw_split_tc` picks
//     the ranges from the SM count and the kernel's occupancy so that the
//     last wave of blocks is nearly full. The product pipeline bounds it:
//     with every sample outside the image (no corner loads) it takes
//     nearly as long. Two blocks per SM (128 registers a thread): one block
//     with the registers the 256-output tile would take ran slower, as did
//     128-output tiles for every Cout and a two-deep g ring.
//   - float32, or grouped weights (X-101-64x4d-DCN): CUDA cores. A block
//     takes one tap, 64 input channels and 64 output channels of one
//     range, samples 32 pixels at a time into shared memory (16-byte
//     corner loads; float32 with fused multiply-adds, bfloat16 blended as
//     above and rounded), stages g beside them, accumulates a 4-channel
//     x 4-output tile per thread in registers and adds it with float4
//     atomics; `dw_split` picks about 4 blocks per SM. With weight groups a
//     block's input channels are the union of its output channels' groups,
//     and a thread whose channels and outputs lie in different groups idles.

#include "deform_geom.cuh"
#include "tensor_core.cuh"

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
    const float* dc = d_col + (q * kTaps + tap) * p.cin;
    // each deform group's offsets get the sum over its own channels
    for (int dgi = 0; dgi < p.dg; ++dgi) {
      const float2 d = tap_offset(offsets, q, dgi, tap, p);
      const Corners c = sample_corners(oy, ox, ky, kx, d.x, d.y, p);
      float acc_y = 0.0f, acc_x = 0.0f;
      for (int ch = dgi * p.cdg + lane * 4; ch < (dgi + 1) * p.cdg; ch += 128) {
        const float4 d4 = *reinterpret_cast<const float4*>(dc + ch);
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
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
          acc_y += dv[j] * sy[j];
          acc_x += dv[j] * sx[j];
        }
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        acc_y += __shfl_xor_sync(0xffffffffu, acc_y, s);
        acc_x += __shfl_xor_sync(0xffffffffu, acc_x, s);
      }
      if (lane == 0) {
        T* o = d_off + q * (2 * kTaps * p.dg) + (dgi * kTaps + tap) * 2;
        o[0] = Vec<T>::from(acc_y);
        o[1] = Vec<T>::from(acc_x);
      }
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
  // per deform group slot (the block's channels span at most two: Cin/dg
  // is a multiple of kC), corner pixel rows of x (image included), weights
  __shared__ int corner_row[2][4][kPx];
  __shared__ float corner_w[2][4][kPx];

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
  const int dg0 = c0 / p.cdg, slots = (c_end - 1) / p.cdg - dg0 + 1;
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
    if (tid < kPx * slots) {
      const int slot = tid / kPx, px = tid - slot * kPx;
      const int64_t q = q0 + px;
      Corners c = no_corners();
      int row0 = 0;
      if (q < q_end) {
        const int img = (int)(q / npix), pix = (int)(q - (int64_t)img * npix);
        const int oy = pix / p.wo, ox = pix - oy * p.wo;
        const float2 d = tap_offset(offsets, q, dg0 + slot, tap, p);
        c = sample_corners(oy, ox, ky, kx, d.x, d.y, p);
        row0 = img * p.h * p.w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        corner_row[slot][k][px] = row0 + c.idx[k];
        corner_w[slot][k][px] = c.w[k];
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
        const int slot = ch / p.cdg - dg0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float wk = corner_w[slot][k][px];
          if (wk != 0.0f) {
            float val[V];
            Vec<T>::load(x + (int64_t)corner_row[slot][k][px] * p.cin + ch, val);
            // float32 keeps the fused multiply-adds (and so the results) of
            // this path's first version; bfloat16 adds the corners as the
            // plain version does and rounds the sample once, as K3 does
            if (sizeof(T) == sizeof(float)) {
#pragma unroll
              for (int v = 0; v < V; ++v) s[v] += wk * val[v];
            } else {
              add_corner(s, wk, val);
            }
          }
        }
      }
#pragma unroll
      for (int v = 0; v < V; v += 4)
        *reinterpret_cast<float4*>(&samp[px][cv * V + v]) = make_float4(
            Vec<T>::round(s[v]), Vec<T>::round(s[v + 1]), Vec<T>::round(s[v + 2]),
            Vec<T>::round(s[v + 3]));
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

// ---- the tensor-core d_w path: bfloat16, one weight group ----

constexpr int kTcC = 64;           // input channels per block (the product's N)
constexpr int kTcPx = 32;          // pixels per chunk (two k16 steps of the depth)
constexpr int kTcThreads = 256;    // 8 warps: 4 over the outputs x 2 over the channels
constexpr int kTcSRow = kTcC + 8;  // padded sample row, bf16 elements (144 bytes)
static_assert(kTcPx * kTcC / 8 == kTcThreads, "one 8-channel sample per thread and chunk");
static_assert(kTcPx == kPx, "both paths cut the pixels into ranges of whole chunks");

constexpr int kTcGStages = 3;     // g tiles in flight: chunk k's, k+1's, k+2's

// A block of BO output channels (128 or 256): warp tiles of BO / 4 outputs
// (BO / 64 m16 tiles) x 32 channels (4 n8 tiles). Dynamic shared memory: a
// ring of kTcGStages g tiles, then two sample tiles.
template <int BO>
struct DwTile {
  static constexpr int kGRow = BO + 8;                          // padded g row, bf16
  static constexpr int kGLoads = kTcPx * BO / 8 / kTcThreads;   // 16-byte g copies per thread
  static constexpr int kMi = BO / 64;
  static constexpr size_t kSmem =
      ((size_t)kTcGStages * kTcPx * kGRow + (size_t)2 * kTcPx * kTcSRow) * sizeof(__nv_bfloat16);
  static_assert(kGLoads >= 1 && kTcPx * BO / 8 % kTcThreads == 0, "g tile / thread mapping");
};

template <int BO>
__global__ void __launch_bounds__(kTcThreads, 2)
deform_conv_bwd_weight_tc_kernel(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ offsets,
                                 const __nv_bfloat16* __restrict__ g, float* __restrict__ d_w,
                                 const DcnParams p, const int px_per_split) {
  using Tile = DwTile<BO>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto Gs = reinterpret_cast<__nv_bfloat16(*)[kTcPx][Tile::kGRow]>(smem);   // [pixel][output]
  auto Ss = reinterpret_cast<__nv_bfloat16(*)[kTcPx][kTcSRow]>(             // [pixel][channel]
      smem + (size_t)kTcGStages * kTcPx * Tile::kGRow * sizeof(__nv_bfloat16));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int o0 = blockIdx.x * BO;
  const int tap = blockIdx.y % kTaps;
  const int c0 = (blockIdx.y / kTaps) * kTcC;
  const int ky = tap / 3, kx = tap - ky * 3;
  const int dgi = c0 / p.cdg;   // the block's channels lie in one deform group
  const int npix = p.ho * p.wo;
  const int64_t total = (int64_t)p.n * npix;
  const int64_t q_begin = (int64_t)blockIdx.z * px_per_split;
  const int64_t q_end = q_begin + px_per_split < total ? q_begin + px_per_split : total;
  const int chunks = (int)((q_end - q_begin + kTcPx - 1) / kTcPx);

  // this thread's sample of each chunk: pixel tid / 8, channels c0 + (tid % 8) * 8..
  const int s_px = tid >> 3, s_c8 = (tid & 7) * 8;
  uint4 raw[4];
  float wq[4];
  auto gather = [&](int kt) {
    const int64_t q = q_begin + (int64_t)kt * kTcPx + s_px;
    Corners c = no_corners();
    int row0 = 0;
    if (q < q_end) {
      const int img = (int)(q / npix), pix = (int)(q - (int64_t)img * npix);
      const int oy = pix / p.wo, ox = pix - oy * p.wo;
      const float2 d = tap_offset(offsets, q, dgi, tap, p);
      c = sample_corners(oy, ox, ky, kx, d.x, d.y, p);
      row0 = img * p.h * p.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wq[k] = c.w[k];
      raw[k] = wq[k] != 0.0f
          ? *reinterpret_cast<const uint4*>(x + (int64_t)(row0 + c.idx[k]) * p.cin + c0 + s_c8)
          : make_uint4(0, 0, 0, 0);
    }
  };
  // the sample blended in the plain order and rounded once to bfloat16
  auto store_s = [&](int buf) {
    float s[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) s[v] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float val[8];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[k]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        val[2 * i] = f.x;
        val[2 * i + 1] = f.y;
      }
      add_corner(s, wq[k], val);
    }
    *reinterpret_cast<uint4*>(&Ss[buf][s_px][s_c8]) = pack_bf16x8(s);
  };
  // g rows of chunk kt; rows past the range or outputs past Cout are zero-filled
  auto load_g = [&](int kt, int buf) {
    const int64_t q0 = q_begin + (int64_t)kt * kTcPx;
#pragma unroll
    for (int j = 0; j < Tile::kGLoads; ++j) {
      const int e = tid + j * kTcThreads;
      const int row = e / (BO / 8), o = o0 + (e % (BO / 8)) * 8;
      const bool ok = q0 + row < q_end && o < p.cout;
      cp_async16(&Gs[buf][row][o - o0], ok ? g + (q0 + row) * p.cout + o : g, ok);
    }
    cp_async_commit();
  };

  const int wm = (warp & 3) * (BO / 4), wn = (warp >> 2) * 32;
  float acc[Tile::kMi][4][4];
#pragma unroll
  for (int i = 0; i < Tile::kMi; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  // one cp.async group per chunk (empty past the last chunk), so that
  // waiting for all but the newest group waits for the next chunk's g only
  gather(0);
  load_g(0, 0);
  if (chunks > 1) load_g(1, 1); else cp_async_commit();
  store_s(0);
  cp_async_wait<1>();
  __syncthreads();

  for (int kt = 0; kt < chunks; ++kt) {
    const int buf = kt & 1, gbuf = kt % kTcGStages;
    const bool more = kt + 1 < chunks;
    if (more) gather(kt + 1);   // corner loads in flight during the products below
    // the ring slot of chunk kt - 1, which every warp finished before the
    // last barrier
    if (kt + 2 < chunks) load_g(kt + 2, (kt + 2) % kTcGStages); else cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < kTcPx; kk += 16) {
      // B = S [pixel][channel] (channel contiguous): matrix l / 8 covers
      // pixels kk + (l / 8 % 2) * 8.., channels + (l / 16) * 8..
      uint32_t b[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        ldmatrix_x4_trans(b[nb], &Ss[buf][kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                                    [wn + nb * 16 + (lane >> 4) * 8]);
      // A = G^T from G [pixel][output]: matrix l / 8 covers outputs
      // + (l / 8 % 2) * 8.., pixels kk + (l / 16) * 8..
#pragma unroll
      for (int i = 0; i < Tile::kMi; ++i) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, &Gs[gbuf][kk + (lane & 7) + (lane >> 4) * 8]
                                [wm + i * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16_16816(acc[i][j], a, b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
      }
    }
    if (more) store_s(buf ^ 1);
    cp_async_wait<1>();   // chunk kt + 1's g tile has landed
    __syncthreads();
  }

  // rows (outputs) wm + 16i + lane/4 (+8), columns (channels) wn + 8j + 2(lane%4) (+1)
#pragma unroll
  for (int i = 0; i < Tile::kMi; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = o0 + wm + i * 16 + (lane >> 2) + half * 8;
      if (o >= p.cout) continue;
      float* row = d_w + ((int64_t)o * kTaps + tap) * p.cin + c0 + wn + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        // float2 atomicAdd on global memory: sm_90, CUDA 12.1 and later
        atomicAdd(reinterpret_cast<float2*>(row + j * 8),
                  make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]));
    }
}

// K6's d_w split for one call: the pixels (over all images) each partial
// sums, a multiple of kPx; the number of partials; the d_w grid (x: output
// tiles, y: taps x input-channel tiles, z: partials). False when the shape
// does not fit the grid or the device cannot be read.
struct DwSplit {
  int px_per_split;
  int partials;
  dim3 grid;
};

bool sm_count(int& sms) {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess &&
         cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess;
}

// `splits` ranges of about equal length over `total` pixels, each a
// multiple of kPx (= kTcPx); fills px_per_split, partials and grid.z.
bool cut(int64_t total, int64_t splits, DwSplit& out) {
  const int64_t max_splits = (total + kPx - 1) / kPx;
  splits = splits < max_splits ? splits : max_splits;
  splits = splits > 1 ? splits : 1;
  const int64_t px = ((total + splits - 1) / splits + kPx - 1) / kPx * kPx;
  const int64_t partials = (total + px - 1) / px;
  out.px_per_split = (int)px;
  out.partials = (int)partials;
  out.grid.z = (unsigned)partials;
  return px < (1 << 30) && partials <= 65535;
}

// CUDA-core path: about 4 blocks per SM.
bool dw_split(const DcnParams& p, DwSplit& out) {
  const int64_t total = (int64_t)p.n * p.ho * p.wo;
  // the widest input-channel span of an output tile's groups
  int span = 0;
  for (int o0 = 0; o0 < p.cout; o0 += kO) {
    const int o_end = o0 + kO < p.cout ? o0 + kO : p.cout;
    const int s = ((o_end - 1) / p.og + 1 - o0 / p.og) * p.cg;
    span = s > span ? s : span;
  }
  int sms = 0;
  if (!sm_count(sms)) return false;
  const int64_t blocks = (int64_t)((p.cout + kO - 1) / kO) * kTaps * ((span + kC - 1) / kC);
  out.grid = dim3((p.cout + kO - 1) / kO, kTaps * ((span + kC - 1) / kC), 1);
  return cut(total, (4 * (int64_t)sms + blocks - 1) / blocks, out) && out.grid.y <= 65535;
}

// Tensor-core path: the output tile (256 where Cout is a multiple of it,
// else 128)
int dw_tile_tc(const DcnParams& p) { return p.cout % 256 == 0 ? 256 : 128; }

// Tensor-core path: with `slots` blocks resident on the card at once, the
// fewest ranges whose grid's last wave is at least 90% full (each added
// range adds a partial tile of atomics), else the fullest below 8 waves.
bool dw_split_tc(const DcnParams& p, DwSplit& out) {
  const int bo = dw_tile_tc(p);
  int sms = 0, per_sm = 0;
  // more than 48 KB of dynamic shared memory needs the kernel's opt-in
  if (!sm_count(sms) ||
      cudaFuncSetAttribute(deform_conv_bwd_weight_tc_kernel<256>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)DwTile<256>::kSmem) != cudaSuccess ||
      cudaFuncSetAttribute(deform_conv_bwd_weight_tc_kernel<128>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)DwTile<128>::kSmem) != cudaSuccess ||
      (bo == 256 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, deform_conv_bwd_weight_tc_kernel<256>, kTcThreads,
                       DwTile<256>::kSmem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, deform_conv_bwd_weight_tc_kernel<128>, kTcThreads,
                       DwTile<128>::kSmem)) != cudaSuccess || per_sm < 1)
    return false;
  const int64_t slots = (int64_t)sms * per_sm;
  const int64_t total = (int64_t)p.n * p.ho * p.wo;
  const int64_t tiles = (int64_t)((p.cout + bo - 1) / bo) * kTaps * (p.cin / kTcC);
  const int64_t max_splits = (total + kTcPx - 1) / kTcPx;
  int64_t best = 1;
  double best_fill = 0.0;
  for (int64_t s = 1; s <= max_splits && s * tiles <= 8 * slots; ++s) {
    const int64_t blocks = s * tiles;
    const double fill = (double)blocks / (double)(((blocks + slots - 1) / slots) * slots);
    if (fill > best_fill + 1e-9) {
      best = s;
      best_fill = fill;
    }
    if (fill >= 0.9) break;
  }
  out.grid = dim3((p.cout + bo - 1) / bo, kTaps * (p.cin / kTcC), 1);
  return cut(total, best, out) && out.grid.y <= 65535;
}

bool takes_tc(const DcnParams& p, int dtype) { return dtype == 1 && p.cg == p.cin; }

}  // namespace

// x (n, h, w, cin), offsets (n, ho, wo, deform_groups * 18), g (n, ho,
// wo, cout), all contiguous, one dtype: 0 = float32, 1 = bfloat16; d_col
// (n, ho, wo, 9, cin) float32 from K5. d_off (n, ho, wo, deform_groups *
// 18) in that dtype, written; d_w (cout, 3, 3, cin/groups) float32, zeroed
// by the caller, K6 adds into it. Needs cin/groups and cout/groups
// multiples of the 16-byte vector (4 float32, 8 bfloat16) and, with more
// than one deform group, cin/deform_groups a multiple of 64. bfloat16 with
// groups == 1 takes the tensor-core d_w (needs cin a multiple of 64),
// everything else the CUDA-core d_w. Returns cudaGetLastError() after the
// two launches (0 on success); -1 on bad arguments.
extern "C" int htd_deform_conv_bwd_offset_weight(const void* x, const void* offsets,
                                                 const void* g, const float* d_col,
                                                 void* d_off, float* d_w, int n, int h, int w,
                                                 int cin, int ho, int wo, int cout, int groups,
                                                 int deform_groups, int stride, int pad, int dil,
                                                 int dtype, cudaStream_t stream) {
  DcnParams p;
  DwSplit split;
  if (!fill_params(p, n, h, w, cin, ho, wo, cout, groups, deform_groups, stride, pad, dil,
                   dtype))
    return -1;
  const int vec = dtype == 0 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  if (p.cg % vec || p.og % vec || (p.dg > 1 && p.cdg % kC)) return -1;
  const bool tc = takes_tc(p, dtype);
  if (tc ? (cin % kTcC || !dw_split_tc(p, split)) : !dw_split(p, split)) return -1;
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
                        *op = static_cast<const __nv_bfloat16*>(offsets),
                        *gp = static_cast<const __nv_bfloat16*>(g);
    deform_conv_bwd_offset_kernel<__nv_bfloat16><<<grid_off, kThreads, 0, stream>>>(
        xp, op, d_col, static_cast<__nv_bfloat16*>(d_off), p);
    if (!tc)
      deform_conv_bwd_weight_kernel<__nv_bfloat16><<<split.grid, kThreads, 0, stream>>>(
          xp, op, gp, d_w, p, split.px_per_split);
    else if (dw_tile_tc(p) == 256)
      deform_conv_bwd_weight_tc_kernel<256><<<split.grid, kTcThreads, DwTile<256>::kSmem,
                                              stream>>>(xp, op, gp, d_w, p, split.px_per_split);
    else
      deform_conv_bwd_weight_tc_kernel<128><<<split.grid, kTcThreads, DwTile<128>::kSmem,
                                              stream>>>(xp, op, gp, d_w, p, split.px_per_split);
  }
  return (int)cudaGetLastError();
}

// The number of d_w partials (pixel ranges) a K6 call of this shape and
// dtype (0 = float32, 1 = bfloat16) adds on the current device; -1 when K6
// does not take the shape.
extern "C" int htd_deform_conv_bwd_dw_partials(int n, int ho, int wo, int cin, int cout,
                                               int groups, int dtype) {
  DcnParams p;
  DwSplit split;
  if (!fill_params(p, n, 1, 1, cin, ho, wo, cout, groups, 1, 1, 1, 1, dtype)) return -1;
  const bool ok = takes_tc(p, dtype) ? cin % kTcC == 0 && dw_split_tc(p, split)
                                     : dw_split(p, split);
  return ok ? split.partials : -1;
}
