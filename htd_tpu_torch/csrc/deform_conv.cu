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
//   the corner bounds alike), blended in float32 and rounded once to x's
//   dtype (the TPU kernel's `samp` in the stripe's dtype); out[o] =
//   sum_k sum_c sample(k, c) * W[k][c - g*cg][o] over the input channels c
//   of o's weight group g, float32 sums. Channel c is sampled at the
//   offsets of deform group c / (Cin / dg).
//   Layouts: x (N, H, W, Cin), offsets (N, Ho, Wo, dg * 18)
//   [group][tap][(y, x)], weight in (Cout, 3, 3, Cin/groups) memory order
//   (the channels_last memory of the mmcv (Cout, Cin/groups, 3, 3)
//   parameter, so the kernel reads the module's weight as it is), out
//   (N, Ho, Wo, Cout). float32 or bfloat16 in and out.
//
// Bound on the H100: operations. Each output element takes 9 * Cin/groups
// multiply-adds; for R-101-DCN's 3x3 convs that is 1152-4608 per element
// against about 3 bytes moved, far above the card's ratio of operations to
// bytes. The sampled (Ho, Wo, 9, Cin) tensor never reaches device memory,
// which is what the TPU kernel fused too. Three paths, picked statically by
// dtype and weight groups, each input taking exactly one:
//
//   bfloat16, groups == 1                               -> tensor cores
//   bfloat16, groups > 1, Cin/groups == Cout/groups in
//     {8, 16, 32}, Cin/deform_groups a multiple of 64,
//     an image's H * W * Cin * 2 bytes below 2^31            -> grouped tensor cores
//   float32; any other grouped bfloat16 shape            -> CUDA cores
//
// - bfloat16 with one weight group (R-101-DCN, inference and training):
//   an implicit GEMM on the tensor cores, M = output pixels, N = Cout,
//   K = 9 * Cin in tap-major order, which is the order of the weight's
//   (Cout, 3, 3, Cin) memory. A block owns 32 pixels x 128 output
//   channels of one image (8 warps) where that still gives every SM two
//   blocks, else 32 x 64 (4 warps), so that each of R-101-DCN's three
//   stages launches at least 2 x 132 blocks at 800x1344 (layer 4's 25x42
//   map: 33 x 8 at batch 1); each output tile repeats the sampling of its
//   pixels, so the wider tile halves that traffic. It
//   first writes the corner table of every (tap, deform group) into shared
//   memory; then, per K chunk of 64 channels, the threads blend the four
//   corners of the tile's (pixel, 8-channel) items in float32 from 16-byte
//   loads, round each sample once to bf16 and store it into the padded A
//   tile (144-byte rows: ldmatrix reads eight rows without bank
//   conflicts), while the weight chunk arrives by cp.async in the B tile;
//   the warps (16 pixels x 32 channels each) contract the tiles with
//   mma.sync.m16n8k16 (bf16 operands, float32 sums) through ldmatrix. A
//   and B are double-buffered: the corner loads of chunk k+1 are in flight
//   while chunk k runs on the tensor cores, one barrier per chunk (a third
//   B tile in flight ran slower on the H100: its shared memory costs a
//   resident block per SM). The weight tiles, re-read from L2 by every
//   pixel tile, and this pipeline bound the path, not the sampling: with
//   every sample outside the image it takes nearly as long. wgmma, TMA
//   multicast of the weight tiles and a deeper pipeline are later work.
// - bfloat16 with grouped weights of 8, 16 or 32 channels, input channels
//   per group equal to output channels (X-101-64x4d-DCN's layer2-4):
//   the grouped tensor-core path. Each sample feeds only its own group's
//   outputs, so K is short (9 x 8-32) and the sampling, not the products,
//   bounds the path; and a block's whole weight slab fits on chip, which
//   R-101's dense weight does not. A block owns 64 output pixels (a 4 x
//   16 tile of the map) and 64 channels (whole groups: its input slab is
//   its output slab). It first copies the slab's weights (64 x 9 x cg,
//   9-36 KB) into shared memory by cp.async and writes the corner table
//   of all 9 taps for its pixels, then passes one barrier; after that its
//   8 warps (16 pixels x 32 channels each) run independently. Each thread
//   blends, per tap, 8 consecutive channels of two pixels (rows g and g +
//   8 of mma's A fragment) from 16-byte corner loads, in float32 in
//   add_corner's order from the first product, rounds each sample once to
//   bf16 (the plain version's sample, a zero's sign aside) and keeps it in
//   registers as its own A fragment: the K slots of mma.m16n8k16 are
//   permuted so that a thread's slots are its 8 channels (two K steps a
//   tap), which needs no shared A tile, no ldmatrix and no barrier. Its B
//   fragment is the matching 16 bytes of the weight slab, zero where the
//   output channel's group is another (block-diagonal: for 8 or 16
//   channels a group 3/4 or 1/2 of the products are zeros, which the
//   tensor cores absorb). bf16 products, float32 sums, one rounding of
//   the output. On the H100 (X-101's 30 convs at 800x1600) it takes
//   1.7 ms an image against 0.236 ms of bytes; the tap loop's instruction
//   throughput bounds it (about 250 instructions a thread a tap, mostly
//   the float32 blend and the bf16 unpacking: with every sample outside the
//   image it takes 3/4 of the time), then each block's weight copy and
//   corner table.
// - float32, or grouped bfloat16 weights outside that rule: CUDA cores,
//   exact float32 products. One block per 64 output
//   pixels x 64 output channels; per (tap, deform group) 64 threads write
//   the corner table, then per chunk of 32 input channels the block
//   samples the tile into shared memory and stages the weight beside it,
//   and each thread accumulates a 4-pixel x 4-channel tile in registers.
//   With weight groups a block's input channels are the union of its
//   output channels' groups, and each thread runs over its own group only.

#include "deform_geom.cuh"
#include "tensor_core.cuh"

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
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  for (int tap = 0; tap < kTaps; ++tap) {
    const int ky = tap / 3, kx = tap - ky * 3;
    // the deform groups that the block's input channels span, each with its
    // own corner table
    for (int dgi = ci_lo / p.cdg; dgi * p.cdg < ci_hi; ++dgi) {
      const int d_lo = max(ci_lo, dgi * p.cdg), d_hi = min(ci_hi, (dgi + 1) * p.cdg);
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
      __syncthreads();

      for (int c0 = d_lo; c0 < d_hi; c0 += kChunk) {
        // sample the chunk: item = (pixel fastest, channel vector)
        for (int item = tid; item < kPix * (kChunk / V); item += kThreads) {
          const int px = item % kPix, cv = item / kPix;
          const int c = c0 + cv * V;
          float s[V];
#pragma unroll
          for (int v = 0; v < V; ++v) s[v] = 0.0f;
          if (c < d_hi) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float wq = corner_w[q][px];
              if (wq != 0.0f) {
                float val[V];
                Vec<T>::load(ximg + (int64_t)corner_idx[q][px] * p.cin + c, val);
                // float32 keeps the fused multiply-adds (and so the results)
                // of this path's first version; bfloat16 adds the corners as
                // the plain version does, so that each sample rounds to the
                // same bfloat16 value
                if (sizeof(T) == sizeof(float)) {
#pragma unroll
                  for (int v = 0; v < V; ++v) s[v] += wq * val[v];
                } else {
                  add_corner(s, wq, val);
                }
              }
            }
          }
#pragma unroll
          for (int v = 0; v < V; ++v) samp[cv * V + v][px] = Vec<T>::round(s[v]);
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
          if (ci < d_hi && co < p.cout) {
            const int cil = ci - (co / p.og) * p.cg;
            if (cil >= 0 && cil < p.cg)
              wgt = Vec<T>::one(weight + ((int64_t)co * kTaps + tap) * p.cg + cil);
          }
          wsm[cc][col] = wgt;
        }
        __syncthreads();

        if (co_ok) {
          const int lo = max(c0, g_lo) - c0;
          const int hi = min(min(c0 + kChunk, d_hi), g_hi) - c0;
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
  }

  if (!co_ok) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pix = pix0 + pq * 4 + i;
    if (pix < npix)
      Vec<T>::store4(out + ((int64_t)img * npix + pix) * p.cout + my_co, acc[i]);
  }
}

// ---- the tensor-core path: bfloat16, one weight group ----

constexpr int kTcM = 32;          // output pixels per block
constexpr int kTcK = 64;          // input channels per K chunk (within one tap)
constexpr int kTcRow = kTcK + 8;  // padded shared row, bf16 elements (144 bytes)

// A block of BN output channels (64 or 128) has BN / 16 warps: 2 over the
// 32 pixels x BN / 32 over the channels, 16 x 32 each.
template <int BN>
struct TcTile {
  static constexpr int kThreads = BN * 2;
  static constexpr int kItems = kTcM * kTcK / 8 / kThreads;  // 8-channel samples per thread
  static constexpr int kBLoads = BN * kTcK / 8 / kThreads;   // 16-byte weight copies per thread
  static_assert(kItems >= 1 && kTcM * kTcK / 8 % kThreads == 0 && kBLoads >= 1,
                "tile / thread mapping");
};

// Dynamic shared memory of one block: A and B double-buffered, then the
// corner indices and weights of every (tap, deform group) for the block's
// pixels.
inline size_t tc_smem_bytes(int bn, int dg) {
  return (size_t)2 * (kTcM + bn) * kTcRow * sizeof(__nv_bfloat16) +
         (size_t)kTaps * dg * 4 * kTcM * (sizeof(int) + sizeof(float));
}

template <int BN>
__global__ void __launch_bounds__(TcTile<BN>::kThreads)
deform_conv_fwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ offsets,
                          const __nv_bfloat16* __restrict__ weight,
                          __nv_bfloat16* __restrict__ out, const DcnParams p) {
  constexpr int kThreads = TcTile<BN>::kThreads, kItems = TcTile<BN>::kItems;
  extern __shared__ __align__(16) unsigned char smem[];
  auto As = reinterpret_cast<__nv_bfloat16(*)[kTcM][kTcRow]>(smem);
  auto Bs = reinterpret_cast<__nv_bfloat16(*)[BN][kTcRow]>(
      smem + 2 * kTcM * kTcRow * sizeof(__nv_bfloat16));
  int* cidx = reinterpret_cast<int*>(smem + 2 * (kTcM + BN) * kTcRow * sizeof(__nv_bfloat16));
  float* cw = reinterpret_cast<float*>(cidx + kTaps * p.dg * 4 * kTcM);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int img = blockIdx.z;
  const int npix = p.ho * p.wo;
  const int pix0 = blockIdx.x * kTcM;
  const int co0 = blockIdx.y * BN;
  const int chunks = p.cin / kTcK;            // K chunks per tap
  const int kt_total = kTaps * chunks;
  const int64_t krow = (int64_t)kTaps * p.cin;  // weight row length (Cout-major)
  const __nv_bfloat16* ximg = x + (int64_t)img * p.h * p.w * p.cin;

  // corner tables: entry (tap * dg + group) * 4 + corner, per pixel
  for (int e = tid; e < kTaps * p.dg * kTcM; e += kThreads) {
    const int px = e % kTcM, td = e / kTcM;
    const int tap = td / p.dg, g = td - tap * p.dg;
    const int pix = pix0 + px;
    Corners c = no_corners();
    if (pix < npix) {
      const int oy = pix / p.wo, ox = pix - oy * p.wo;
      const int ky = tap / 3, kx = tap - ky * 3;
      const float2 d = tap_offset(offsets, (int64_t)img * npix + pix, g, tap, p);
      c = sample_corners(oy, ox, ky, kx, d.x, d.y, p);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cidx[(td * 4 + q) * kTcM + px] = c.idx[q];
      cw[(td * 4 + q) * kTcM + px] = c.w[q];
    }
  }
  __syncthreads();

  // chunk kt: tap kt / chunks, channels c0 = (kt % chunks) * kTcK.. of one
  // deform group (Cin / dg is a multiple of kTcK)
  uint4 raw[kItems][4];
  float wq[kItems][4];
  auto gather = [&](int kt) {
    const int tap = kt / chunks, c0 = (kt - tap * chunks) * kTcK;
    const int td = tap * p.dg + c0 / p.cdg;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = tid + i * kThreads;
      const int px = item >> 3, c = c0 + (item & 7) * 8;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wq[i][q] = cw[(td * 4 + q) * kTcM + px];
        raw[i][q] = wq[i][q] != 0.0f
            ? *reinterpret_cast<const uint4*>(ximg + (int64_t)cidx[(td * 4 + q) * kTcM + px]
                                                   * p.cin + c)
            : make_uint4(0, 0, 0, 0);
      }
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = tid + i * kThreads;
      float s[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) s[v] = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float val[8];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[i][q]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(h[k]);
          val[2 * k] = f.x;
          val[2 * k + 1] = f.y;
        }
        add_corner(s, wq[i][q], val);
      }
      *reinterpret_cast<uint4*>(&As[buf][item >> 3][(item & 7) * 8]) = pack_bf16x8(s);
    }
  };
  auto load_b = [&](int kt, int buf) {
    const int tap = kt / chunks, c0 = (kt - tap * chunks) * kTcK;
    const int64_t k0 = (int64_t)tap * p.cin + c0;
#pragma unroll
    for (int j = 0; j < TcTile<BN>::kBLoads; ++j) {
      const int e = tid + j * kThreads;
      const int row = e >> 3, c16 = e & 7;
      const int co = co0 + row;
      const bool ok = co < p.cout;
      cp_async16(&Bs[buf][row][c16 * 8], ok ? weight + co * krow + k0 + c16 * 8 : weight, ok);
    }
    cp_async_commit();
  };

  const int wm = (warp & 1) * 16, wn = (warp >> 1) * 32;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;

  gather(0);
  load_b(0, 0);
  store_a(0);
  cp_async_wait<0>();
  __syncthreads();

  for (int kt = 0; kt < kt_total; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < kt_total;
    if (more) {
      gather(kt + 1);       // corner loads in flight during the products below
      load_b(kt + 1, buf ^ 1);
    }
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 16) {
      uint32_t a[4], b[2][4];
      ldmatrix_x4(a, &As[buf][wm + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        ldmatrix_x4(b[nb], &Bs[buf][wn + nb * 16 + (lane & 7) + ((lane >> 4) << 3)]
                              [kk + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16_16816(acc[j], a, b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }
    if (more) store_a(buf ^ 1);
    cp_async_wait<0>();
    __syncthreads();
  }

  // rows wm + lane/4 (+8), channels wn + 8j + 2(lane%4) (+1)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + wn + j * 8 + (lane & 3) * 2;
    if (co >= p.cout) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pix = pix0 + wm + (lane >> 2) + half * 8;
      if (pix < npix)
        *reinterpret_cast<__nv_bfloat162*>(out + ((int64_t)img * npix + pix) * p.cout + co) =
            __floats2bfloat162_rn(acc[j][half * 2], acc[j][half * 2 + 1]);
    }
  }
}

template <int BN>
int launch_tc(const void* x, const void* offsets, const void* weight, void* out,
              const DcnParams& p, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(BN, p.dg);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(deform_conv_fwd_tc_kernel<BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess)
    return (int)cudaGetLastError();
  dim3 grid((p.ho * p.wo + kTcM - 1) / kTcM, (p.cout + BN - 1) / BN, p.n);
  deform_conv_fwd_tc_kernel<BN><<<grid, TcTile<BN>::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(offsets),
      static_cast<const __nv_bfloat16*>(weight), static_cast<__nv_bfloat16*>(out), p);
  return (int)cudaGetLastError();
}

// ---- the grouped tensor-core path: bfloat16, 8, 16 or 32 channels a group ----

constexpr int kGtThreads = 256;  // 8 warps: 4 over the pixels x 2 over the channels
constexpr int kGtSlab = 64;      // channels per block, input and output alike
constexpr int kGtTileW = 16;     // the block's pixels: a kGtTileH x kGtTileW tile of the map
constexpr int kGtTileH = 4;
constexpr int kGtPix = kGtTileH * kGtTileW;
static_assert(kGtPix == 64 && kGtSlab == 64, "4 x 2 warps of 16 pixels x 32 channels");

// Dynamic shared memory of one block: the weight slab, then the corner
// byte offsets and weights of every (tap, pixel).
inline size_t gt_smem_bytes(int cg) {
  return (size_t)kGtSlab * kTaps * cg * sizeof(__nv_bfloat16) +
         (size_t)kTaps * kGtPix * (sizeof(int4) + sizeof(float4));
}

// Eight bfloat16 values to float32, exactly (a bfloat16 is the high half of
// its float32).
__device__ __forceinline__ void unpack_bf16x8(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <int CG>
__global__ void __launch_bounds__(kGtThreads, 2)
deform_conv_fwd_grouped_tc_kernel(const __nv_bfloat16* __restrict__ x,
                                  const __nv_bfloat16* __restrict__ offsets,
                                  const __nv_bfloat16* __restrict__ weight,
                                  __nv_bfloat16* __restrict__ out, const DcnParams p) {
  static_assert(CG == 8 || CG == 16 || CG == 32, "a warp's 32 channels are whole groups");
  extern __shared__ __align__(16) unsigned char smem[];
  // [out channel][tap][input channel of its group], as the weight lies in memory
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  // [tap][pixel]: each corner's byte offset in the image (0 where the
  // corner does not count) and its weight
  int4* coff = reinterpret_cast<int4*>(smem + kGtSlab * kTaps * CG * sizeof(__nv_bfloat16));
  float4* cw = reinterpret_cast<float4*>(coff + kTaps * kGtPix);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int img = blockIdx.z;
  const int npix = p.ho * p.wo;
  const int tiles_x = (p.wo + kGtTileW - 1) / kGtTileW;
  const int oy0 = blockIdx.x / tiles_x * kGtTileH;
  const int ox0 = (blockIdx.x % tiles_x) * kGtTileW;
  const int c0 = blockIdx.y * kGtSlab;  // the block's first channel, in and out

  // the slab's weights, one contiguous run, in flight while the tables are written
  const __nv_bfloat16* wsrc = weight + (int64_t)c0 * kTaps * CG;
  for (int e = tid; e < kGtSlab * kTaps * CG / 8; e += kGtThreads)
    cp_async16(ws + e * 8, wsrc + e * 8, true);
  cp_async_commit();
  for (int e = tid; e < kTaps * kGtPix; e += kGtThreads) {
    const int px = e % kGtPix, tap = e / kGtPix;
    const int oy = oy0 + px / kGtTileW, ox = ox0 + px % kGtTileW;
    Corners c = no_corners();
    if (oy < p.ho && ox < p.wo) {
      const float2 d = tap_offset(offsets, (int64_t)img * npix + oy * p.wo + ox, c0 / p.cdg,
                                  tap, p);
      c = sample_corners(oy, ox, tap / 3, tap % 3, d.x, d.y, p);
    }
    const int row = p.cin * (int)sizeof(__nv_bfloat16);
    coff[e] = make_int4(c.idx[0] * row, c.idx[1] * row, c.idx[2] * row, c.idx[3] * row);
    cw[e] = make_float4(c.w[0], c.w[1], c.w[2], c.w[3]);
  }
  cp_async_wait<0>();
  __syncthreads();

  // thread (g, t) of its warp: pixels wm + g and wm + g + 8, input
  // channels wn + 8t .. wn + 8t + 7 of the slab, which lie in one group;
  // output channels wn + 8j + g (j = 0..3), whose weights at those inputs
  // are live only where the group is the same
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;
  const char* xc = reinterpret_cast<const char*>(x + (int64_t)img * p.h * p.w * p.cin + c0 +
                                                 wn + 8 * t);
  const __nv_bfloat16* wrow[4];
  bool live[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = wn + 8 * j + g;
    live[j] = CG == 32 || o / CG == (wn + 8 * t) / CG;
    wrow[j] = ws + o * kTaps * CG + (wn + 8 * t) % CG;
  }

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;

#pragma unroll 1
  for (int tap = 0; tap < kTaps; ++tap) {
    uint4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = live[j] ? *reinterpret_cast<const uint4*>(wrow[j] + tap * CG)
                     : make_uint4(0, 0, 0, 0);
    // A: K slots (2t, 2t + 1 | 2t + 8, 2t + 9) of step s are channels
    // 8t + 4s + (0, 1 | 2, 3); a[s][r] / a[s][2 + r] hold pixel r's pairs.
    // Every corner is loaded (a dead one at offset 0 with weight 0)
    uint32_t a[2][4];
    uint4 raw[2][4];
    float wq[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int px = tap * kGtPix + wm + g + 8 * r;
      const int4 o = coff[px];
      const float4 w = cw[px];
      wq[r][0] = w.x; wq[r][1] = w.y; wq[r][2] = w.z; wq[r][3] = w.w;
      raw[r][0] = __ldg(reinterpret_cast<const uint4*>(xc + o.x));
      raw[r][1] = __ldg(reinterpret_cast<const uint4*>(xc + o.y));
      raw[r][2] = __ldg(reinterpret_cast<const uint4*>(xc + o.z));
      raw[r][3] = __ldg(reinterpret_cast<const uint4*>(xc + o.w));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // add_corner's order from the first product (0 + p is p, a zero's
      // sign aside)
      float s[8], val[8];
      unpack_bf16x8(raw[r][0], val);
#pragma unroll
      for (int v = 0; v < 8; ++v) s[v] = __fmul_rn(wq[r][0], val[v]);
#pragma unroll
      for (int q = 1; q < 4; ++q) {
        unpack_bf16x8(raw[r][q], val);
        add_corner(s, wq[r][q], val);
      }
      const uint4 packed = pack_bf16x8(s);
      a[0][r] = packed.x;
      a[0][2 + r] = packed.y;
      a[1][r] = packed.z;
      a[1][2 + r] = packed.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mma_bf16_16816(acc[j], a[0], b[j].x, b[j].y);
      mma_bf16_16816(acc[j], a[1], b[j].z, b[j].w);
    }
  }

  // rows g (+8): pixels; columns 2t, 2t + 1 of each n-tile: channels
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int px = wm + g + 8 * r;
    const int oy = oy0 + px / kGtTileW, ox = ox0 + px % kGtTileW;
    if (oy >= p.ho || ox >= p.wo) continue;
    __nv_bfloat16* o = out + ((int64_t)img * npix + oy * p.wo + ox) * p.cout + c0 + wn + 2 * t;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

template <int CG>
int launch_grouped_tc(const void* x, const void* offsets, const void* weight, void* out,
                      const DcnParams& p, cudaStream_t stream) {
  const size_t smem = gt_smem_bytes(CG);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(deform_conv_fwd_grouped_tc_kernel<CG>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess)
    return (int)cudaGetLastError();
  dim3 grid(((p.ho + kGtTileH - 1) / kGtTileH) * ((p.wo + kGtTileW - 1) / kGtTileW),
            p.cout / kGtSlab, p.n);
  deform_conv_fwd_grouped_tc_kernel<CG><<<grid, kGtThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(offsets),
      static_cast<const __nv_bfloat16*>(weight), static_cast<__nv_bfloat16*>(out), p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, h, w, cin), offsets (n, ho, wo, deform_groups * 18), weight (cout,
// 3, 3, cin/groups), out (n, ho, wo, cout), all contiguous, one dtype:
// 0 = float32, 1 = bfloat16. bfloat16 with groups == 1 takes the
// tensor-core path (needs cin/deform_groups a multiple of 64 and cout a
// multiple of 8); bfloat16 with groups > 1, cin/groups == cout/groups in
// {8, 16, 32}, cin/deform_groups a multiple of 64 and an image's bytes
// (h * w * cin * 2) within 31 bits the grouped tensor-core path;
// everything else the CUDA-core path (needs cin/groups and
// cin/deform_groups multiples of the 16-byte vector, 4 float32 or 8
// bfloat16, and cout/groups a multiple of 4).
// Returns cudaGetLastError() after the launch (0 on success); -1 on bad
// arguments.
extern "C" int htd_deform_conv_fwd(const void* x, const void* offsets, const void* weight,
                                   void* out, int n, int h, int w, int cin, int ho, int wo,
                                   int cout, int groups, int deform_groups, int stride, int pad,
                                   int dil, int dtype, cudaStream_t stream) {
  DcnParams p;
  if (!fill_params(p, n, h, w, cin, ho, wo, cout, groups, deform_groups, stride, pad, dil,
                   dtype))
    return -1;
  if (dtype == 1 && groups == 1) {
    if (p.cdg % kTcK || cout % 8) return -1;
    // 128 output channels a block halve the sampling each output tile
    // repeats, where the grid still gives every SM two blocks; else 64
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaGetLastError();
    const int64_t tiles = (int64_t)n * ((ho * wo + kTcM - 1) / kTcM);
    return cout % 128 == 0 && tiles * (cout / 128) >= 2 * (int64_t)sms
               ? launch_tc<128>(x, offsets, weight, out, p, stream)
               : launch_tc<64>(x, offsets, weight, out, p, stream);
  }
  if (dtype == 1 && p.cg == p.og && p.cdg % kGtSlab == 0 &&
      (int64_t)h * w * cin * sizeof(__nv_bfloat16) <= INT32_MAX) {
    if (p.cg == 8) return launch_grouped_tc<8>(x, offsets, weight, out, p, stream);
    if (p.cg == 16) return launch_grouped_tc<16>(x, offsets, weight, out, p, stream);
    if (p.cg == 32) return launch_grouped_tc<32>(x, offsets, weight, out, p, stream);
  }
  const int vec = dtype == 0 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  if (p.cg % vec || p.cdg % vec || p.og % 4) return -1;
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
