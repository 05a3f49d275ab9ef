// K7: the FPN top-down step, out = lat + nearest_2x(low).
//
// Replaces the TPU kernel `upsample2x_add` (htd_tpu/ops/upsample.py, body
// `_kernel`), which interleaved a block of `low` rows in VMEM along both axes
// and added the `lat` block. Here no interleave is materialised: each output
// vector reads its `low` source vector directly.
//
// Function: out[b, y, x, c] = lat[b, y, x, c] + low[b, y / 2, x / 2, c] with
// low (B, h, w, C) and lat, out (B, 2h, 2w, C), contiguous NHWC (a
// channels_last NCHW tensor viewed as NHWC is one), one dtype. The add is
// one correctly rounded add in float32; in bfloat16 both operands widen to
// float32 exactly and the sum rounds once to bfloat16 (round to nearest
// even), which is what PyTorch's and XLA's bfloat16 add do.
//
// Bound on the H100: bytes (one add per element). Each input byte is read
// once and each output byte written once: low + lat + out. Design: 16-byte
// vectors along C (4 float32 or 8 bfloat16 channels); a block row of the
// grid per output row, threads along (pixel, channel vector), so that a warp
// reads and writes 512 contiguous bytes of lat and out; the two output
// pixels of a column pair read the same `low` vector, which the second one
// finds in L1/L2, so DRAM reads `low` about once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ unsigned add_f32(unsigned a, unsigned b) {
  return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
}

// two bfloat16 lanes of a 32-bit word: element 0 in the low half
__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
  const float lo = __fadd_rn(__uint_as_float(a << 16), __uint_as_float(b << 16));
  const float hi = __fadd_rn(__uint_as_float(a & 0xffff0000u), __uint_as_float(b & 0xffff0000u));
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <bool kBf16>
__device__ __forceinline__ uint4 add_vec(const uint4 a, const uint4 b) {
  uint4 r;
  if (kBf16) {
    r.x = add_bf16x2(a.x, b.x);
    r.y = add_bf16x2(a.y, b.y);
    r.z = add_bf16x2(a.z, b.z);
    r.w = add_bf16x2(a.w, b.w);
  } else {
    r.x = add_f32(a.x, b.x);
    r.y = add_f32(a.y, b.y);
    r.z = add_f32(a.z, b.z);
    r.w = add_f32(a.w, b.w);
  }
  return r;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
upsample_add_kernel(const uint4* __restrict__ low, const uint4* __restrict__ lat,
                    uint4* __restrict__ out, const int rows, const int h2, const int w,
                    const int vecs_per_pixel) {
  const int row_vecs = 2 * w * vecs_per_pixel;  // vectors in one output row
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int b = row / h2;
    const int y = row - b * h2;
    const int64_t low_row = ((int64_t)b * (h2 >> 1) + (y >> 1)) * w * vecs_per_pixel;
    const int64_t out_row = (int64_t)row * row_vecs;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < row_vecs;
         i += gridDim.x * blockDim.x) {
      const int x = i / vecs_per_pixel;
      const int v = i - x * vecs_per_pixel;
      const uint4 a = lat[out_row + i];
      const uint4 l = low[low_row + (int64_t)(x >> 1) * vecs_per_pixel + v];
      out[out_row + i] = add_vec<kBf16>(a, l);
    }
  }
}

}  // namespace

// low (batch, h, w, C), lat and out (batch, 2h, 2w, C), contiguous, 16-byte
// aligned, one dtype: 0 = float32, 1 = bfloat16; row_bytes = C * element
// size, a multiple of 16. Returns cudaGetLastError() after the launch (0 on
// success); -1 on bad arguments.
extern "C" int htd_upsample_add(const void* low, const void* lat, void* out, int batch, int h,
                                int w, int row_bytes, int dtype, cudaStream_t stream) {
  if (batch < 1 || h < 1 || w < 1 || row_bytes < 16 || row_bytes % 16 != 0 ||
      (dtype != 0 && dtype != 1))
    return -1;
  const int vpp = row_bytes / 16;
  const int rows = batch * 2 * h;
  const int row_vecs = 2 * w * vpp;
  dim3 grid((row_vecs + kThreads - 1) / kThreads, rows < kMaxGridY ? rows : kMaxGridY);
  const uint4* lo = static_cast<const uint4*>(low);
  const uint4* la = static_cast<const uint4*>(lat);
  uint4* o = static_cast<uint4*>(out);
  if (dtype == 0) {
    upsample_add_kernel<false><<<grid, kThreads, 0, stream>>>(lo, la, o, rows, 2 * h, w, vpp);
  } else {
    upsample_add_kernel<true><<<grid, kThreads, 0, stream>>>(lo, la, o, rows, 2 * h, w, vpp);
  }
  return (int)cudaGetLastError();
}
