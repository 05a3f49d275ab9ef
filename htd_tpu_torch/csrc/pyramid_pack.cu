// K1: pack the FPN levels of all images into one zero-padded pyramid.
//
// Replaces the TPU kernel `_pyr_write_level` (htd_tpu/ops/roi_align_pallas.py,
// driven by `_build_pyramid_pallas` and `_v4_pyramid`), which copied one level
// per launch into a buffer zeroed beforehand.
//
// Output: (rows_pad, w_pad, C), image-major and level-minor. Row
// `b * img_rows + row_off[l] + y` holds row y of level l of image b in its
// first W_l pixels; every other element is zero. Inputs are contiguous NHWC
// levels (a channels_last NCHW tensor viewed as NHWC is one).
//
// Bound on the H100: bytes. Each input byte is read once and each output byte
// written once (zeros included, so no separate memset pass); there is no
// arithmetic beyond addressing. Design: the copy is dtype-blind and moves
// 16-byte vectors (8 bf16 or 4 f32 channels); one block row of the grid per
// output row, threads along (pixel, channel vector) so that a warp reads and
// writes 512 contiguous bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;

struct PackLevel {
  const uint4* src;  // (B, H, W, C) contiguous, as 16-byte vectors
  int h, w, row_off;
};

struct PackParams {
  PackLevel lv[kMaxLevels];
  int num_levels, batch, img_rows, w_pad, vecs_per_pixel;
};

__global__ void pyramid_pack_kernel(uint4* __restrict__ out, const PackParams p) {
  const int row = blockIdx.y;
  const int img = row / p.img_rows;
  const int r = row - img * p.img_rows;
  int l = -1;
  if (img < p.batch) {
    for (int k = 0; k < p.num_levels; ++k) {
      if (r >= p.lv[k].row_off && r < p.lv[k].row_off + p.lv[k].h) l = k;
    }
  }
  const int64_t nvec = (int64_t)p.w_pad * p.vecs_per_pixel;
  uint4* dst = out + (int64_t)row * nvec;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    const int x = (int)(i / p.vecs_per_pixel);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (l >= 0 && x < p.lv[l].w) {
      const PackLevel L = p.lv[l];
      const int64_t pix = ((int64_t)img * L.h + (r - L.row_off)) * L.w + x;
      v = L.src[pix * p.vecs_per_pixel + (i - (int64_t)x * p.vecs_per_pixel)];
    }
    dst[i] = v;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); -1 on bad
// arguments. Host arrays hold one entry per level.
extern "C" int htd_pyramid_pack(void* out, const void* const* level_ptrs,
                                const int* level_h, const int* level_w,
                                const int* level_row_off, int num_levels, int batch,
                                int img_rows, int rows_pad, int w_pad, int row_bytes,
                                cudaStream_t stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || row_bytes % 16 != 0) return -1;
  PackParams p;
  for (int k = 0; k < num_levels; ++k) {
    p.lv[k].src = static_cast<const uint4*>(level_ptrs[k]);
    p.lv[k].h = level_h[k];
    p.lv[k].w = level_w[k];
    p.lv[k].row_off = level_row_off[k];
  }
  p.num_levels = num_levels;
  p.batch = batch;
  p.img_rows = img_rows;
  p.w_pad = w_pad;
  p.vecs_per_pixel = row_bytes / 16;
  const int threads = 256;
  const int64_t nvec = (int64_t)w_pad * p.vecs_per_pixel;
  const int blocks_x = (int)((nvec + threads - 1) / threads);
  dim3 grid(blocks_x, rows_pad);
  pyramid_pack_kernel<<<grid, threads, 0, stream>>>(static_cast<uint4*>(out), p);
  return (int)cudaGetLastError();
}
