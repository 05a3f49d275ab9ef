// K8: the layout fence, a fresh dense copy of a tensor.
//
// Replaces the TPU kernel `layout_fence` (htd_tpu/ops/fence.py), an identity
// Pallas copy whose custom-call boundary pinned a row-major layout that XLA
// could not renegotiate. PyTorch has no layout negotiation; the function that
// remains is the copy: the caller allocates the output with the input's own
// strides (its memory format), so the copy is the input's memory span, byte
// for byte.
//
// Bound on the H100: bytes, 2 x the tensor's size (read once, written once).
// Design: dtype-blind, for bytes in flight. Each thread issues kUnroll
// independent 16-byte streaming loads (`__ldcs`: nothing is reused, so the
// lines are evicted first) before any of its stores (`__stcs`), and a
// block's threads take neighbouring vectors in each of those steps, so that
// every load instruction of a warp reads 512 contiguous bytes. The grid is
// sized to the span (one pass, no grid-stride loop); vectors past the span
// in the last block are masked, and the span's last bytes beyond a whole
// vector are copied one by one by the first block. On the H100 it runs at
// or below `clone()` (chip_smoke.py phase 21); 2, 4 or 16 vectors a
// thread, non-coherent or L1-bypassing loads and a TMA bulk copy through
// shared memory did no better.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;   // 16-byte vectors per thread, all loaded before any is stored
constexpr int64_t kPerBlock = (int64_t)kThreads * kUnroll;

__global__ void __launch_bounds__(kThreads)
layout_fence_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, const int64_t nvec,
                    const uint8_t* __restrict__ src_tail, uint8_t* __restrict__ dst_tail,
                    const int tail) {
  const int64_t base = (int64_t)blockIdx.x * kPerBlock + threadIdx.x;
  uint4 v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t i = base + k * kThreads;
    if (i < nvec) v[k] = __ldcs(src + i);
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t i = base + k * kThreads;
    if (i < nvec) __stcs(dst + i, v[k]);
  }
  if (blockIdx.x == 0 && threadIdx.x < tail) dst_tail[threadIdx.x] = src_tail[threadIdx.x];
}

}  // namespace

// Copies nbytes from src to dst, both 16-byte aligned. Returns
// cudaGetLastError() after the launch (0 on success); -1 on bad arguments.
extern "C" int htd_layout_fence(const void* src, void* dst, long long nbytes,
                                cudaStream_t stream) {
  if (nbytes < 1) return -1;
  const int64_t nvec = nbytes / 16;
  const int tail = (int)(nbytes - nvec * 16);
  int64_t blocks = (nvec + kPerBlock - 1) / kPerBlock;
  blocks = blocks < 1 ? 1 : blocks;
  const uint8_t* s = static_cast<const uint8_t*>(src);
  uint8_t* d = static_cast<uint8_t*>(dst);
  layout_fence_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), nvec, s + nvec * 16, d + nvec * 16,
      tail);
  return (int)cudaGetLastError();
}
