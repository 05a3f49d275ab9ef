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
// Design: dtype-blind; 16-byte vectors over the span with a grid-stride loop
// (neighbouring threads on neighbouring addresses), and the span's last
// bytes beyond a whole vector copied one by one by the first block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads)
layout_fence_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, const int64_t nvec,
                    const uint8_t* __restrict__ src_tail, uint8_t* __restrict__ dst_tail,
                    const int tail) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    dst[i] = src[i];
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
  int64_t blocks = (nvec + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  uint8_t* d = static_cast<uint8_t*>(dst);
  layout_fence_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), nvec, s + nvec * 16, d + nvec * 16,
      tail);
  return (int)cudaGetLastError();
}
