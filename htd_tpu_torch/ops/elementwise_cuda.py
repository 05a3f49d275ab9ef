"""Launchers for the CUDA kernels K7 (the FPN upsample-add,
`csrc/upsample_add.cu`) and K8 (the layout fence, `csrc/layout_fence.cu`).

Each checks what its kernel takes (device, dtype, shape, memory layout,
alignment) and raises on anything else, allocates the output, launches on
PyTorch's current stream, and raises when the launch reports an error.
There is no fallback: a CUDA tensor goes through the kernel or the call
raises. The public wrappers that pick between a kernel and its plain
version by device are `ops.upsample.upsample2x_add` and
`ops.fence.layout_fence`.
"""

from __future__ import annotations

import torch

from htd_tpu_torch.ops._build import DTYPE_CODE, check_launch, launch_stream


def _is_dense(x: torch.Tensor) -> bool:
    """Whether x's elements fill one memory span without gaps or overlap
    (in any order of its dimensions), so that a copy of the span with the
    same strides is a copy of x."""
    expect = 1
    for stride, size in sorted((s, n) for s, n in zip(x.stride(), x.shape) if n != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def launch_upsample_add(low: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """K7: low (B, h, w, C) and lat (B, 2h, 2w, C), contiguous NHWC CUDA
    tensors of one dtype (an NCHW tensor in channels_last memory, permuted,
    is one) -> lat + nearest_2x(low) as a contiguous (B, 2h, 2w, C) tensor,
    whose NCHW permute is channels_last."""
    from htd_tpu_torch.ops._build import load

    if low.device.type != "cuda" or lat.device != low.device:
        raise ValueError("launch_upsample_add takes CUDA tensors on one device")
    if lat.dtype not in DTYPE_CODE or low.dtype != lat.dtype:
        raise ValueError(f"K7 takes float32 or bfloat16 tensors of one dtype, not low "
                         f"{low.dtype}, lat {lat.dtype}")
    b, h, w, c = low.shape
    if tuple(lat.shape) != (b, 2 * h, 2 * w, c):
        raise ValueError(f"K7 takes lat of twice low's height and width, got low "
                         f"{tuple(low.shape)}, lat {tuple(lat.shape)}")
    row_bytes = c * lat.element_size()
    if row_bytes % 16:
        raise ValueError("channels * element size must be a multiple of 16 bytes")
    for name, t in (("low", low), ("lat", lat)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous NHWC (channels_last as NCHW) and "
                             f"16-byte aligned, got strides {t.stride()}")
    out = torch.empty(lat.shape, dtype=lat.dtype, device=lat.device)
    if out.numel() == 0:
        return out
    lib, _ = load()
    err = lib.htd_upsample_add(low.data_ptr(), lat.data_ptr(), out.data_ptr(), b, h, w, row_bytes,
                               DTYPE_CODE[lat.dtype], launch_stream())
    check_launch(err, "upsample_add")
    return out


def launch_layout_fence(x: torch.Tensor) -> torch.Tensor:
    """K8: a fresh copy of the dense CUDA tensor x, any rank and dtype, with
    x's own strides (its memory format)."""
    from htd_tpu_torch.ops._build import load

    if x.device.type != "cuda":
        raise ValueError("launch_layout_fence takes a CUDA tensor")
    if not _is_dense(x) or x.data_ptr() % 16:
        raise ValueError(f"K8 takes a dense, 16-byte aligned tensor, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    out = torch.empty_like(x)   # keeps a dense input's strides
    if x.numel() == 0:
        return out
    lib, _ = load()
    err = lib.htd_layout_fence(x.data_ptr(), out.data_ptr(), x.numel() * x.element_size(),
                               launch_stream())
    check_launch(err, "layout_fence")
    return out
