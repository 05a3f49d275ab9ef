"""Launchers for the CUDA kernels K1 (pyramid pack) and K2 (RoIAlign).

Each launcher checks what its kernel takes (device, dtype, shape,
contiguity, alignment) and raises on anything else, allocates the output,
launches on PyTorch's current stream, raises when the launch reports an
error, and adds one to its entry in `launch_counts`. There is no fallback:
a CUDA tensor goes through the kernel or the call raises. The public
wrappers that pick between a kernel and its plain version by device are
`ops.pyramid.pack_pyramid`, `ops.roi_align.roi_align_pyramid` and
`ops.roi_align.roi_align_levels`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from htd_tpu_torch.ops.pyramid import Pyramid, PyramidGeometry

# kernel name -> launches since the last reset
launch_counts: Dict[str, int] = {"pyramid_pack": 0, "roi_align": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error code {err}")


def _i32(vals) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(vals, dtype=np.int32))


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def launch_pyramid_pack(levels: Sequence[torch.Tensor], geom: PyramidGeometry) -> torch.Tensor:
    """K1: levels (B, H, W, C) on one CUDA device -> (rows_pad, w_pad, C)."""
    from htd_tpu_torch.ops._build import load

    f0 = levels[0]
    if f0.device.type != "cuda":
        raise ValueError("launch_pyramid_pack takes CUDA tensors")
    if f0.dtype not in _DTYPE_CODE:
        raise ValueError(f"pyramid pack takes float32 or bfloat16, not {f0.dtype}")
    row_bytes = geom.channels * f0.element_size()
    if row_bytes % 16:
        raise ValueError("channels * element size must be a multiple of 16 bytes")
    if len(levels) > 8 or geom.rows_pad > 65535:
        raise ValueError("at most 8 levels and 65535 pyramid rows")
    for f in levels:
        if not f.is_contiguous() or f.data_ptr() % 16:
            raise ValueError("levels must be contiguous NHWC and 16-byte aligned")
    out = torch.empty((geom.rows_pad, geom.w_pad, geom.channels), dtype=f0.dtype,
                      device=f0.device)
    ptrs = (ctypes.c_void_p * len(levels))(*[f.data_ptr() for f in levels])
    hs, ws, offs = _i32(geom.heights), _i32(geom.widths), _i32(geom.row_offsets)
    lib, _ = load()
    err = lib.htd_pyramid_pack(
        out.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p), _ptr(hs), _ptr(ws), _ptr(offs),
        len(levels), geom.batch, geom.img_rows, geom.rows_pad, geom.w_pad, row_bytes,
        _stream())
    _check(err, "pyramid_pack")
    launch_counts["pyramid_pack"] += 1
    return out


def launch_roi_align(pyr: Pyramid, rois: torch.Tensor, lvls: Optional[torch.Tensor],
                     strides: Sequence[int], out_size: int, sampling_ratio: int,
                     max_samples: int) -> torch.Tensor:
    """K2 on the pyramid. With (B, R) levels: (B, R, out, out, C); with
    `lvls=None` every roi on every level: (L, B, R, out, out, C). Levels must
    lie in [0, L), as `map_roi_levels` guarantees."""
    from htd_tpu_torch.ops._build import load

    buf, geom = pyr
    if buf.device.type != "cuda" or rois.device != buf.device:
        raise ValueError("launch_roi_align takes CUDA tensors on one device")
    if buf.dtype not in _DTYPE_CODE:
        raise ValueError(f"RoIAlign takes float32 or bfloat16 features, not {buf.dtype}")
    if not buf.is_contiguous() or buf.data_ptr() % 16:
        raise ValueError("pyramid buffer must be contiguous and 16-byte aligned")
    if geom.channels * buf.element_size() % 16:
        raise ValueError("channels * element size must be a multiple of 16 bytes")
    b, r = rois.shape[0], rois.shape[1]
    num_levels = len(geom.heights)
    if len(strides) != num_levels or num_levels > 8:
        raise ValueError("one stride per level, at most 8 levels")
    if sampling_ratio <= 0 and max_samples < 1:
        raise ValueError("max_samples must be >= 1")
    lead = (b, r) if lvls is not None else (num_levels, b, r)
    out = torch.empty(lead + (out_size, out_size, geom.channels), dtype=buf.dtype,
                      device=buf.device)
    if b * r == 0:
        return out
    rois_f = rois.reshape(b * r, 4).to(torch.float32).contiguous()
    lv = None
    if lvls is not None:
        lv = lvls.reshape(b * r).to(torch.int32).contiguous()
    scale = np.ascontiguousarray(np.array([1.0 / s for s in strides], np.float32))
    hs, ws, offs = _i32(geom.heights), _i32(geom.widths), _i32(geom.row_offsets)
    lib, _ = load()
    err = lib.htd_roi_align_fwd(
        buf.data_ptr(), rois_f.data_ptr(), lv.data_ptr() if lv is not None else None,
        out.data_ptr(), b * r, r, _ptr(scale), _ptr(hs), _ptr(ws), _ptr(offs),
        num_levels, geom.img_rows, geom.w_pad, geom.channels, out_size, sampling_ratio,
        max_samples, _DTYPE_CODE[buf.dtype], _stream())
    _check(err, "roi_align")
    launch_counts["roi_align"] += 1
    return out
