"""Launchers for the CUDA kernels K1 (pyramid pack), K2 (RoIAlign) and K4
(RoIAlign's feature gradient).

Each launcher checks what its kernel takes (device, dtype, shape,
contiguity, alignment) and raises on anything else, allocates the output,
launches on PyTorch's current stream, and raises when the launch reports an
error. There is no fallback: a CUDA tensor goes through the kernel or the
call raises. The public wrappers that pick between a kernel and its plain
version by device are `ops.pyramid.pack_pyramid`,
`ops.roi_align.roi_align_pyramid` and `ops.roi_align.roi_align_levels`;
the last two launch K4 in their backward.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from htd_tpu_torch.ops._build import DTYPE_CODE, check_launch, launch_stream
from htd_tpu_torch.ops.pyramid import Pyramid, PyramidGeometry


def _i32(vals) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(vals, dtype=np.int32))


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _lead(geom: PyramidGeometry, rois: torch.Tensor, lvls: Optional[torch.Tensor],
          strides: Sequence[int], out_size: int, sampling_ratio: int, max_samples: int):
    """Checks what K2 and K4 share; the leading shape of K2's output and
    K4's cotangent: (B, R) with levels, (L, B, R) without."""
    num_levels = len(geom.heights)
    if len(strides) != num_levels or num_levels > 8:
        raise ValueError("one stride per level, at most 8 levels")
    if sampling_ratio <= 0 and max_samples < 1:
        raise ValueError("max_samples must be >= 1")
    samples = sampling_ratio if sampling_ratio > 0 else max_samples
    if not 1 <= out_size <= 8 or out_size * samples > 64:
        raise ValueError(f"K2 and K4 take out_size <= 8 and out_size * samples <= 64, got "
                         f"out_size {out_size} with {samples} samples per bin axis")
    b, r = rois.shape[0], rois.shape[1]
    return (b, r) if lvls is not None else (num_levels, b, r)


class _RoiArgs:
    """The C arguments that K2 and K4 share: `rois` (rois, levels) before
    their output or gradient pointer, `geom` (counts, per-level tables and
    pyramid geometry) after it. Holds the buffers the pointers address;
    keep it alive until the call returns."""

    def __init__(self, geom: PyramidGeometry, rois, lvls, strides):
        b, r = rois.shape[0], rois.shape[1]
        self._rois = rois.reshape(b * r, 4).to(torch.float32).contiguous()
        self._lv = None if lvls is None else lvls.reshape(b * r).to(torch.int32).contiguous()
        self._tables = (np.ascontiguousarray(np.array([1.0 / s for s in strides], np.float32)),
                        _i32(geom.heights), _i32(geom.widths), _i32(geom.row_offsets))
        self.rois = (self._rois.data_ptr(), None if self._lv is None else self._lv.data_ptr())
        self.geom = (b * r, r, *(_ptr(t) for t in self._tables), len(geom.heights),
                     geom.img_rows, geom.w_pad, geom.channels)


def launch_pyramid_pack(levels: Sequence[torch.Tensor], geom: PyramidGeometry) -> torch.Tensor:
    """K1: levels (B, H, W, C) on one CUDA device -> (rows_pad, w_pad, C)."""
    from htd_tpu_torch.ops._build import load

    f0 = levels[0]
    if f0.device.type != "cuda":
        raise ValueError("launch_pyramid_pack takes CUDA tensors")
    if f0.dtype not in DTYPE_CODE:
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
        launch_stream())
    check_launch(err, "pyramid_pack")
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
    if buf.dtype not in DTYPE_CODE:
        raise ValueError(f"RoIAlign takes float32 or bfloat16 features, not {buf.dtype}")
    if not buf.is_contiguous() or buf.data_ptr() % 16:
        raise ValueError("pyramid buffer must be contiguous and 16-byte aligned")
    if geom.channels * buf.element_size() % 16:
        raise ValueError("channels * element size must be a multiple of 16 bytes")
    lead = _lead(geom, rois, lvls, strides, out_size, sampling_ratio, max_samples)
    out = torch.empty(lead + (out_size, out_size, geom.channels), dtype=buf.dtype,
                      device=buf.device)
    if rois.shape[0] * rois.shape[1] == 0:
        return out
    lib, _ = load()
    a = _RoiArgs(geom, rois, lvls, strides)
    err = lib.htd_roi_align_fwd(buf.data_ptr(), *a.rois, out.data_ptr(), *a.geom, out_size,
                                sampling_ratio, max_samples, DTYPE_CODE[buf.dtype], launch_stream())
    check_launch(err, "roi_align")
    return out


def launch_roi_align_bwd(geom: PyramidGeometry, rois: torch.Tensor,
                         lvls: Optional[torch.Tensor], g: torch.Tensor,
                         strides: Sequence[int], out_size: int, sampling_ratio: int,
                         max_samples: int) -> torch.Tensor:
    """K4: the float32 pyramid gradient (rows_pad, w_pad, C) of K2 for the
    cotangent g, (B, R, out, out, C) with (B, R) levels or (L, B, R, out,
    out, C) with `lvls=None`, in float32 or bfloat16."""
    from htd_tpu_torch.ops._build import load

    if g.device.type != "cuda" or rois.device != g.device:
        raise ValueError("launch_roi_align_bwd takes CUDA tensors on one device")
    if g.dtype not in DTYPE_CODE:
        raise ValueError(f"RoIAlign backward takes float32 or bfloat16, not {g.dtype}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("the cotangent must be contiguous and 16-byte aligned")
    if geom.channels * g.element_size() % 16:
        raise ValueError("channels * element size must be a multiple of 16 bytes")
    lead = _lead(geom, rois, lvls, strides, out_size, sampling_ratio, max_samples)
    if tuple(g.shape) != lead + (out_size, out_size, geom.channels):
        raise ValueError(f"cotangent must be {lead + (out_size, out_size, geom.channels)}, "
                         f"got {tuple(g.shape)}")
    d = torch.zeros((geom.rows_pad, geom.w_pad, geom.channels), dtype=torch.float32,
                    device=g.device)
    if rois.shape[0] * rois.shape[1] == 0:
        return d
    lib, _ = load()
    a = _RoiArgs(geom, rois, lvls, strides)
    err = lib.htd_roi_align_bwd(g.data_ptr(), *a.rois, d.data_ptr(), *a.geom, out_size,
                                sampling_ratio, max_samples, DTYPE_CODE[g.dtype], launch_stream())
    check_launch(err, "roi_align_bwd")
    return d
