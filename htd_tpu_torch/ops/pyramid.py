"""The packed FPN pyramid that both RoIAlign passes read (kernel K1).

All levels of all images are row-concatenated into one zero-padded
`(rows_pad, w_pad, C)` buffer, image-major and level-minor: level l of
image b starts at row `b * img_rows + row_offsets[l]`, and every row is
`w_pad` pixels wide. The geometry is exactly the JAX package's v4 pyramid
(`htd_tpu/ops/roi_align_pallas.py`: `_build_pyramid_xla` with
`_v4_pyramid`'s padding), so the buffers compare bit for bit.

`pack_pyramid` is the wrapper: on CUDA tensors it launches the CUDA
kernel (`csrc/pyramid_pack.cu`), on CPU tensors it runs the plain version
`pack_pyramid_plain`. Its backward slices each level's window out of the
pyramid gradient (`pyramid_level_grads`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

# the JAX package's v4 pyramid padding constants (V4_X_BLOCK, V4_Y_STRIPE,
# V4_RES_H in htd_tpu/ops/roi_align_pallas.py)
_X_BLOCK = 96
_Y_STRIPE = 16
_RES_H = 80


class PyramidGeometry(NamedTuple):
    batch: int
    channels: int
    heights: Tuple[int, ...]
    widths: Tuple[int, ...]
    row_offsets: Tuple[int, ...]   # per level, within one image's rows
    img_rows: int
    w_pad: int
    rows_pad: int


class Pyramid(NamedTuple):
    buf: torch.Tensor              # (rows_pad, w_pad, C)
    geom: PyramidGeometry


def pyramid_geometry(shapes: Sequence[Sequence[int]]) -> PyramidGeometry:
    """Geometry for levels of shapes (B, H_l, W_l, C)."""
    b, c = int(shapes[0][0]), int(shapes[0][3])
    heights = tuple(int(s[1]) for s in shapes)
    widths = tuple(int(s[2]) for s in shapes)
    offsets = [0]
    for h in heights:
        offsets.append(offsets[-1] + h)
    img_rows = offsets[-1]
    max_w = max(widths)
    w_pad = ((max_w - 1) // _X_BLOCK + 2) * _X_BLOCK
    rows_pad = (b * img_rows + _RES_H + _Y_STRIPE - 1) // _Y_STRIPE * _Y_STRIPE
    return PyramidGeometry(b, c, heights, widths, tuple(offsets[:-1]),
                           img_rows, w_pad, rows_pad)


def _check_levels(levels: Sequence[torch.Tensor]) -> None:
    if not levels:
        raise ValueError("pack_pyramid needs at least one level")
    f0 = levels[0]
    for f in levels:
        if f.dim() != 4:
            raise ValueError(f"levels must be (B, H, W, C), got {tuple(f.shape)}")
        if (f.shape[0], f.shape[3]) != (f0.shape[0], f0.shape[3]):
            raise ValueError("levels disagree on batch or channels")
        if f.dtype != f0.dtype or f.device != f0.device:
            raise ValueError("levels disagree on dtype or device")


def pack_pyramid(levels: Sequence[torch.Tensor]) -> Pyramid:
    """Pack per-level (B, H, W, C) maps into one pyramid buffer.
    Differentiable: each level's gradient is its window of the pyramid's."""
    _check_levels(levels)
    geom = pyramid_geometry([f.shape for f in levels])
    dev = levels[0].device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"pack_pyramid runs on cuda or cpu tensors, not {dev}")
    return Pyramid(_PackPyramid.apply(geom, *levels), geom)


class _PackPyramid(torch.autograd.Function):
    """K1 (CUDA) or its plain version (CPU) forward; the backward slices
    each level back out of the pyramid gradient, the JAX package's
    `_pyr_build_bwd` (an XLA slice there too, not a kernel)."""

    @staticmethod
    def forward(ctx, geom: PyramidGeometry, *levels: torch.Tensor) -> torch.Tensor:
        ctx.geom = geom
        if levels[0].device.type == "cpu":
            return pack_pyramid_plain(levels, geom)
        from htd_tpu_torch.ops.roi_align_cuda import launch_pyramid_pack

        return launch_pyramid_pack(levels, geom)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return (None,) + pyramid_level_grads(grad, ctx.geom)


def pyramid_level_grads(grad: torch.Tensor, geom: PyramidGeometry) -> Tuple[torch.Tensor, ...]:
    """The gradient of each (B, H, W, C) level, contiguous, from the
    pyramid's (rows_pad, w_pad, C) gradient."""
    g = grad[: geom.batch * geom.img_rows].reshape(geom.batch, geom.img_rows, geom.w_pad,
                                                   geom.channels)
    return tuple(g[:, off:off + h, :w].contiguous()
                 for off, h, w in zip(geom.row_offsets, geom.heights, geom.widths))


def pack_pyramid_plain(levels: Sequence[torch.Tensor],
                       geom: PyramidGeometry) -> torch.Tensor:
    """Plain PyTorch version of K1: pad each level's width, concatenate the
    levels per image, then pad the rows (the JAX `_build_pyramid_xla`)."""
    parts = [F.pad(f, (0, 0, 0, geom.w_pad - f.shape[2])) for f in levels]
    pyr = torch.cat(parts, dim=1).reshape(geom.batch * geom.img_rows,
                                          geom.w_pad, geom.channels)
    return F.pad(pyr, (0, 0, 0, 0, 0, geom.rows_pad - pyr.shape[0]))
