"""Anchor generation for the RPN, and the inside flags of its training loss.

Counterpart of `htd_tpu/ops/anchors.py` (mmdet AnchorGenerator semantics:
ratio-major base anchors per stride, location-major grids, pad-region
valid flags). Base anchors and grids are computed with numpy in float32,
exactly as the JAX package does, then moved to the caller's device.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


class AnchorGenerator:
    """Standard 2D anchor generator.

    Grids are cached per (level, feature size, device) on the instance.
    """

    def __init__(
        self,
        strides: Sequence[int] = (4, 8, 16, 32, 64),
        ratios: Sequence[float] = (0.5, 1.0, 2.0),
        scales: Sequence[float] = (8,),
        center_offset: float = 0.0,
    ):
        self.strides = tuple(int(s) for s in strides)
        self.ratios = np.asarray(ratios, dtype=np.float32)
        self.scales = np.asarray(scales, dtype=np.float32)
        self.center_offset = center_offset
        self.base_anchors = [self._base_anchors_for_stride(s) for s in self.strides]
        self._grid_cache: Dict[Tuple[int, int, int, str], torch.Tensor] = {}

    @property
    def num_base_anchors(self) -> int:
        return len(self.ratios) * len(self.scales)

    def _base_anchors_for_stride(self, stride: int) -> np.ndarray:
        w = h = float(stride)
        xc = self.center_offset * w
        yc = self.center_offset * h
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        base = np.stack(
            [xc - 0.5 * ws, yc - 0.5 * hs, xc + 0.5 * ws, yc + 0.5 * hs], axis=-1
        )
        return base.astype(np.float32)

    def grid_anchors_level(self, level: int, featmap_size: Tuple[int, int],
                           device="cpu") -> torch.Tensor:
        """`(H*W*A, 4)` anchors of one level, anchor index fastest."""
        fh, fw = int(featmap_size[0]), int(featmap_size[1])
        key = (level, fh, fw, str(device))
        if key not in self._grid_cache:
            stride = self.strides[level]
            shift_x = np.arange(fw, dtype=np.float32) * stride
            shift_y = np.arange(fh, dtype=np.float32) * stride
            sx, sy = np.meshgrid(shift_x, shift_y)
            shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
            anchors = (shifts + self.base_anchors[level][None, :, :]).reshape(-1, 4)
            self._grid_cache[key] = torch.from_numpy(anchors).to(device)
        return self._grid_cache[key]

    def valid_flags_level(self, level: int, featmap_size: Tuple[int, int],
                          valid_shape: torch.Tensor) -> torch.Tensor:
        """Per-anchor validity for un-padded shapes `valid_shape` (..., 2).

        A grid cell is valid when its index is inside ceil(valid / stride);
        all A anchors of a cell share the flag. Returns bool (..., H*W*A).
        """
        fh, fw = int(featmap_size[0]), int(featmap_size[1])
        stride = self.strides[level]
        vs = valid_shape.to(torch.float32)
        vh = torch.clamp(torch.ceil(vs[..., 0] / stride), max=fh).to(torch.int32)
        vw = torch.clamp(torch.ceil(vs[..., 1] / stride), max=fw).to(torch.int32)
        ys = torch.arange(fh, dtype=torch.int32, device=vs.device)
        xs = torch.arange(fw, dtype=torch.int32, device=vs.device)
        cell = (ys < vh[..., None])[..., :, None] & (xs < vw[..., None])[..., None, :]
        cell = cell.reshape(cell.shape[:-2] + (fh * fw,))
        return cell.repeat_interleave(self.num_base_anchors, dim=-1)


def anchor_inside_flags(flat_anchors: torch.Tensor, valid_flags: torch.Tensor, img_shape,
                        allowed_border: float = 0.0) -> torch.Tensor:
    """Anchors fully inside the (resized, un-padded) image `img_shape` = (h,
    w) plus `allowed_border`, and valid; all of `valid_flags` when the
    border is negative. The RPN loss assigns only these anchors."""
    if allowed_border < 0:
        return valid_flags
    img = torch.as_tensor(img_shape, dtype=flat_anchors.dtype, device=flat_anchors.device)
    h, w = img[..., 0], img[..., 1]
    inside = ((flat_anchors[:, 0] >= -allowed_border)
              & (flat_anchors[:, 1] >= -allowed_border)
              & (flat_anchors[:, 2] < w + allowed_border)
              & (flat_anchors[:, 3] < h + allowed_border))
    return valid_flags & inside
