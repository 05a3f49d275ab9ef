"""Image preprocessing on torch tensors.

A copy of the JAX package's framework-free helpers (`rescale_size`,
`bucket_shape`; `htd_tpu/data/pipeline.py`), a torch `preprocess`:
keep-ratio resize, optional horizontal flip (with the gt boxes), BGR ->
RGB, normalize, zero-pad into a static bucket, and `pad_gt`.
The resize is cv2's `INTER_LINEAR` for uint8 (the JAX package's
`_resize_bilinear`, as mmcv rescales), reproduced bit for bit: cv2's
11-bit fixed-point coefficients and its integer horizontal and vertical
passes, in integer torch ops on the caller's device, so no cv2 or PIL is
needed.

Every host-to-device copy of `preprocess` runs in its own
`htd.sync.upload` span: a copy from pageable host memory blocks the host
until the device's queue has drained.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from htd_tpu_torch.ops.boxes import bbox_flip

MEAN_RGB = (123.675, 116.28, 103.53)
STD_RGB = (58.395, 57.12, 57.375)


def rescale_size(h: int, w: int, scale: Tuple[int, int]) -> Tuple[int, int, float]:
    """mmcv.rescale_size: fit inside (long, short) keeping the ratio.
    Returns (new_h, new_w, factor)."""
    long_side, short_side = max(scale), min(scale)
    factor = min(long_side / max(h, w), short_side / min(h, w))
    return int(h * factor + 0.5), int(w * factor + 0.5), factor


def ceil32(x: int) -> int:
    return int(np.ceil(x / 32.0) * 32)


def bucket_shape(scale: Tuple[int, int], landscape: bool) -> Tuple[int, int]:
    """Static pad bucket (H, W) for an orientation at a test scale."""
    long_side, short_side = max(scale), min(scale)
    if landscape:
        return ceil32(short_side), ceil32(long_side)
    return ceil32(long_side), ceil32(short_side)


_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE (11 fractional bits)


def _upload(x, device, dtype=None) -> torch.Tensor:
    """`x` (an array, a list or a host tensor) copied to `device`."""
    with record_function("htd.sync.upload"):
        return torch.as_tensor(x, dtype=dtype).to(device)


def _linear_taps(src: int, dst: int, clamp_frac: bool):
    """cv2's per-axis INTER_LINEAR table: the first source index of each
    output index and the two 11-bit coefficients. Positions are
    float32((i + 0.5) * scale - 0.5) with scale = 1 / (dst / src) in
    float64; the fraction and the coefficients are float32, rounded half to
    even. The horizontal axis (`clamp_frac`) pins a tap that falls off
    either edge to the edge pixel with coefficients (2048, 0); the vertical
    axis keeps the fraction and only clips the row indices."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp_frac:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0.0
        s[low] = 0
        s[high] = src - 1
    a0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int32)
    a1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), a0, a1


def resize_bilinear(img: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """(H, W, 3) uint8 -> (new_h, new_w, 3) float32 holding uint8 values:
    cv2.resize(INTER_LINEAR) bit for bit. The horizontal pass sums
    a0 * src[s] + a1 * src[s + 1] in int32; the vertical pass rounds
    (((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2, as cv2's
    fixed-point cast does, and clamps to [0, 255]."""
    h, w = int(img.shape[0]), int(img.shape[1])
    dev = img.device

    def table(src, dst, clamp):
        return [_upload(a, dev) for a in _linear_taps(src, dst, clamp)]

    x0, x1, a0, a1 = table(w, new_w, True)
    y0, y1, b0, b1 = table(h, new_h, False)
    src = img.to(torch.int32)
    rows = src[:, x0] * a0[:, None] + src[:, x1] * a1[:, None]     # (H, new_w, 3)
    top = (b0[:, None, None] * (rows[y0] >> 4)) >> 16
    bottom = (b1[:, None, None] * (rows[y1] >> 4)) >> 16
    return ((top + bottom + 2) >> 2).clamp(0, 255).to(torch.float32)


class ProcessedImage(NamedTuple):
    image: torch.Tensor         # (H, W, 3) float32, normalized, zero-padded
    img_shape: torch.Tensor     # (2,) resized (h, w), float32
    scale_factor: torch.Tensor  # (4,) (w, h, w, h) resize factors, float32
    boxes: Optional[torch.Tensor] = None   # (N, 4) gt boxes, resized and flipped
    labels: Optional[torch.Tensor] = None  # (N,) their labels
    flipped: bool = False


def preprocess(img_bgr, scale: Tuple[int, int] = (1333, 800),
               bucket: Optional[Tuple[int, int]] = None, device="cpu", flip: bool = False,
               boxes=None, labels=None) -> ProcessedImage:
    """Resize (keep ratio) -> flip -> BGR to RGB -> normalize -> pad to
    `bucket`, the JAX package's order (mmdet Resize, RandomFlip, Normalize,
    Pad).

    `img_bgr` is an (H, W, 3) uint8 numpy array or tensor; the work runs
    on `device`. `boxes` (N, 4) are scaled, clipped to the resized shape
    and, with `flip`, mirrored in the resized width (not the bucket's).
    """
    if isinstance(img_bgr, np.ndarray):
        img_bgr = np.ascontiguousarray(img_bgr)  # e.g. a channel-flipped view
    img = _upload(img_bgr, device)
    if img.dim() != 3 or img.shape[2] != 3 or img.dtype != torch.uint8:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {tuple(img.shape)} {img.dtype}")
    h, w = int(img.shape[0]), int(img.shape[1])
    new_h, new_w, _ = rescale_size(h, w, scale)
    x = resize_bilinear(img, new_h, new_w)
    ws, hs = new_w / w, new_h / h
    scale_factor = _upload([ws, hs, ws, hs], x.device, torch.float32)
    if boxes is not None:
        boxes = _upload(boxes, x.device, torch.float32).reshape(-1, 4)
        boxes = boxes * scale_factor
        boxes = torch.stack([boxes[:, 0].clamp(0, new_w), boxes[:, 1].clamp(0, new_h),
                             boxes[:, 2].clamp(0, new_w), boxes[:, 3].clamp(0, new_h)], -1)
    if flip:
        x = x.flip(1)
        if boxes is not None:
            boxes = bbox_flip(boxes, (new_h, new_w))
    if labels is not None:
        labels = _upload(labels, x.device)
    x = x.flip(-1)                                        # BGR -> RGB
    mean = _upload(MEAN_RGB, x.device, torch.float32)
    std = _upload(STD_RGB, x.device, torch.float32)
    x = (x - mean) / std
    if bucket is None:
        bucket = (ceil32(new_h), ceil32(new_w))
    padded = torch.zeros((bucket[0], bucket[1], 3), dtype=torch.float32, device=x.device)
    padded[:new_h, :new_w] = x
    return ProcessedImage(
        padded,
        _upload([new_h, new_w], x.device, torch.float32),
        scale_factor, boxes, labels, flip,
    )


def pad_gt(boxes, labels, max_gt: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-image gts padded to `max_gt` rows: boxes (max_gt, 4) float32,
    labels (max_gt,) int32 and the validity mask, on the boxes' device."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32).reshape(-1, 4)
    labels = torch.as_tensor(labels, device=boxes.device)
    n = min(len(boxes), max_gt)
    out_b = torch.zeros((max_gt, 4), dtype=torch.float32, device=boxes.device)
    out_l = torch.zeros((max_gt,), dtype=torch.int32, device=boxes.device)
    out_v = torch.zeros((max_gt,), dtype=torch.bool, device=boxes.device)
    out_b[:n] = boxes[:n]
    out_l[:n] = labels[:n].to(torch.int32)
    out_v[:n] = True
    return out_b, out_l, out_v
