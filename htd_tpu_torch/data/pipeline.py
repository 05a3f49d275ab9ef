"""Test-time image preprocessing on torch tensors.

A copy of the JAX package's framework-free helpers (`rescale_size`,
`bucket_shape`; `htd_tpu/data/pipeline.py`) and a torch `preprocess`:
keep-ratio resize, BGR -> RGB, normalize, zero-pad into a static bucket.
The resize is `F.interpolate(bilinear, align_corners=False)` rounded to
uint8; cv2's INTER_LINEAR rounds with fixed-point weights, so a pixel may
differ from cv2's by one grey level. It runs on the caller's device, so
no cv2 or PIL is needed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


class ProcessedImage(NamedTuple):
    image: torch.Tensor         # (H, W, 3) float32, normalized, zero-padded
    img_shape: torch.Tensor     # (2,) resized (h, w), float32
    scale_factor: torch.Tensor  # (4,) (w, h, w, h) resize factors, float32


def preprocess(img_bgr, scale: Tuple[int, int] = (1333, 800),
               bucket: Optional[Tuple[int, int]] = None, device="cpu") -> ProcessedImage:
    """Resize (keep ratio) -> BGR to RGB -> normalize -> pad to `bucket`.

    `img_bgr` is an (H, W, 3) uint8 numpy array or tensor; the work runs
    on `device`.
    """
    if isinstance(img_bgr, np.ndarray):
        img_bgr = np.ascontiguousarray(img_bgr)  # e.g. a channel-flipped view
    img = torch.as_tensor(img_bgr).to(device)
    if img.dim() != 3 or img.shape[2] != 3 or img.dtype != torch.uint8:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {tuple(img.shape)} {img.dtype}")
    h, w = int(img.shape[0]), int(img.shape[1])
    new_h, new_w, _ = rescale_size(h, w, scale)
    x = img.permute(2, 0, 1)[None].to(torch.float32)
    x = F.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=False,
                      antialias=False)
    x = x.round().clamp(0, 255)[0].permute(1, 2, 0)       # (new_h, new_w, 3), uint8 values
    x = x.flip(-1)                                        # BGR -> RGB
    mean = torch.tensor(MEAN_RGB, dtype=torch.float32, device=x.device)
    std = torch.tensor(STD_RGB, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    if bucket is None:
        bucket = (ceil32(new_h), ceil32(new_w))
    padded = torch.zeros((bucket[0], bucket[1], 3), dtype=torch.float32, device=x.device)
    padded[:new_h, :new_w] = x
    ws, hs = new_w / w, new_h / h
    return ProcessedImage(
        padded,
        torch.tensor([new_h, new_w], dtype=torch.float32, device=x.device),
        torch.tensor([ws, hs, ws, hs], dtype=torch.float32, device=x.device),
    )
